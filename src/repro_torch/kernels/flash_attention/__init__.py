"""Flash (blockwise online-softmax) attention: the CUDA kernel's wrapper in
:mod:`.flash_attention`, its plain version in :mod:`.ref`, the model-layout
entry point in :mod:`.ops`."""

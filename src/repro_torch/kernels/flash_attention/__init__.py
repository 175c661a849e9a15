"""Flash (blockwise online-softmax) attention: the wrapper of the CUDA
kernels (bfloat16 on tensor cores, float32 on CUDA cores) in
:mod:`.flash_attention`, its plain version in :mod:`.ref`, the model-layout
entry point in :mod:`.ops`."""

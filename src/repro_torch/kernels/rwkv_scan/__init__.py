"""The RWKV6 WKV recurrence: the CUDA kernel's wrapper in :mod:`.rwkv_scan`,
its plain version in :mod:`.ref`, the model-layout entry point in
:mod:`.ops`."""

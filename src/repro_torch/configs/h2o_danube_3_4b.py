"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000 [arXiv:2401.16818].
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    attn_kind="swa",
    window=4096,
    rope_theta=1e4,
    act="silu",
    param_dtype="bfloat16",
    source="arXiv:2401.16818",
)

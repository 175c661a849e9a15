"""rwkv6-1.6b [ssm] — Finch, data-dependent decay; attention-free.

24L d_model=2048 d_ff=7168 vocab=65536 [arXiv:2404.05892].
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                  # 32 WKV heads of size 64
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    attn_kind="none",
    ssm_kind="rwkv6",
    norm_kind="layernorm",
    act="relu2",
    mlp_gated=False,
    param_dtype="bfloat16",
    source="arXiv:2404.05892",
)

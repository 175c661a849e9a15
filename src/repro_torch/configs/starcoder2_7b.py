"""starcoder2-7b [dense] — GQA kv=4, RoPE.

32L d_model=4608 36H d_ff=18432 vocab=49152 [arXiv:2402.19173].
Plain (non-gated) GELU MLP + LayerNorm, per the model card.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    attn_kind="full",
    rope_theta=1e5,
    norm_kind="layernorm",
    act="gelu_tanh",
    mlp_gated=False,
    param_dtype="bfloat16",
    source="arXiv:2402.19173",
)

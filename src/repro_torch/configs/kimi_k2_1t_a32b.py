"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 routed top-8.

61L d_model=7168 64H (GQA kv=8) d_ff_expert=2048 vocab=163840
[arXiv:2501.kimi2 per assignment table]. First layer dense (d_ff=18432).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=18432,                 # dense FFN of the first layer
    vocab_size=163840,
    attn_kind="full",
    n_experts=384,
    n_shared_experts=1,
    top_k=8,
    d_ff_expert=2048,
    n_dense_layers=1,
    rope_theta=5e4,
    act="silu",
    param_dtype="bfloat16",
    source="arXiv:2501.kimi2",
)

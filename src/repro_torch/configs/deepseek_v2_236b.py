"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6.

60L d_model=5120 128H d_ff_expert=1536 vocab=102400 [arXiv:2405.04434].
First layer uses a dense FFN (d_ff=12288), per the model card.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,                 # dense FFN of the first layer
    vocab_size=102400,
    attn_kind="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1536,
    n_dense_layers=1,
    rope_theta=1e4,
    act="silu",
    param_dtype="bfloat16",
    source="arXiv:2405.04434",
)

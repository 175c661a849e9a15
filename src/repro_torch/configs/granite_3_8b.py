"""granite-3-8b [dense] — GQA kv=8.

40L d_model=4096 32H d_ff=12800 vocab=49155 [hf:ibm-granite/granite-3.0-2b-base].
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    attn_kind="full",
    rope_theta=1e4,
    act="silu",
    tie_embeddings=True,
    param_dtype="bfloat16",
    source="hf:ibm-granite/granite-3.0-2b-base",
)

"""gemma3-1b [dense] — 5:1 local:global interleave, 128k context.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144 [hf:google/gemma-3-1b-pt].
Local layers use a 512-token sliding window; every 6th layer is global.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    attn_kind="local_global",
    window=512,
    local_global_period=6,
    rope_theta=1e6,
    act="gelu_tanh",
    tie_embeddings=True,
    param_dtype="bfloat16",
    source="hf:google/gemma-3-1b-pt",
)

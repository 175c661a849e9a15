"""hymba-1.5b [hybrid] — parallel attention + mamba heads, ssm_state=16.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001 [arXiv:2411.13676].
Every layer runs sliding-window attention (window 1024) and a mamba head
on the same normed input, as the reference does (Hymba itself mixes SWA
with a few global layers); the mamba path is global with O(1) state.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attn_kind="swa",
    window=1024,
    hybrid=True,
    ssm_kind="mamba",
    ssm_state=16,
    rope_theta=1e4,
    act="silu",
    param_dtype="bfloat16",
    source="arXiv:2411.13676",
)

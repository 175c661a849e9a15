"""internvl2-2b [vlm] — InternViT + InternLM2 backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553 [arXiv:2404.16821].
The InternViT vision encoder is a stub, as in the reference: the batch
carries 256 patch embeddings of dim 1024 (``batch["frontend"]``), which the
trainable projector (``frontend_proj``) maps into the LM.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    attn_kind="full",
    modality="vlm",
    frontend_tokens=256,         # ViT patches per image
    frontend_dim=1024,
    rope_theta=1e6,
    act="silu",
    param_dtype="bfloat16",
    source="arXiv:2404.16821",
)

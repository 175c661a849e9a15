"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.

12L (enc) + 12L (dec) d_model=1024 16H (kv=16) d_ff=4096 vocab=256206
[arXiv:2308.11596].  The mel-spectrogram and conv feature extractor is a
stub, as in the reference: the batch carries precomputed frame embeddings
``(batch, frames, 1024)`` (``batch["frontend"]``), which the trainable
projector (``frontend_proj``) maps into the encoder.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,                 # decoder layers
    enc_layers=12,
    is_encoder_decoder=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    attn_kind="full",
    modality="audio",
    frontend_tokens=1024,        # audio frames after the (stubbed) conv stack
    frontend_dim=1024,
    rope_theta=1e4,
    norm_kind="layernorm",
    act="relu",
    mlp_gated=False,
    param_dtype="bfloat16",
    source="arXiv:2308.11596",
)

"""Architecture configuration schema, as :mod:`repro.configs.base`.

The port's own copy of :class:`ArchConfig`, field for field the
reference's (``compute_dtype`` aside, which nothing reads): dense GQA with
local/global windows, RWKV6, MLA, MoE, the hybrid attention + mamba
layers, the encoder-decoder and the modality frontends.
:attr:`ArchConfig.dtype` is a ``torch.dtype``.  :class:`InputShape` (the
four assigned global input shapes, :data:`INPUT_SHAPES`) and
:class:`RunConfig` are the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.nn.param import torch_dtype


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # attention flavour
    attn_kind: str = "full"          # full | swa | local_global | mla | none
    window: int = 0                  # swa / local layers
    local_global_period: int = 0     # every k-th layer is global (gemma3: 6)

    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0          # leading dense-FFN layers (deepseek/kimi: 1)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM / hybrid
    ssm_kind: str = "none"           # rwkv6 | mamba | none
    ssm_state: int = 0
    hybrid: bool = False             # parallel attention + mamba heads

    # encoder-decoder (seamless)
    is_encoder_decoder: bool = False
    enc_layers: int = 0

    # modality frontends (stubs: the batch carries their embeddings)
    modality: str = "text"           # text | audio | vlm
    frontend_tokens: int = 0         # patches / audio frames fed by the stub
    frontend_dim: int = 0            # embedding dim produced by the stub

    rope_theta: float = 1e4
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "silu"
    mlp_gated: bool = True
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    attn_chunk: int = 512            # blockwise / banded attention chunk
    source: str = ""                 # citation from the assignment table

    # ---- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic per-token decode (long_500k eligibility)."""
        return (self.ssm_kind != "none" or self.attn_kind in ("swa", "local_global")
                or self.hybrid)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_is_global(self, i: int) -> bool:
        """local_global interleave: every `period`-th layer attends globally."""
        if self.attn_kind != "local_global":
            return True
        p = self.local_global_period
        return (i % p) == (p - 1)

    def param_count(self) -> int:
        """Parameter count of the template (:func:`model_template`)."""
        from repro_torch.nn.param import count_params
        from repro_torch.nn.transformer import model_template
        return count_params(model_template(self))

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        per_expert = self.d_ff_expert * self.d_model * (3 if self.mlp_gated else 2)
        n_moe_layers = self.n_layers - self.n_dense_layers
        return self.param_count() - n_moe_layers * per_expert * (
            self.n_experts - self.top_k)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model <= 512, <= 4 experts (the
        reference's)."""
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, n_heads)
        while n_heads % n_kv:
            n_kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2,
            enc_layers=2 if self.is_encoder_decoder else 0,
            d_model=min(self.d_model, 256),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=64 if self.attn_kind != "mla" else None,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.is_moe else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.is_moe else 0,
            d_ff_expert=min(self.d_ff_expert, 128) if self.is_moe else 0,
            n_dense_layers=min(self.n_dense_layers, 1),
            kv_lora_rank=min(self.kv_lora_rank, 32),
            q_lora_rank=min(self.q_lora_rank, 32),
            qk_nope_head_dim=min(self.qk_nope_head_dim, 32),
            qk_rope_head_dim=min(self.qk_rope_head_dim, 16),
            v_head_dim=min(self.v_head_dim, 32),
            window=min(self.window, 8) if self.window else 0,
            local_global_period=min(self.local_global_period, 2)
            if self.local_global_period else 0,
            frontend_tokens=min(self.frontend_tokens, 8),
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            attn_chunk=16,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned global input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """CDSGD run settings (shared across architectures)."""

    n_agents: int = 5                    # paper default
    topology: str = "fully_connected"    # paper default
    lazy_beta: Optional[float] = None
    optimizer: str = "cdsgd"
    step_size: float = 0.01              # paper default
    momentum: float = 0.9
    schedule: str = "fixed"              # fixed | diminishing
    diminishing_eps: float = 1.0
    diminishing_t: float = 1.0
    fedavg_local_steps: int = 1          # E (paper comparison uses E=1)
    batch_size: int = 128                # per paper (mini-batch 128)
    seed: int = 0
    non_iid: bool = False                # label-skew partition

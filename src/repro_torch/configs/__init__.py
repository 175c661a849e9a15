"""Config registry: ``get_config("<arch-id>")`` / ``--arch <id>`` on CLIs.

Every architecture of the JAX package's zoo: the dense GQA transformers
gemma3-1b (local/global sliding windows), h2o-danube-3-4b (a 4096-token
sliding window, head dim 120), granite-3-8b (global attention, tied
embeddings) and starcoder2-7b (LayerNorm, a plain GELU MLP), rwkv6-1.6b
(RWKV6), internvl2-2b (dense GQA behind a projected vision-patch frontend),
the MoE configs kimi-k2-1t-a32b (GQA) and deepseek-v2-236b (MLA),
hymba-1.5b (sliding-window attention beside mamba heads) and
seamless-m4t-medium (an encoder-decoder over a projected audio-frame
frontend).  A ``-reduced`` suffix gives the smoke-test variant.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape, RunConfig
from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek_v2
from repro_torch.configs.gemma3_1b import CONFIG as _gemma3
from repro_torch.configs.granite_3_8b import CONFIG as _granite3
from repro_torch.configs.h2o_danube_3_4b import CONFIG as _danube3
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.internvl2_2b import CONFIG as _internvl2
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi_k2
from repro_torch.configs.rwkv6_1_6b import CONFIG as _rwkv6
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless
from repro_torch.configs.starcoder2_7b import CONFIG as _starcoder2

ARCH_CONFIGS: Dict[str, ArchConfig] = {
    c.name: c for c in [_deepseek_v2, _kimi_k2, _rwkv6, _gemma3, _danube3,
                        _granite3, _starcoder2, _internvl2, _hymba, _seamless]}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in ARCH_CONFIGS:
        raise KeyError(f"unknown arch {name!r}; expected one of "
                       f"{sorted(ARCH_CONFIGS)}")
    return ARCH_CONFIGS[name]


def list_archs() -> List[str]:
    return sorted(ARCH_CONFIGS)


__all__ = ["ArchConfig", "ARCH_CONFIGS", "INPUT_SHAPES", "InputShape",
           "RunConfig", "get_config", "list_archs"]

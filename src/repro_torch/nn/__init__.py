"""Parameter templates and the paper's MLP/CNN classifiers."""

from repro_torch.nn.param import (
    ParamDef,
    count_params,
    init_params,
    params_from_numpy,
    params_to_numpy,
)

__all__ = ["ParamDef", "count_params", "init_params", "params_from_numpy",
           "params_to_numpy"]

"""Parameter templates, the paper's MLP/CNN classifiers and the model zoo's
layers (:mod:`.layers`, :mod:`.attention`, :mod:`.ssm`, :mod:`.transformer`)."""

from repro_torch.nn.param import (
    ParamDef,
    count_params,
    init_params,
    params_from_numpy,
    params_to_numpy,
    stack_layers,
    torch_dtype,
)

__all__ = ["ParamDef", "count_params", "init_params", "params_from_numpy",
           "params_to_numpy", "stack_layers", "torch_dtype"]

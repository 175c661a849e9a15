"""Parameter templates, the paper's MLP/CNN classifiers and the model zoo
(:mod:`.layers`, :mod:`.attention`, :mod:`.moe`, :mod:`.ssm`,
:mod:`.transformer`), with the reference's exports."""

from repro_torch.nn.param import (
    ParamDef,
    count_params,
    init_params,
    params_from_numpy,
    params_to_numpy,
    stack_layers,
    torch_dtype,
)
from repro_torch.nn.transformer import (
    decode_step,
    encode_for_decode,
    forward,
    init_cache,
    loss_fn,
    model_template,
)

__all__ = ["ParamDef", "count_params", "init_params", "params_from_numpy",
           "params_to_numpy", "stack_layers", "torch_dtype", "model_template",
           "forward", "loss_fn", "init_cache", "decode_step", "encode_for_decode"]

"""Carried weights for the model-zoo parity tests of the MoE, MLA, VLM,
hybrid and encoder-decoder configs (``test_torch_moe.py``,
``test_torch_mla.py``, ``test_torch_vlm.py``, ``test_torch_remat.py``,
``test_torch_hymba.py``, ``test_torch_seamless.py``).

Every leaf of the reference's template is drawn with numpy from a seed,
the zero-initialised ones too; matrices at variance 1 / (contraction size):
a ``(d, heads, k)`` projection contracts over ``d``, an output projection
``(heads, v, d)`` over ``heads x v``, an MLA up-projection ``(rank, heads,
k)`` over the rank (a cross-attention's projections as a self-attention's),
every other matrix (experts, router, MLP, mamba, frontend projector) over
its second-to-last axis.  The template's own ``scaled``
init reads the head axis as the fan-in, which makes attention an argmax
that summation order flips.  The weights go to JAX as arrays of the
template's dtype and to the port with ``params_from_numpy`` (bfloat16 bit
for bit).

``one_torch_thread``, imported into a test module, runs that module's tests
on one torch thread: under the suite's ``-n 6`` six workers share the
host's cores, and torch's default of a thread per core stalls at every
parallel region.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.nn import param as jparam
from repro.nn import transformer as jt
from repro_torch.configs import get_config
from repro_torch.nn.param import params_from_numpy

# attention leaves shaped (in, heads, k): the fan-in is their third-to-last axis
_HEADED = ("wq", "wk", "wv", "wuk", "wuv", "wuq")


def _key(p) -> str:
    return str(getattr(p, "key", p))


def leaf_value(rng, path, pd):
    name = _key(path[-1])
    if pd.init == "ones":
        return 1.0 + 0.1 * rng.normal(size=pd.shape)
    if pd.init == "zeros":
        return 0.3 * rng.normal(size=pd.shape)
    if pd.init == "normal":
        return 0.02 * rng.normal(size=pd.shape)
    if pd.init == "embed":
        return 0.05 * rng.normal(size=pd.shape)
    fan_in = pd.shape[-2]
    if len(path) > 1 and _key(path[-2]) in ("attn", "xattn"):
        if name in _HEADED:
            fan_in = pd.shape[-3]
        elif name == "wo":
            fan_in = pd.shape[-3] * pd.shape[-2]
    return pd.scale / math.sqrt(fan_in) * rng.normal(size=pd.shape)


def draw(template, seed: int):
    """Numpy weights for every leaf of a reference template (float32, or
    the leaf's bfloat16), in the template's tree."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        template, is_leaf=lambda x: isinstance(x, jparam.ParamDef))
    rng = np.random.default_rng(seed)
    leaves = [jnp.asarray(leaf_value(rng, path, pd).astype(np.float32), pd.dtype)
              for path, pd in flat]
    return jax.tree.unflatten(treedef, leaves)


@functools.lru_cache(maxsize=None)
def carried(name: str, param_dtype: str = "float32", seed: int = 0, **changes):
    """``(jax cfg, port cfg, jax params, port params)`` of ``name``'s
    reduced config with ``param_dtype`` and ``changes``."""
    changes = dict(changes, param_dtype=param_dtype)
    jc = dataclasses.replace(j_get_config(name + "-reduced"), **changes)
    tc = dataclasses.replace(get_config(name + "-reduced"), **changes)
    jp = draw(jt.model_template(jc), seed)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

"""Parameter templates: shapes + init in one tree, plus the weight carry-over.

A model is described by a **template** tree whose leaves are
:class:`ParamDef` (shape, logical axes, initializer, dtype), as in
:mod:`repro.nn.param`.  :func:`init_params` materializes it from a seeded
``torch.Generator``; its values cannot match JAX's threefry bits, so a
comparison between the packages starts from the JAX package's parameters
carried over with :func:`params_from_numpy` (a dtype/device move: the port
keeps JAX's layouts, HWIO conv kernels and ``(in, out)`` dense weights).

:func:`stack_agent_axis` and :func:`partition_specs` serve the sharded mode
(:mod:`repro_torch.launch.steps`): a :class:`PartitionSpec` names, per
dimension, the mesh axes it shards over or ``None``, resolved from the
template's logical axes (``agent``, ``tp``, ``expert``, ``fsdp``) by a
mode's rules, as the reference's.  :func:`local_shard` slices a global tree
to one rank's blocks, :func:`local_shape` gives a block's shape,
:func:`local_zeros` allocates one rank's blocks and
:func:`global_from_shards` puts the ranks' blocks back together.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """A single parameter: shape, logical axes, initializer."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis name per dim
    init: str = "normal"                 # normal|zeros|ones|embed|scaled|conv_scaled
    scale: float = 1.0                   # fan-in override for "scaled"
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def _init_leaf(pd: ParamDef, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=pd.dtype, device=dev)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=pd.dtype, device=dev)
    if pd.init == "normal":
        std = 0.02
    elif pd.init == "embed":
        std = 0.05
    elif pd.init == "scaled":           # variance scaling on fan-in (2nd-to-last dim)
        fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
        std = pd.scale / math.sqrt(max(fan_in, 1))
    elif pd.init == "conv_scaled":      # HWIO conv kernels: fan-in = H*W*I
        std = pd.scale / math.sqrt(max(math.prod(pd.shape[:-1]), 1))
    else:
        raise ValueError(f"unknown init {pd.init!r}")
    x = torch.randn(pd.shape, generator=gen, dtype=torch.float32, device=dev)
    return (std * x).to(pd.dtype)


def init_params(template: PyTree, seed: Union[int, torch.Generator] = 0,
                device=None) -> PyTree:
    """Materialize ``template``; leaves drawn in tree order from one generator.

    A seed draws on the CPU and the result is moved to ``device``, so a seed
    gives the same values on every device.  A ``torch.Generator`` draws on
    its own device (a CUDA generator on the card: another stream than the
    CPU's, and much faster for a model of billions of parameters).
    """
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    defs, treedef = tree_flatten(template)
    leaves = [_init_leaf(pd, gen).to(device) for pd in defs]
    return tree_unflatten(treedef, leaves)


def stack_layers(template: PyTree, n: int) -> PyTree:
    """Prefix every ParamDef with a leading ``layers`` axis of size ``n``."""
    return tree_map(lambda pd: ParamDef((n,) + pd.shape, ("layers",) + pd.axes,
                                        init=pd.init, scale=pd.scale,
                                        dtype=pd.dtype), template)


#: a configuration's dtype name -> the torch dtype
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (a config's ``param_dtype``)."""
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(DTYPES)}")
    return DTYPES[name]


def stack_agent_axis(template: PyTree, n_agents: int) -> PyTree:
    """Prefix every ParamDef with a leading ``agent`` axis (CDSGD replicas)."""
    return tree_map(lambda pd: ParamDef((n_agents,) + pd.shape,
                                        ("agent",) + pd.axes, init=pd.init,
                                        scale=pd.scale, dtype=pd.dtype),
                    template)


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """Per-dimension mesh axes of one sharded tensor (trailing
    replicated dimensions dropped), the reference's ``PartitionSpec``; a
    leaf of the port's trees."""

    axes: tuple = ()


#: where the rest of the sharded mode is queued (ROADMAP A16.2, in order)
TRAIN_HIER_ITEM = "ROADMAP A16.2.2 (train_hier)"
SERVE_FAMILIES_ITEM = ("ROADMAP A16.2.3 (the other families' serve mode and "
                       "tp training, MoE's expert split)")
CONTEXT_PARALLEL_ITEM = "ROADMAP A16.2.4 (context_parallel)"


def partition_specs(template: PyTree, rules) -> PyTree:
    """Resolve logical axes to mesh axes via ``rules`` (logical name ->
    mesh axis name, tuple of names, or None); missing names replicate
    (the reference's ``partition_specs``).  Returns one
    :class:`PartitionSpec` per leaf, trailing replicated dimensions
    dropped."""

    def leaf(pd: ParamDef) -> PartitionSpec:
        resolved = [rules.get(ax) if ax is not None else None for ax in pd.axes]
        while resolved and resolved[-1] is None:
            resolved.pop()
        return PartitionSpec(tuple(resolved))

    return tree_map(leaf, template)


def _entries(spec: PartitionSpec, ndim: int) -> tuple:
    if len(spec.axes) > ndim:
        raise ValueError(f"spec {spec.axes} for a {ndim}-d tensor")
    return tuple(spec.axes) + (None,) * (ndim - len(spec.axes))


def local_shape(shape, spec: PartitionSpec, mesh) -> tuple:
    """The shape of one rank's block of a ``shape`` tensor sharded by
    ``spec`` on ``mesh`` (each sharded dimension divided by its axes'
    rank count)."""
    out = []
    for n, e in zip(shape, _entries(spec, len(shape))):
        k = mesh.entry_size(e)
        if n % k:
            raise ValueError(f"dimension {n} does not divide over {e} ({k})")
        out.append(n // k)
    return tuple(out)


def local_zeros(structure: PyTree, specs: PyTree, mesh, device=None) -> PyTree:
    """Zeroed blocks of this rank of a global tree ``structure`` (tensors,
    e.g. on ``meta``: shapes and dtypes only), sharded by ``specs``, each
    allocated at its block's size."""
    return tree_map(lambda t, sp: torch.zeros(local_shape(t.shape, sp, mesh),
                                              dtype=t.dtype, device=device),
                    structure, specs)


def _block(shape, spec: PartitionSpec, mesh, rank: int) -> tuple:
    """The slices of rank ``rank``'s block."""
    out = []
    for n, e in zip(local_shape(shape, spec, mesh), _entries(spec, len(shape))):
        i = mesh.entry_index(e, rank)
        out.append(slice(i * n, (i + 1) * n))
    return tuple(out)


def local_shard(tree: PyTree, specs: PyTree, mesh, *,
                stacked: bool = False) -> PyTree:
    """This rank's block of every leaf of the global ``tree`` (tensors),
    sharded by ``specs`` (one :class:`PartitionSpec` per leaf) on ``mesh``
    (a :class:`~repro_torch.launch.mesh.AgentMesh`), each a contiguous
    copy.  ``stacked``: an agent-stacked tree under the ``train`` rules
    (the agent dimension first, over the agent axes): the block of this
    rank's ``(agent, model coordinate)`` with the agent dimension
    dropped."""
    def leaf(x, sp):
        block = x[_block(x.shape, sp, mesh, mesh.rank)]
        if stacked:
            if block.shape[0] != 1:
                raise ValueError(f"spec {sp.axes} does not split the agent "
                                 f"dimension of {tuple(x.shape)} one agent "
                                 "a rank")
            block = block[0]
        return block.contiguous()

    return tree_map(leaf, tree, specs)


def global_from_shards(shards, specs: PyTree, mesh) -> PyTree:
    """The inverse of :func:`local_shard`: the global tree from every
    rank's blocks (``shards``, in rank order, on the CPU); a block held by
    several ranks is taken from the first of them."""

    def leaf(sp, *blocks):
        local = blocks[0].shape
        shape = tuple(n * mesh.entry_size(e)
                      for n, e in zip(local, _entries(sp, len(local))))
        out = torch.empty(shape, dtype=blocks[0].dtype)
        filled = set()
        for r, b in enumerate(blocks):
            sl = _block(shape, sp, mesh, r)
            key = tuple((x.start, x.stop) for x in sl)
            if key not in filled:
                out[sl] = b
                filled.add(key)
        return out

    return tree_map(leaf, specs, *shards)


def count_params(template: PyTree) -> int:
    return sum(math.prod(pd.shape) for pd in tree_flatten(template)[0])


def params_from_numpy(tree: PyTree, device=None) -> PyTree:
    """numpy arrays (e.g. the JAX package's parameters) -> tensors on ``device``.

    bfloat16 arrays (numpy dtype name ``bfloat16``) are moved bit for bit
    through a 16-bit integer view.
    """

    def leaf(x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            t = torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(x.copy())
        return t.to(device)

    return tree_map(leaf, tree)


def params_to_numpy(tree: PyTree) -> PyTree:
    """Tensors -> numpy arrays on the host (bfloat16 widens to float32)."""

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, tree)

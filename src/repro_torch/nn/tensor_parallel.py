"""Tensor parallelism of the dense family on a process mesh: the
collectives that the reference's GSPMD inserts, written out.

The reference's serve steps run the plain model under ``jit`` with sharded
params and caches, and XLA's partitioner adds the collectives their
shardings imply.  The port runs one process per device
(:class:`~repro_torch.launch.mesh.AgentMesh` with a ``model`` axis), so a
rank's forward and decode take a :class:`TensorParallel`, made from the
model's resolved param specs (and the decode cache's) and the mesh.  It
does three jobs, each only where a spec shards:

* **gathers the ``fsdp`` shards** of a block over ``data`` just before the
  block runs (:meth:`TensorParallel.gather`: one all-gather a block, ZeRO-3
  style), and the caller drops them after, so a rank holds its shard plus
  one block;
* **reduces row-parallel partial sums** over ``model``
  (:meth:`TensorParallel.row_parallel`, :meth:`TensorParallel.psum`: one
  float32 all-reduce, cast once): the attention's ``wo`` when the heads
  are split, the MLP's ``wo`` when ``d_ff`` is, a vocabulary-sharded
  embedding's masked lookup.  A row-parallel product of bfloat16 operands
  keeps its partial sums in float32 (the products of bfloat16 values are
  exact in float32), so the result is rounded to bfloat16 once, as the
  unsharded product's is, and differs from it by the float32 summation
  order only;
* **gathers column-parallel outputs** over ``model``
  (:meth:`TensorParallel.gather_model`): the logits of a sharded
  vocabulary, the query heads and the partial softmax of a decode over a
  sequence-sharded cache.

Where a spec replicates, the rank computes the whole thing, as GSPMD
would.  The layers read the flags :attr:`~TensorParallel.heads`,
:attr:`~TensorParallel.kv`, :attr:`~TensorParallel.ff` and
:attr:`~TensorParallel.vocab`, and a decode the cache's
:attr:`~TensorParallel.seq_axes`.

Training (the ``train`` rules: ``tp`` over ``model``, no ``fsdp``; the
context built from the agent-stacked specs with the agent dimension
dropped, :meth:`TensorParallel.for_training`) runs the same layers
through ``torch.func.grad_and_value``, so every collective over ``model``
is a ``torch.autograd.Function`` (Megatron's pair, each an identity where
it moves nothing):

* :meth:`TensorParallel.copy` — identity forward, the gradients summed
  over ``model`` backward: a replicated activation entering a
  column-parallel product (the attention's and the MLP's input, the
  head's), and replicated K/V projections read by a rank's query heads
  only (gemma3-1b's one KV head on ``model`` 2), whose gradient each rank
  holds a part of;
* :meth:`TensorParallel.psum` / :meth:`TensorParallel.row_parallel` — the
  float32 all-reduce forward, identity backward;
* :meth:`TensorParallel.gather_model` — the gather forward, this rank's
  slice backward.

The cross entropy of a vocabulary sharded over ``model`` never gathers
the logits (:func:`vocab_parallel_cross_entropy`: the maximum, the sum of
exponentials and the gold logit, each ``(b, s)`` float32, reduced over
``model``).  A collective runs on plain tensors outside the function
transforms (:func:`_outside`): the backward pass hands a
``torch.autograd.Function`` the transform's wrapped tensors, and staging
them through the pinned buffers would mutate a tensor the transform
captured.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch

from repro_torch.core import collectives
from repro_torch.nn.param import PartitionSpec
from repro_torch.utils.tree import (tree_flatten, tree_flatten_with_path, tree_map,
                                    tree_unflatten)

MODEL = "model"
PyTree = Any


def _at(spec: PartitionSpec, i: int):
    return spec.axes[i] if i < len(spec.axes) else None


def _drop(specs: PyTree, lead: int) -> PyTree:
    """A stacked group's specs without their ``lead`` layer dimensions."""
    return tree_map(lambda sp: PartitionSpec(tuple(sp.axes[lead:])), specs)


def _plain(t: torch.Tensor) -> torch.Tensor:
    """``t`` without the function transforms' wrappers."""
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


@contextlib.contextmanager
def _outside():
    """No gradient recording and no function transform: a collective's
    staging copies run on plain tensors."""
    with torch._C._DisableFuncTorch(), torch.no_grad():
        yield


def _reduce(mesh, xs, *, op: str = "sum", grad: bool = False) -> list:
    """:func:`~repro_torch.core.collectives.all_reduce_sum` over ``model``
    of plain copies of ``xs``."""
    with _outside():
        return collectives.all_reduce_sum(
            mesh, [_plain(x).contiguous() for x in xs], MODEL, op=op, grad=grad)


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward, each gradient summed over
    ``model`` backward (one float32 all-reduce for every input)."""

    @staticmethod
    def forward(mesh, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[0]

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_reduce(ctx.mesh, grads, grad=True))


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: the float32 sum over ``model`` forward (cast once
    to each input's dtype), identity backward."""

    @staticmethod
    def forward(mesh, *xs):
        return tuple(_reduce(mesh, xs))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


class _GatherFromModel(torch.autograd.Function):
    """The ranks' ``x`` over ``model`` concatenated along ``dim`` forward,
    this rank's slice of the gradient backward."""

    @staticmethod
    def forward(mesh, x, dim):
        with _outside():
            return collectives.all_gather(mesh, _plain(x).contiguous(), MODEL,
                                          dim=dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        mesh, x, dim = inputs
        ctx.dim, ctx.n, ctx.i = dim, x.shape[dim], mesh.coord(MODEL)

    @staticmethod
    def backward(ctx, g):
        return None, g.narrow(ctx.dim, ctx.i * ctx.n, ctx.n), None


class TensorParallel:
    """One rank's tensor-parallel context: see the module docstring.

    ``param_specs`` is the model's :class:`PartitionSpec` tree (the
    serve rules, :func:`repro_torch.launch.sharding.safe_partition_specs`);
    ``cache_specs`` the decode cache's
    (:func:`repro_torch.launch.sharding.cache_partition_specs`), None for a
    prefill."""

    def __init__(self, mesh, param_specs: PyTree, cache_specs: PyTree = None):
        self.mesh = mesh
        self.specs = param_specs
        self.model_rank = mesh.coord(MODEL)
        self.model_size = mesh.shape.get(MODEL, 1)
        blocks = [_drop(sp, 2 if name == "lg_super" else 1)
                  for name, sp in sorted(param_specs["groups"].items())]
        if any(b != blocks[0] for b in blocks[1:]):
            raise ValueError("the layer groups' blocks are sharded differently")
        #: one block's specs (every group's block has the dense template)
        self.block_specs = blocks[0]
        attn, mlp = self.block_specs["attn"], self.block_specs["mlp"]
        self.heads = self._model(_at(attn["wq"], 1))
        self.kv = self._model(_at(attn["wk"], 1))
        self.ff = self._model(_at(mlp["wi"], 1))
        self.vocab = self._model(_at(param_specs["embed"]["table"], 0))
        self.seq_axes = None
        self.kv_cache = False
        if cache_specs is not None:
            k = next(sp for path, sp in tree_flatten_with_path(cache_specs)
                     if path[-1] == "k")
            lead = len(k.axes) - 4
            self.seq_axes = k.axes[lead + 1]
            self.kv_cache = k.axes[lead + 2] is not None

    @classmethod
    def for_training(cls, mesh, param_specs: PyTree) -> "TensorParallel":
        """The context of one rank's training step from the agent-stacked
        specs of the ``train`` rules (the agent dimension first, dropped
        here: read as serve specs, ``data`` would be taken for ``fsdp``)."""
        return cls(mesh, _drop(param_specs, 1))

    def _model(self, entry) -> bool:
        return MODEL in self.mesh.axes_of(entry)

    # ---- fsdp ----------------------------------------------------------

    def gather(self, tree: PyTree, specs: PyTree) -> PyTree:
        """``tree`` (this rank's blocks) with every dimension sharded over
        an axis other than ``model`` gathered: one all-gather per axes and
        dtype (one a block), the leaves' bytes laid end to end."""
        leaves, treedef = tree_flatten(tree)
        spec_leaves = tree_flatten(specs)[0]
        todo = {}
        for i, (x, sp) in enumerate(zip(leaves, spec_leaves)):
            for d, e in enumerate(sp.axes):
                if e is not None and not self._model(e):
                    todo.setdefault((self.mesh.axes_of(e), x.dtype), []).append((i, d))
        out = list(leaves)
        for (axes, _), items in todo.items():
            flat = torch.cat([leaves[i].reshape(-1) for i, _ in items])
            parts = collectives.all_gather(self.mesh, flat, axes)   # (n, total)
            lo = 0
            for i, d in items:
                x = leaves[i]
                hi = lo + x.numel()
                out[i] = torch.cat([p[lo:hi].reshape(x.shape) for p in parts.unbind(0)],
                                   dim=d)
                lo = hi
        return tree_unflatten(treedef, out)

    def gather_block(self, params: PyTree) -> PyTree:
        """One dense block's params with their ``fsdp`` shards gathered."""
        return self.gather(params, self.block_specs)

    def gather_top(self, params: PyTree, name: str) -> PyTree:
        """A top-level leaf group (``embed``, ``unembed``, ``final_norm``)
        with its ``fsdp`` shards gathered."""
        return self.gather(params, self.specs[name])

    # ---- model ---------------------------------------------------------

    def copy(self, *xs: torch.Tensor):
        """``xs`` as they are, their gradients summed over ``model`` in the
        backward pass (:class:`_CopyToModel`; one tensor, or a tuple)."""
        out = _CopyToModel.apply(self.mesh, *xs)
        return out[0] if len(xs) == 1 else out

    def psum(self, *ys: torch.Tensor):
        """The sum of the ranks' partial ``ys`` over ``model``: one float32
        all-reduce, each cast once to its dtype; identity backward (one
        tensor, or a tuple)."""
        out = _ReduceFromModel.apply(self.mesh, *ys)
        return out[0] if len(ys) == 1 else out

    def reduce_max(self, y: torch.Tensor) -> torch.Tensor:
        """The maximum of the ranks' ``y`` over ``model``, a constant to
        the gradient (a softmax's shift)."""
        return _reduce(self.mesh, [y.detach()], op="max")[0]

    def row_parallel(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` with the contraction split over ``model`` (this rank's
        rows of ``w``): the float32 partial product summed over the ranks,
        cast once to the operands' promoted dtype."""
        out = torch.promote_types(x.dtype, w.dtype)
        part = torch.matmul(x.float(), w.float())
        return self.psum(part).to(out)

    def gather_model(self, y: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``y`` over ``model``, concatenated along ``dim``
        (this rank's slice of the gradient backward)."""
        return _GatherFromModel.apply(self.mesh, y, dim)

    def gather_over(self, y: torch.Tensor, entry) -> torch.Tensor:
        """The ranks' ``y`` over a spec entry's axes, stacked on a new
        leading dimension in block order."""
        return collectives.all_gather(self.mesh, y.contiguous(), entry)

    def head_range(self, local_heads: int) -> tuple:
        """``(h0, h1, H)``: this rank's query heads ``[h0, h1)`` of ``H``."""
        if not self.heads:
            return 0, local_heads, local_heads
        h0 = self.model_rank * local_heads
        return h0, h0 + local_heads, local_heads * self.model_size

    def seq_offset(self, local_len: int) -> int:
        """The first position of this rank's block of a sequence-sharded
        cache."""
        return self.mesh.entry_index(self.seq_axes) * local_len


def kv_for_heads(k: torch.Tensor, v: torch.Tensor, h0: int, h1: int,
                 n_heads: int):
    """The KV heads that query heads ``[h0, h1)`` of ``n_heads`` read, from
    replicated ``k``, ``v (b, s, KV, hd)``: all of them for the whole range,
    the one KV head of the group when the range sits in one group.  The
    dense configs at ``model`` 2 and 16 need no other split, so any other
    raises."""
    n_kv = k.shape[2]
    g = n_heads // n_kv
    if h0 == 0 and h1 == n_heads:
        return k, v
    if h0 // g == (h1 - 1) // g:
        j = h0 // g
        return k[:, :, j:j + 1], v[:, :, j:j + 1]
    raise NotImplementedError(
        f"query heads [{h0}, {h1}) of {n_heads} span {n_kv}-head KV groups "
        f"of {g} while the KV heads replicate")


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 tp: TensorParallel, mask=None) -> torch.Tensor:
    """The mean next-token cross entropy of this rank's vocabulary block
    of the logits ``(b, s, vocab / model)`` (block ``tp.model_rank``),
    without gathering them: ``logsumexp`` from the maximum over ``model``
    (a constant to the gradient) and the sum of exponentials, the gold
    logit from the rank that holds it, both summed over ``model`` in one
    float32 all-reduce whose backward is the identity, so each rank's
    gradient stays its own block's.  ``mask`` as in the plain cross
    entropy."""
    lf = logits.float()
    n = lf.shape[-1]
    m = tp.reduce_max(torch.amax(lf, dim=-1))
    local = targets.long() - tp.model_rank * n
    hit = (local >= 0) & (local < n)
    gold = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = torch.where(hit, gold, torch.zeros((), dtype=lf.dtype, device=lf.device))
    sums = tp.psum(torch.stack([torch.sum(torch.exp(lf - m[..., None]), dim=-1),
                                gold]))
    nll = (m + torch.log(sums[0])) - sums[1]
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def combine_partials(parts: torch.Tensor) -> torch.Tensor:
    """Softmax partials ``(n, ..., hd + 2)`` (output, max, sum per block of
    positions, float32) combined over the blocks: ``(..., hd)``."""
    o, m, l = parts[..., :-2], parts[..., -2], parts[..., -1]
    mx = torch.amax(m, dim=0)
    w = torch.exp(m - mx)
    return torch.sum(w[..., None] * o, dim=0) / torch.sum(w * l, dim=0)[..., None]

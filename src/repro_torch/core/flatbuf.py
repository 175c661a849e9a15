"""Flat parameter buffers: pack a tree into dtype-bucketed (rows, 128) tiles.

The consensus optimizers are memory-bound elementwise updates over the
*whole* parameter vector.  This module gives them a flat view, laid out
exactly as :mod:`repro.core.flatbuf` lays it out, so packed buffers are
bitwise equal across the two packages:

* leaves are taken in JAX's tree order (dict keys sorted, see
  :mod:`repro_torch.utils.tree`) and grouped into **dtype buckets** in
  first-appearance order;
* within a bucket leaves are packed **contiguously** at static element
  ``offset``\\ s; only the bucket tail is zero-padded up to a whole number
  of 128-wide rows, so a bucket is one ``(*lead, rows, 128)`` tensor;
* ``lead`` counts leading *replica* axes excluded from flattening: the
  stacked simulation packs ``(A, ...)`` leaves with ``lead=1`` into
  ``(A, rows, 128)`` buffers.

``pack`` is a cast + reshape + one concatenate + one tail pad per bucket;
``unpack`` returns views (a slice + reshape per leaf) into the buffers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.utils.tree import tree_flatten, tree_unflatten

PyTree = Any

LANE = 128

# wire precisions of the JAX package; "f32" means *native* bucket precision
EXCHANGE_DTYPES = ("f32", "bf16", "int8", "fp8")


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Placement of one tree leaf inside its dtype bucket."""

    index: int                      # position in the flattened-tree order
    shape: Tuple[int, ...]          # per-replica shape (lead axes excluded)
    size: int                       # prod(shape)
    offset: int                     # element offset in the flattened bucket


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    dtype: torch.dtype
    rows: int                       # ceil(sum(slot.size) / LANE)
    slots: Tuple[LeafSlot, ...]

    @property
    def n_padded(self) -> int:
        return self.rows * LANE

    @property
    def n_real(self) -> int:
        return sum(s.size for s in self.slots)

    @property
    def bytes(self) -> int:
        return self.n_padded * self.dtype.itemsize

    def exchange_bytes(self, exchange: str = "f32") -> int:
        """Bytes one neighbor transfer of this bucket puts on the wire."""
        if exchange == "f32":               # native bucket precision
            return self.bytes
        if exchange == "bf16":
            return self.n_padded * min(2, self.dtype.itemsize)
        if exchange in ("int8", "fp8"):
            # 1 byte/element + one f32 scale per 128-lane row
            return self.n_padded + self.rows * 4
        raise ValueError(f"unknown exchange precision {exchange!r}; "
                         f"expected one of {EXCHANGE_DTYPES}")


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static packing metadata for one tree structure."""

    treedef: Any
    n_leaves: int
    lead: int                       # leading replica axes excluded from packing
    buckets: Tuple[BucketSpec, ...]

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def total_bytes(self) -> int:
        return sum(b.bytes for b in self.buckets)

    def exchange_bytes(self, exchange: str = "f32") -> int:
        """Bytes-on-wire for ONE neighbor transfer of the whole model."""
        return sum(b.exchange_bytes(exchange) for b in self.buckets)


def make_flat_spec(tree: PyTree, lead: int = 0) -> FlatSpec:
    """Build the bucketed layout for ``tree`` (shapes/dtypes only, no data)."""
    leaves, treedef = tree_flatten(tree)
    grouped: Dict[torch.dtype, List[Tuple[int, Tuple[int, ...], int]]] = {}
    for index, leaf in enumerate(leaves):
        shape = tuple(leaf.shape[lead:])
        grouped.setdefault(leaf.dtype, []).append(
            (index, shape, math.prod(shape)))
    buckets = []
    for dt, members in grouped.items():       # dicts keep first appearance
        slots = []
        offset = 0
        for index, shape, size in members:
            slots.append(LeafSlot(index=index, shape=shape, size=size,
                                  offset=offset))
            offset += size
        buckets.append(BucketSpec(dtype=dt, rows=-(-offset // LANE),
                                  slots=tuple(slots)))
    return FlatSpec(treedef=treedef, n_leaves=len(leaves), lead=lead,
                    buckets=tuple(buckets))


def pack(tree: PyTree, spec: FlatSpec) -> List[torch.Tensor]:
    """Pack ``tree`` into one ``(*lead, rows, 128)`` buffer per dtype bucket.

    Leaves are cast to their bucket dtype (grads/momenta packed against a
    parameter spec inherit the parameters' dtype).  A bucket holding a
    single 128-aligned contiguous leaf is a view of that leaf.
    """
    leaves, treedef = tree_flatten(tree)
    if treedef != spec.treedef:
        raise ValueError(f"tree structure {treedef} != spec structure {spec.treedef}")
    out = []
    for bucket in spec.buckets:
        pieces = []
        lead_shape = None
        for slot in bucket.slots:
            x = leaves[slot.index]
            if tuple(x.shape[spec.lead:]) != slot.shape:
                raise ValueError(
                    f"leaf {slot.index}: shape {tuple(x.shape)} != spec "
                    f"{slot.shape} (lead={spec.lead})")
            lead_shape = tuple(x.shape[:spec.lead])
            pieces.append(x.to(bucket.dtype).reshape(lead_shape + (slot.size,)))
        flat = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)
        padding = bucket.n_padded - bucket.n_real
        if padding:
            flat = F.pad(flat, (0, padding))
        out.append(flat.reshape(lead_shape + (bucket.rows, LANE)))
    return out


def unpack(bufs: Sequence[torch.Tensor], spec: FlatSpec) -> PyTree:
    """Inverse of :func:`pack`: a view (slice + reshape) per leaf."""
    if len(bufs) != spec.n_buckets:
        raise ValueError(f"{len(bufs)} buffers != {spec.n_buckets} buckets")
    leaves: List[Any] = [None] * spec.n_leaves
    for bucket, buf in zip(spec.buckets, bufs):
        lead_shape = tuple(buf.shape[:-2])
        flat = buf.reshape(lead_shape + (bucket.rows * LANE,))
        for slot in bucket.slots:
            piece = flat[..., slot.offset:slot.offset + slot.size]
            leaves[slot.index] = piece.reshape(lead_shape + slot.shape)
    return tree_unflatten(spec.treedef, leaves)

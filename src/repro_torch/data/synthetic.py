"""Synthetic classification and LM-token data + the per-agent partitioner
(numpy only).

A copy of :mod:`repro.data.synthetic`: the same ``np.random.default_rng``
draws in the same order, so the same seed gives the same arrays, token
streams and batches in both packages.  Batches come out as numpy; the
trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Dataset:
    """In-memory dataset: features + integer labels."""

    x: np.ndarray       # (n, ...) float32
    y: np.ndarray       # (n,) int32

    def __len__(self) -> int:
        return self.x.shape[0]


def make_classification(
    n: int = 4096,
    *,
    n_classes: int = 10,
    image_hw: Optional[int] = None,     # if set: (hw, hw, 3) NHWC images, else flat
    dim: int = 64,
    noise: float = 1.2,
    seed: int = 0,
    train_fraction: float = 0.85,
) -> Tuple[Dataset, Dataset]:
    """Gaussian-mixture classification; returns (train, validation)."""
    rng = np.random.default_rng(seed)
    if image_hw is not None:
        dim = image_hw * image_hw * 3
    centers = rng.normal(size=(n_classes, dim)).astype(np.float32)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = centers[y] + noise * rng.normal(size=(n, dim)).astype(np.float32)
    x = x.astype(np.float32)
    if image_hw is not None:
        x = x.reshape(n, image_hw, image_hw, 3)
    split = int(n * train_fraction)
    return Dataset(x[:split], y[:split]), Dataset(x[split:], y[split:])


def make_lm_tokens(
    n_tokens: int = 1 << 16,
    *,
    vocab: int = 512,
    seed: int = 0,
    order: int = 1,
) -> np.ndarray:
    """Markov token stream: learnable structure for LM smoke training."""
    rng = np.random.default_rng(seed)
    # sparse-ish transition table: each token prefers ~8 successors
    prefs = rng.integers(0, vocab, size=(vocab, 8))
    out = np.empty(n_tokens, dtype=np.int32)
    t = rng.integers(0, vocab)
    for i in range(n_tokens):
        out[i] = t
        if rng.random() < 0.85:
            t = int(prefs[t, rng.integers(0, 8)])
        else:
            t = int(rng.integers(0, vocab))
    return out


def lm_batches(
    tokens: np.ndarray, batch: int, seq: int, *, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of {"inputs","targets"} windows."""
    rng = np.random.default_rng(seed)
    n = tokens.shape[0] - seq - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        inp = np.stack([tokens[s : s + seq] for s in starts])
        tgt = np.stack([tokens[s + 1 : s + seq + 1] for s in starts])
        yield {"inputs": inp, "targets": tgt}


class AgentPartitioner:
    """Distributes a dataset over N agents and serves stacked minibatches.

    IID: a global shuffle then round-robin assignment.  Non-IID: sort by
    label, split into N contiguous shards (each agent sees a biased label
    subset).
    """

    def __init__(self, ds: Dataset, n_agents: int, *, non_iid: bool = False, seed: int = 0):
        self.n_agents = n_agents
        rng = np.random.default_rng(seed)
        idx = np.argsort(ds.y, kind="stable") if non_iid else rng.permutation(len(ds))
        shards = np.array_split(idx, n_agents)
        m = min(len(s) for s in shards)
        self.shards = [s[:m] for s in shards]   # equal shard sizes
        self.ds = ds
        self._rng = np.random.default_rng(seed + 1)

    @property
    def shard_size(self) -> int:
        return len(self.shards[0])

    def batches(self, batch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite iterator of {"x": (A,b,...), "y": (A,b)} stacked batches."""
        while True:
            xs, ys = [], []
            for s in self.shards:
                take = self._rng.choice(s, size=batch, replace=batch > len(s))
                xs.append(self.ds.x[take])
                ys.append(self.ds.y[take])
            yield {"x": np.stack(xs), "y": np.stack(ys)}

    def full_shards(self) -> Dict[str, np.ndarray]:
        xs = np.stack([self.ds.x[s] for s in self.shards])
        ys = np.stack([self.ds.y[s] for s in self.shards])
        return {"x": xs, "y": ys}

    def label_histograms(self) -> np.ndarray:
        """(A, K) label counts per agent — used to verify non-IID skew."""
        k = int(self.ds.y.max()) + 1
        return np.stack([np.bincount(self.ds.y[s], minlength=k) for s in self.shards])


def lm_agent_batches(
    tokens: np.ndarray, n_agents: int, batch_per_agent: int, seq: int, *, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Per-agent LM batches ``{"inputs", "targets"}`` of shape ``(A, b,
    seq)``: agent j samples windows only from its token shard."""
    shards = np.array_split(tokens, n_agents)
    rng = np.random.default_rng(seed)
    while True:
        inp, tgt = [], []
        for sh in shards:
            n = sh.shape[0] - seq - 1
            starts = rng.integers(0, n, size=batch_per_agent)
            inp.append(np.stack([sh[s : s + seq] for s in starts]))
            tgt.append(np.stack([sh[s + 1 : s + seq + 1] for s in starts]))
        yield {"inputs": np.stack(inp), "targets": np.stack(tgt)}

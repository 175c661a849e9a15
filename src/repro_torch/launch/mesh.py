"""The sharded mode's process mesh: one process per agent.

The counterpart of :mod:`repro.launch.mesh`.  Where the reference lays the
agents along the ``data`` axis of a device mesh and runs the step under
``shard_map``, the port runs one process per agent on ``torch.distributed``:

* :class:`AgentMesh` — this process's rank (its agent index), the world
  size, the agent axes (``data``, or the reference's factored ``pod x
  data``: rank ``pod * n_data + data``), the backend, the process group,
  its device, the exchange's :class:`~repro_torch.core.collectives.Census`
  and its pinned staging buffers;
* :func:`init_agent_mesh` — joins the process group (explicit backend,
  init method and time limit);
* :func:`spawn_agents` — builds the kernels once in the parent, starts one
  ``spawn`` process per agent running ``fn(mesh, *args)``, joins them within
  a time limit, re-raises any rank's failure in the parent, and returns
  each rank's result in rank order.

A rank's device is ``cuda:{rank % device_count}``, or the CPU when the
caller asks for it.  The backend is explicit: ``gloo`` (CPU tensors, and
CUDA tensors staged through pinned host memory by
:mod:`repro_torch.core.collectives`, so any number of ranks may share one
card) or ``nccl`` (one card per rank; more ranks than cards raise).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.collectives import Census

BACKENDS = ("gloo", "nccl")
#: the agent axis of the sharded mode, as the reference's "data"
AGENT_AXIS = "data"
#: the outer agent axis of a factored mesh, as the reference's "pod"
POD_AXIS = "pod"


def _check_axes(axes, n_agents: int) -> dict:
    """``axes`` (None: one ``data`` axis of ``n_agents``) as an ordered
    ``{name: size}``: ``{"data": n}`` or ``{"pod": p, "data": d}`` with
    ``p * d == n_agents``."""
    if axes is None:
        return {AGENT_AXIS: n_agents}
    axes = dict(axes)
    if tuple(axes) not in ((AGENT_AXIS,), (POD_AXIS, AGENT_AXIS)):
        raise ValueError(f"agent axes must be ('data',) or ('pod', 'data'), "
                         f"got {tuple(axes)}")
    if math.prod(axes.values()) != n_agents or min(axes.values()) < 1:
        raise ValueError(f"agent axes {axes} do not cover {n_agents} agents")
    return axes


@dataclasses.dataclass
class AgentMesh:
    """One agent's view of the sharded mode's process mesh."""

    rank: int
    size: int
    backend: str
    group: Any                    # the process group (None: not joined)
    device: torch.device
    census: Census = dataclasses.field(default_factory=Census)
    # pinned staging buffers of the exchange, by role (collectives)
    pinned: dict = dataclasses.field(default_factory=dict)
    # the last staged exchange's device copies (collectives)
    landed: Any = None
    # the exchange in flight, if any (collectives)
    pending: Any = None
    # the agent axes, ordered: None for one ``data`` axis of ``size``
    axes: Any = None

    def __post_init__(self):
        self.axes = _check_axes(self.axes, self.size)

    @property
    def shape(self) -> dict:
        """``{axis: size}`` of every agent axis, outermost first."""
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.axes)

    def coords(self, rank: int) -> tuple:
        """Agent ``rank``'s index along each axis (row-major, the
        reference's linearized agent index)."""
        out = []
        for size in reversed(list(self.axes.values())):
            out.append(rank % size)
            rank //= size
        return tuple(reversed(out))

    def rank_of(self, coords) -> int:
        """The rank at ``coords``, each taken modulo its axis size."""
        r = 0
        for c, size in zip(coords, self.axes.values()):
            r = r * size + c % size
        return r

    def full_shift(self, shift, axis: Optional[str] = None) -> tuple:
        """A shift as one offset per agent axis: a tuple as is, an int
        along ``axis`` (None: the only axis of a one-axis mesh)."""
        if isinstance(shift, tuple):
            if len(shift) != len(self.axes):
                raise ValueError(f"shift {shift} for agent axes "
                                 f"{self.axis_names}")
            return shift
        if axis is None:
            if len(self.axes) != 1:
                raise ValueError(f"an int shift on the factored mesh "
                                 f"{self.axis_names} needs its axis")
            axis = self.axis_names[0]
        return tuple(shift if a == axis else 0 for a in self.axes)

    def peers(self, shift, axis: Optional[str] = None) -> tuple:
        """``(send_to, receive_from)`` of this rank along ``shift``: agent
        ``j`` receives from the agent at ``coords(j) + shift`` (the
        reference's ``_shift_all``, one transfer for the whole
        combination)."""
        s = self.full_shift(shift, axis)
        c = self.coords(self.rank)
        return (self.rank_of(tuple(x - d for x, d in zip(c, s))),
                self.rank_of(tuple(x + d for x, d in zip(c, s))))

    def shift_key(self, shift, axis: Optional[str] = None) -> int:
        """A shift's index in ``[0, size)``: 0 is the identity."""
        return self.rank_of(self.full_shift(shift, axis))


def agent_device(rank: int, device: str = "cuda") -> torch.device:
    """``cuda:{rank % device_count}`` for ``device="cuda"``, else the CPU;
    raises when ``cuda`` is asked for and there is no card."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", rank % n)


def init_agent_mesh(rank: int, n_agents: int, *, backend: str,
                    init_method: str, device: str = "cuda",
                    timeout: float = 60.0, axes=None) -> AgentMesh:
    """Join the process group as agent ``rank`` of ``n_agents``.

    ``init_method`` is a ``torch.distributed`` URL (``file://...`` for a
    ``FileStore``, ``tcp://localhost:<port>``); ``timeout`` (seconds) bounds
    every collective, so a dead or hung peer fails the rank instead of
    blocking it.  ``axes`` lays the agents out on ``{"data": n}`` (the
    default) or the factored ``{"pod": p, "data": d}``."""
    axes = _check_axes(axes, n_agents)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = agent_device(rank, device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' needs CUDA devices")
        if n_agents > torch.cuda.device_count():
            raise ValueError(
                f"backend 'nccl' takes one card per rank: {n_agents} ranks on "
                f"{torch.cuda.device_count()} card(s); use backend='gloo' to "
                "share a card")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=n_agents, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return AgentMesh(rank=rank, size=n_agents, backend=backend,
                     group=dist.group.WORLD, device=dev, axes=axes)


def _agent_main(fn, rank, n_agents, backend, init_method, device, timeout,
                threads, axes, args, out_path):
    """One rank: join, run ``fn(mesh, *args)``, save its result (or the
    traceback) next to ``out_path``, leave the group."""
    try:
        torch.set_num_threads(threads)
        mesh = init_agent_mesh(rank, n_agents, backend=backend,
                               init_method=init_method, device=device,
                               timeout=timeout, axes=axes)
        try:
            result = fn(mesh, *args)
        finally:
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            dist.destroy_process_group()
        torch.save(result, out_path)
    except BaseException:
        Path(out_path + ".err").write_text(traceback.format_exc())
        raise


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join(10)


def spawn_agents(fn: Callable, n_agents: int, *, args: tuple = (),
                 backend: str = "gloo", device: str = "cuda",
                 timeout: float = 60.0, join_timeout: float = 600.0,
                 threads: int = 1, axes=None) -> list:
    """Run ``fn(mesh, *args)`` on ``n_agents`` processes, one per agent, and
    return their results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its module path, so it must
    live in an importable module); each result is saved with
    ``torch.save`` and loaded here.  On ``device="cuda"`` the update and
    quantize kernels' libraries are built here first, once, so the ranks
    load them instead of each running ``nvcc`` on the same sources.
    ``timeout`` bounds each collective inside the ranks, ``join_timeout``
    the whole run; ``threads`` sets each rank's ``torch.set_num_threads``;
    ``axes`` (e.g. ``{"pod": 2, "data": 2}``) factors the agents as
    :func:`init_agent_mesh` does.  A rank that fails, or a run past its
    limit, stops every rank and raises here with the rank's traceback."""
    axes = _check_axes(axes, n_agents)
    if device == "cuda":
        from repro_torch.kernels import build
        from repro_torch.kernels.consensus_update import consensus_update as cu

        build.build_all(cu.LIBRARIES)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="agents_") as d:
        init_method = "file://" + os.path.join(d, "store")
        outs = [os.path.join(d, f"rank{r}.pt") for r in range(n_agents)]
        procs = [ctx.Process(target=_agent_main, name=f"agent{r}",
                             args=(fn, r, n_agents, backend, init_method, device,
                                   timeout, threads, axes, args, outs[r]))
                 for r in range(n_agents)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + join_timeout
        try:
            while any(p.is_alive() for p in procs):
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{n_agents} agents still running after "
                        f"{join_timeout:.0f} s: "
                        + ", ".join(p.name for p in procs if p.is_alive()))
                multiprocessing.connection.wait(
                    [p.sentinel for p in procs if p.is_alive()], left)
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        finally:
            _stop(procs)
        # every rank that failed: the first failure makes its peers fail
        # too (a closed connection), in no fixed order
        why = []
        for r, p in enumerate(procs):
            if p.exitcode != 0:
                err = Path(outs[r] + ".err")
                why.append(f"agent {r} of {n_agents} failed:\n"
                           + (err.read_text() if err.exists() else
                              f"exit code {p.exitcode}, no traceback"))
        if why:
            raise RuntimeError("\n".join(why))
        return [torch.load(o, weights_only=False) for o in outs]

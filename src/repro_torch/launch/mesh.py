"""The sharded mode's process mesh: one process per agent.

The counterpart of :mod:`repro.launch.mesh`.  Where the reference lays the
agents along the ``data`` axis of a device mesh and runs the step under
``shard_map``, the port runs one process per agent on ``torch.distributed``:

* :class:`AgentMesh` — this process's rank, the world size, the mesh
  axes, the backend, the process group, its device, the exchange's
  :class:`~repro_torch.core.collectives.Census` and its pinned staging
  buffers.  The axes are the reference's (:mod:`repro.launch.mesh`):
  ``data``, or the factored ``pod x data`` (rank ``pod * n_data +
  data``), each optionally followed by the non-agent ``model`` axis
  (``{"data": d, "model": m}``, ``{"pod": p, "data": d, "model": m}``),
  ranks laid out row-major with ``model`` innermost, as
  ``make_debug_mesh`` / ``make_production_mesh`` order their devices.  A
  mesh with a ``model`` axis also has one process group per axis line (the
  ranks that differ only along that axis; :meth:`AgentMesh.axis_group`),
  which the collectives over one named axis use, and one per model
  coordinate over the whole agent plane (every agent axis), which the
  agent collectives use.  A rank's agent is its index over the agent axes
  (:attr:`AgentMesh.agent` of :attr:`AgentMesh.n_agents`): on an
  agent-only mesh its rank, on a mesh with ``model`` the agent whose
  ``model`` shard it holds;
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
import faulthandler
import itertools
import math
import multiprocessing
import multiprocessing.connection
import os
import signal
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
#: the non-agent axis (tensor / expert parallel), as the reference's "model"
MODEL_AXIS = "model"
#: the axis names a mesh may have, in order
MESH_AXES = ((AGENT_AXIS,), (POD_AXIS, AGENT_AXIS), (AGENT_AXIS, MODEL_AXIS),
             (POD_AXIS, AGENT_AXIS, MODEL_AXIS))


def _check_axes(axes, n_ranks: int) -> dict:
    """``axes`` (None: one ``data`` axis of ``n_ranks``) as an ordered
    ``{name: size}``, one of :data:`MESH_AXES`, whose sizes multiply to
    ``n_ranks``."""
    if axes is None:
        return {AGENT_AXIS: n_ranks}
    axes = dict(axes)
    if tuple(axes) not in MESH_AXES:
        raise ValueError(f"mesh axes must be one of {MESH_AXES}, got "
                         f"{tuple(axes)}")
    if math.prod(axes.values()) != n_ranks or min(axes.values()) < 1:
        raise ValueError(f"mesh axes {axes} do not cover {n_ranks} ranks")
    return axes


def axis_lines(axes: dict, axis: str) -> list:
    """Every line of ``axis`` on a mesh of ``axes``: the ranks that differ
    only along ``axis``, in coordinate order, lines in the order of the
    other coordinates (row-major)."""
    names = list(axes)
    k = names.index(axis)
    others = [range(axes[a]) for a in names if a != axis]
    lines = []
    for rest in itertools.product(*others):
        line = []
        for c in range(axes[axis]):
            coords = list(rest)
            coords.insert(k, c)
            r = 0
            for x, a in zip(coords, names):
                r = r * axes[a] + x
            line.append(r)
        lines.append(line)
    return lines


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
    # the mesh axes, ordered: None for one ``data`` axis of ``size``
    axes: Any = None
    # this rank's process group along each axis of a mesh with a ``model``
    # axis (init_agent_mesh; None: the axis has one rank)
    groups: dict = dataclasses.field(default_factory=dict)
    # this rank's process group over the agent plane of its model
    # coordinate, on a mesh with a ``model`` axis (None: not joined)
    agent_group: Any = None

    def __post_init__(self):
        self.axes = _check_axes(self.axes, self.size)

    @property
    def shape(self) -> dict:
        """``{axis: size}`` of every mesh axis, outermost first."""
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.axes)

    @property
    def agent_axes(self) -> tuple:
        """The agent axes (every axis but ``model``)."""
        return tuple(a for a in self.axes if a != MODEL_AXIS)

    @property
    def agent(self) -> int:
        """This rank's agent: its index over the agent axes (the rank on
        an agent-only mesh)."""
        return self.entry_index(self.agent_axes)

    @property
    def n_agents(self) -> int:
        """The agents of the mesh: the ranks of the agent plane (the size
        on an agent-only mesh)."""
        return self.entry_size(self.agent_axes)

    def agent_of(self, rank: int) -> int:
        """Rank ``rank``'s agent."""
        return self.entry_index(self.agent_axes, rank)

    def coords(self, rank: int) -> tuple:
        """Rank ``rank``'s index along each axis (row-major, ``model``
        innermost: the reference's linearized device index)."""
        out = []
        for size in reversed(list(self.axes.values())):
            out.append(rank % size)
            rank //= size
        return tuple(reversed(out))

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 on an axis the mesh lacks)."""
        if axis not in self.axes:
            return 0
        return self.coords(self.rank)[self.axis_names.index(axis)]

    def axes_of(self, entry) -> tuple:
        """A spec entry (an axis name, a tuple of them, or None) as a tuple
        of axis names."""
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)

    def entry_size(self, entry) -> int:
        """The rank count of a spec entry's axes (1 for None)."""
        return math.prod(self.axes[a] for a in self.axes_of(entry))

    def entry_index(self, entry, rank: Optional[int] = None) -> int:
        """Rank ``rank``'s (default: this rank's) block index along a spec
        entry's axes, row-major in the entry's order."""
        c = dict(zip(self.axis_names,
                     self.coords(self.rank if rank is None else rank)))
        i = 0
        for a in self.axes_of(entry):
            i = i * self.axes[a] + c[a]
        return i

    def axis_group(self, entry):
        """``(group, ranks)`` of the collectives over a spec entry's axes:
        the group of this rank's line along one axis, of its agent plane
        for every agent axis, or the whole mesh's group for every axis of
        more than one rank; ``(None, 1)`` when the axes hold one rank,
        ``(None, n)`` on a mesh that joined no group (a ``meta`` trace)."""
        names = tuple(a for a in self.axes_of(entry) if self.axes[a] > 1)
        n = math.prod(self.axes[a] for a in names)
        if n == 1:
            return None, 1
        if self.group is None or \
                set(names) == {a for a, s in self.axes.items() if s > 1}:
            return self.group, n
        if len(names) == 1 and names[0] in self.groups:
            return self.groups[names[0]], n
        if set(names) == {a for a in self.agent_axes if self.axes[a] > 1} \
                and self.agent_group is not None:
            return self.agent_group, n
        raise ValueError(f"no process group over {names} on the mesh "
                         f"{self.shape}: one axis, the agent axes, or every "
                         "axis")

    def rank_of(self, coords) -> int:
        """The rank at ``coords``, each taken modulo its axis size."""
        r = 0
        for c, size in zip(coords, self.axes.values()):
            r = r * size + c % size
        return r

    def full_shift(self, shift, axis: Optional[str] = None) -> tuple:
        """A shift as one offset per mesh axis: a tuple (one offset per
        agent axis) as is, an int along ``axis`` (None: the only agent
        axis); the ``model`` offset is 0."""
        agent = self.agent_axes
        if isinstance(shift, tuple):
            if len(shift) != len(agent):
                raise ValueError(f"shift {shift} for agent axes {agent}")
            by_axis = dict(zip(agent, shift))
        else:
            if axis is None:
                if len(agent) != 1:
                    raise ValueError(f"an int shift on the factored mesh "
                                     f"{agent} needs its axis")
                axis = agent[0]
            by_axis = {axis: shift}
        return tuple(by_axis.get(a, 0) for a in self.axes)

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
    blocking it.  ``axes`` lays the ranks out on ``{"data": n}`` (the
    default), the factored ``{"pod": p, "data": d}``, or either with a
    ``model`` axis innermost (then every axis line gets its group)."""
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
    groups = _line_groups(axes, rank, backend, timeout)
    return AgentMesh(rank=rank, size=n_agents, backend=backend,
                     group=dist.group.WORLD, device=dev, axes=axes,
                     groups=groups,
                     agent_group=_plane_group(axes, rank, backend, timeout,
                                              groups))


def _line_groups(axes: dict, rank: int, backend: str, timeout: float) -> dict:
    """This rank's process group along each axis of a mesh with a
    ``model`` axis (none on an agent-only mesh, whose collectives run over
    the whole group).  Every rank creates every line's group, in the same
    order; an axis of one rank has none, and a line that is the whole mesh
    takes the world group."""
    groups = {}
    if MODEL_AXIS not in axes:
        return groups
    n = math.prod(axes.values())
    for axis, size in axes.items():
        if size == 1:
            groups[axis] = None
            continue
        for line in axis_lines(axes, axis):
            g = (dist.group.WORLD if len(line) == n else
                 dist.new_group(line, backend=backend,
                                timeout=datetime.timedelta(seconds=timeout)))
            if rank in line:
                groups[axis] = g
    return groups


def agent_planes(axes: dict) -> list:
    """The agent plane of every ``model`` coordinate: the ranks that share
    it, in agent order, planes in coordinate order."""
    if list(axes)[-1] != MODEL_AXIS:
        raise ValueError(f"the model axis is innermost, got {list(axes)}")
    planes = [[] for _ in range(axes[MODEL_AXIS])]
    for r in range(math.prod(axes.values())):
        planes[r % axes[MODEL_AXIS]].append(r)
    return planes


def _plane_group(axes: dict, rank: int, backend: str, timeout: float,
                 lines: dict):
    """This rank's process group over its agent plane, on a mesh with a
    ``model`` axis (None on an agent-only mesh).  One agent axis: its line
    group (the plane is the line); ``pod x data``: every rank creates one
    group per plane, in the same order; a plane that is the whole mesh
    takes the world group."""
    if MODEL_AXIS not in axes:
        return None
    agent = [a for a in axes if a != MODEL_AXIS]
    live = [a for a in agent if axes[a] > 1]
    if len(live) <= 1:
        return lines.get(live[0]) if live else None
    if axes[MODEL_AXIS] == 1:
        return dist.group.WORLD
    mine = None
    for plane in agent_planes(axes):
        g = dist.new_group(plane, backend=backend,
                           timeout=datetime.timedelta(seconds=timeout))
        if rank in plane:
            mine = g
    return mine


def _agent_main(fn, rank, n_agents, backend, init_method, device, timeout,
                threads, axes, args, out_path):
    """One rank: join, run ``fn(mesh, *args)``, save its result (or the
    traceback) next to ``out_path``, leave the group.  A rank stopped by the
    parent (its time limit) prints every thread's stack first."""
    faulthandler.register(signal.SIGTERM, all_threads=True, chain=True)
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
    ``torch.save`` and loaded here.  On ``device="cuda"`` the update,
    quantize and flash kernels' libraries are built here first, once, so
    the ranks load them instead of each running ``nvcc`` on the same
    sources.
    ``timeout`` bounds each collective inside the ranks, ``join_timeout``
    the whole run; ``threads`` sets each rank's ``torch.set_num_threads``;
    ``axes`` (e.g. ``{"pod": 2, "data": 2}``, ``{"data": 2, "model": 2}``)
    lays the ranks out as :func:`init_agent_mesh` does.  A rank that fails, or a run past its
    limit, stops every rank and raises here with the rank's traceback."""
    axes = _check_axes(axes, n_agents)
    if device == "cuda":
        from repro_torch.kernels import build
        from repro_torch.kernels.consensus_update import consensus_update as cu

        # the flash kernel too: the sharded prefill runs it in every rank
        build.build_all([*cu.LIBRARIES, "flash_attention"])
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

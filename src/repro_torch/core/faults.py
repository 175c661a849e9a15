"""Deterministic fault injection for the bounded-staleness exchange.

A :class:`FaultSchedule` is the communication-fault analog of
:class:`repro_torch.core.topology.TopologySchedule`: a host-precomputed,
periodic table of per-step per-agent faults that the step indexes with the
optimizer step (a Python int) on the host — no device randomness, no
run-to-run drift.  Numpy only: a copy of :mod:`repro.core.faults`, so both
packages build identical tables.

Two fault kinds, matching what the depth-``S`` staleness ring tolerates
(see ARCHITECTURE.md "Exchange schedules"):

* **straggler** — ``straggle[t, j]`` means agent ``j``'s freshest payload
  misses consumption step ``t``: its outgoing wire slot goes one step
  staler instead of refreshing.  A window of ``k`` consecutive straggle
  bits makes the agent's contributed payload up to ``k + 1`` steps stale;
  once the staleness would exceed the ring depth ``S`` the receivers mask
  the agent out entirely (arrival-masked weight renormalization).
* **link drop** — ``linkup[t, i, j] = False`` means the directed link
  ``i <- j`` is down at step ``t``: receiver ``i`` masks sender ``j``
  regardless of staleness and renormalizes ``j``'s mixing weight into its
  own self term (row-stochasticity preserved).

The tables are periodic; windowed events (``stall:``/``droplink:``) repeat
every cycle, so give them a period at least as long as the run when a
one-shot fault is intended.  ``straggle[0]`` must be all-False (every agent
publishes at the cycle start) — this makes the sender-age recurrence
exactly periodic, so the ring-index/arrival tables the mixing weights are
built from agree bit-for-bit with the ``send_age`` counters carried in
``OptState.wire``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

# seed stride between steps of a seeded (random:) fault table; mirrors
# repro_torch.core.topology._SCHEDULE_SEED_STRIDE so fault streams and gossip
# topology streams with the same base seed still decorrelate per step
_FAULT_SEED_STRIDE = 1000003

# hard cap on the (lcm-combined) table period: the masked weight stacks are
# materialized per period step, so an accidental lcm blowup should fail loudly
MAX_FAULT_PERIOD = 8192


@dataclasses.dataclass(frozen=True, eq=False)
class FaultSchedule:
    """Periodic per-step fault masks (see module docstring).

    ``straggle``: ``(period, n_agents)`` bool — sender ``j`` fails to
    publish a fresh payload for consumption step ``t``.
    ``linkup``: ``(period, n_agents, n_agents)`` bool — directed link
    ``i <- j`` is up at step ``t`` (diagonal always True: the self term
    never crosses the wire and is never faulted).
    """

    name: str
    n_agents: int
    period: int
    straggle: np.ndarray
    linkup: np.ndarray
    seed: int = 0

    @property
    def is_trivial(self) -> bool:
        """No straggles, no drops — the fault-free schedule."""
        return bool((~self.straggle).all() and self.linkup.all())

    def validate(self) -> None:
        a, p = self.n_agents, self.period
        if self.straggle.shape != (p, a):
            raise ValueError(f"straggle shape {self.straggle.shape} != {(p, a)}")
        if self.linkup.shape != (p, a, a):
            raise ValueError(f"linkup shape {self.linkup.shape} != {(p, a, a)}")
        if not all(self.linkup[t].diagonal().all() for t in range(p)):
            raise ValueError("linkup diagonal must be True: the self term "
                             "never crosses the wire and cannot be dropped")
        if self.straggle[0].any():
            raise ValueError(
                "straggle[0] must be all-False (every agent publishes at the "
                "cycle start); shift the straggle window to start >= 1 — this "
                "keeps the sender-age recurrence exactly periodic so the "
                "precomputed arrival tables match the carried age counters")

    def tables(self, staleness: int) -> dict:
        """Derived per-step tables at ring depth ``staleness`` (host numpy).

        * ``send_age (period, A) int32`` — the age of the ring slot sender
          ``j`` contributes at consumption step ``t`` (0 = the normal
          one-step-stale generation ``t - 1``), clamped at ``staleness``
          (the sentinel: nothing within the ring arrived).  This is the
          steady state of the counter recurrence the runtime carries:
          ``a_t = a_{t-1} + 1`` if straggling else ``0``.
        * ``arrive (period, A, A) bool`` — receiver ``i`` uses sender
          ``j``'s payload at step ``t``: the link is up AND the contributed
          slot is within the ring (``send_age < staleness``).  Diagonal
          True.  Mixing weights renormalize over exactly these arrivals.
        """
        if not isinstance(staleness, int) or staleness < 1:
            raise ValueError(f"staleness must be an int >= 1, got {staleness!r}")
        self.validate()
        p, a = self.period, self.n_agents
        send_age = np.zeros((p, a), np.int32)
        for t in range(1, p):
            send_age[t] = np.where(self.straggle[t],
                                   np.minimum(send_age[t - 1] + 1, staleness), 0)
        arrive = self.linkup & (send_age < staleness)[:, None, :]
        for t in range(p):
            np.fill_diagonal(arrive[t], True)
        return {"send_age": send_age, "arrive": arrive}

    def arrival_accounting(self, staleness: int, steps: Optional[int] = None) -> list:
        """Per-step arrival record (the staleness accounting).

        One dict per step over ``steps`` (default: one period): how many of
        the ``A * (A - 1)`` directed off-diagonal links delivered, how many
        were masked, and the max/mean staleness (in steps; fresh overlap
        payloads have staleness 1) among the arrived links.
        """
        tb = self.tables(staleness)
        steps = self.period if steps is None else int(steps)
        off = ~np.eye(self.n_agents, dtype=bool)
        out = []
        for t in range(steps):
            tp = t % self.period
            arr = tb["arrive"][tp] & off
            stale = (tb["send_age"][tp] + 1)[None, :] * arr
            n_arr = int(arr.sum())
            out.append({
                "step": t,
                "arrived_links": n_arr,
                "masked_links": int(off.sum()) - n_arr,
                "max_staleness": int(stale.max()) if n_arr else 0,
                "mean_staleness": float(stale.sum() / n_arr) if n_arr else 0.0,
            })
        return out

    def describe(self) -> dict:
        off = ~np.eye(self.n_agents, dtype=bool)
        return {
            "spec": self.name,
            "n_agents": self.n_agents,
            "period": self.period,
            "seed": self.seed,
            "straggle_fraction": float(self.straggle.mean()),
            "drop_fraction": float((~self.linkup & off).mean()),
        }


def trivial_faults(n_agents: int, period: int = 1) -> FaultSchedule:
    """The all-arrive schedule (staleness > 1 with no injected faults)."""
    return FaultSchedule(
        name="none", n_agents=n_agents, period=period,
        straggle=np.zeros((period, n_agents), bool),
        linkup=np.ones((period, n_agents, n_agents), bool))


def arrival_masked_pi(pi: np.ndarray, arrive: np.ndarray) -> np.ndarray:
    """THE arrival-mask renormalization rule, as a dense row-stochastic Pi.

    Off-diagonal weights of non-arrived neighbors are zeroed and their mass
    folds into the receiver's self weight — row sums are preserved exactly
    and the self term stays fresh.  Both execution modes' masked weight
    stacks and the Lyapunov bound build from this one function.
    """
    pi = np.asarray(pi, np.float64)
    n = pi.shape[0]
    off = pi * (1.0 - np.eye(n))
    m = np.asarray(arrive, np.float64)
    w_self = np.diag(pi) + np.sum(off * (1.0 - m), axis=1)
    out = off * m
    out[np.arange(n), np.arange(n)] = w_self
    return out


def _int(v: str, what: str) -> int:
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"fault spec: {what} must be an int, got {v!r}")


def make_fault_schedule(spec: Optional[str], n_agents: int, *,
                        period: Optional[int] = None,
                        seed: int = 0) -> Optional[FaultSchedule]:
    """Build a :class:`FaultSchedule` from a spec string.

    Comma-joined parts; the table period is the lcm of the parts' natural
    periods (and ``period=`` when given).  Grammar:

    * ``straggler:<agent>:<delay>`` — periodically slow agent: publishes
      once every ``delay + 1`` steps (straggles the other ``delay``), so
      its contributed payload cycles through staleness ``1..delay + 1``.
    * ``stall:<agent>:<start>:<len>`` — windowed stall: the agent straggles
      steps ``[start, start + len)`` of every cycle (``start >= 1``).
    * ``drop:<i>:<j>`` — directed link ``i <- j`` down permanently.
    * ``droplink:<i>:<j>:<start>:<len>`` — windowed directed link drop.
    * ``random:<p>:<T>`` — iid off-diagonal link drops with probability
      ``p`` over a period of ``T`` steps, seeded per step like
      ``TopologySchedule``'s gossip factory (``default_rng(seed +
      STRIDE * t)``) so every execution mode draws the same masks.

    ``spec=None`` / ``"none"`` / ``""`` returns ``None`` (no fault layer).
    """
    if spec is None or spec in ("", "none"):
        return None
    parts = [p.strip() for p in str(spec).split(",") if p.strip()]
    if not parts:
        return None

    natural = [int(period)] if period else []
    parsed = []
    for part in parts:
        f = part.split(":")
        kind = f[0]
        if kind == "straggler" and len(f) == 3:
            agent, delay = _int(f[1], "agent"), _int(f[2], "delay")
            if delay < 1:
                raise ValueError(f"straggler delay must be >= 1, got {delay}")
            parsed.append(("straggler", agent, delay))
            natural.append(delay + 1)
        elif kind == "stall" and len(f) == 4:
            agent, start, ln = (_int(f[1], "agent"), _int(f[2], "start"),
                                _int(f[3], "len"))
            if start < 1:
                raise ValueError(
                    f"stall start must be >= 1 (agents publish at the cycle "
                    f"start), got {start}")
            parsed.append(("stall", agent, start, ln))
            natural.append(start + ln)
        elif kind == "drop" and len(f) == 3:
            i, j = _int(f[1], "receiver"), _int(f[2], "sender")
            parsed.append(("drop", i, j))
            natural.append(1)
        elif kind == "droplink" and len(f) == 5:
            i, j, start, ln = (_int(f[1], "receiver"), _int(f[2], "sender"),
                               _int(f[3], "start"), _int(f[4], "len"))
            parsed.append(("droplink", i, j, start, ln))
            natural.append(start + ln)
        elif kind == "random" and len(f) == 3:
            try:
                p = float(f[1])
            except ValueError:
                raise ValueError(f"fault spec: drop probability must be a "
                                 f"float, got {f[1]!r}")
            t_per = _int(f[2], "period")
            if not 0.0 <= p <= 1.0 or t_per < 1:
                raise ValueError(f"random:<p>:<T> needs 0 <= p <= 1 and "
                                 f"T >= 1, got p={p}, T={t_per}")
            parsed.append(("random", p, t_per))
            natural.append(t_per)
        else:
            raise ValueError(
                f"unknown fault spec part {part!r}; expected "
                "straggler:<agent>:<delay>, stall:<agent>:<start>:<len>, "
                "drop:<i>:<j>, droplink:<i>:<j>:<start>:<len>, or "
                "random:<p>:<T>")

    full = math.lcm(*natural) if natural else 1
    if full > MAX_FAULT_PERIOD:
        raise ValueError(f"fault schedule period lcm {full} exceeds "
                         f"{MAX_FAULT_PERIOD}; shorten the windows or pass "
                         "period= explicitly")

    def _agent_ok(a, what="agent"):
        if not 0 <= a < n_agents:
            raise ValueError(f"fault spec {what} {a} out of range for "
                             f"{n_agents} agents")

    straggle = np.zeros((full, n_agents), bool)
    linkup = np.ones((full, n_agents, n_agents), bool)
    for item in parsed:
        kind = item[0]
        if kind == "straggler":
            _, agent, delay = item
            _agent_ok(agent)
            for t in range(full):
                straggle[t, agent] |= (t % (delay + 1)) != 0
        elif kind == "stall":
            _, agent, start, ln = item
            _agent_ok(agent)
            nat = start + ln
            for t in range(full):
                straggle[t, agent] |= start <= (t % nat) < start + ln
        elif kind in ("drop", "droplink"):
            i, j = item[1], item[2]
            _agent_ok(i, "receiver")
            _agent_ok(j, "sender")
            if i == j:
                raise ValueError("cannot drop the self link (the self term "
                                 "never crosses the wire)")
            if kind == "drop":
                linkup[:, i, j] = False
            else:
                start, ln = item[3], item[4]
                nat = start + ln
                for t in range(full):
                    if start <= (t % nat) < start + ln:
                        linkup[t, i, j] = False
        elif kind == "random":
            _, p, t_per = item
            off = ~np.eye(n_agents, dtype=bool)
            for t in range(full):
                rng = np.random.default_rng(seed + _FAULT_SEED_STRIDE
                                            * (t % t_per))
                drops = (rng.random((n_agents, n_agents)) < p) & off
                linkup[t] &= ~drops

    sched = FaultSchedule(name=str(spec), n_agents=n_agents, period=full,
                          straggle=straggle, linkup=linkup, seed=seed)
    sched.validate()
    return sched

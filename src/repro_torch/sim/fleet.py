"""Fleet churn: server failures, recoveries and maintenance drains.

The port's own copy of the reference's ``sim/fleet.py`` (numpy only; the
generators draw from the numpy generator in the same order, so a seed
gives the same trace):

* :class:`FleetEvent` / :class:`FleetTrace`: a seeded, immutable event
  trace.  :func:`make_fleet_trace` samples per-server-class exponential
  MTBF/MTTR failure processes plus scheduled maintenance drains over a
  rotating slice of the worker fleet; :func:`churn_trace` fails exactly
  ``frac`` of each pool once mid-horizon.
* :class:`FleetState`: the run-time fold of a trace, per-server up/down
  state, the effective (masked) capacities and the per-slot transitions
  the engine acts on.  A ``fail`` is lossy (victims roll back to their
  last checkpoint), a ``drain_start`` graceful (checkpoint at drain
  start).

The empty trace is falsy, and the engine never enters a churn branch for
it: an empty ``FleetTrace()`` is an exact no-op.

Example — a 20%-churn trace over a paper-scale fleet::

    >>> from repro_torch.sim.fleet import churn_trace, FleetState
    >>> from repro_torch.sim.workload import make_cluster
    >>> cluster = make_cluster(T=100, H=50, K=50)
    >>> trace = churn_trace(cluster, frac=0.2, seed=0)
    >>> sum(1 for e in trace.events
    ...     if e.kind == "fail" and e.pool == "worker")
    10
    >>> FleetState(cluster, trace).live_frac    # everything starts alive
    1.0
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..core.types import ClusterSpec

# transition kinds FleetState.step reports to the engine
DOWN_LOSSY = "down_lossy"        # crash: work since last checkpoint lost
DOWN_GRACEFUL = "down_graceful"  # drain: checkpoint taken at drain start
UP = "up"                        # capacity restored


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    """One fleet transition: a server fails/recovers or a drain window
    opens/closes.  ``pool`` is ``"worker"`` or ``"ps"``; ``server`` the
    row index into that pool's capacity array."""

    slot: int
    kind: str          # "fail" | "recover" | "drain_start" | "drain_end"
    pool: str          # "worker" | "ps"
    server: int


@dataclasses.dataclass(frozen=True)
class FleetTrace:
    """An immutable, slot-ordered fleet event trace.  Falsy when empty —
    the engine uses that as the churn on/off switch, and the empty trace
    is pinned to be an exact no-op."""

    events: Tuple[FleetEvent, ...] = ()

    def __bool__(self) -> bool:
        return bool(self.events)

    @property
    def slots(self) -> List[int]:
        return sorted({e.slot for e in self.events})


def _server_classes(caps: np.ndarray) -> np.ndarray:
    """Class index per server: servers with identical capacity rows share
    a class (first-seen order)."""
    seen: Dict[bytes, int] = {}
    return np.array([seen.setdefault(caps[i].tobytes(), len(seen))
                     for i in range(caps.shape[0])], dtype=np.int64)


def make_fleet_trace(cluster: ClusterSpec, T: Optional[int] = None,
                     seed: int = 0, mtbf: float = 400.0, mttr: float = 25.0,
                     class_mtbf: Optional[Mapping[int, float]] = None,
                     class_mttr: Optional[Mapping[int, float]] = None,
                     include_ps: bool = True,
                     drain_every: Optional[int] = None,
                     drain_duration: int = 10,
                     drain_frac: float = 0.1) -> FleetTrace:
    """Seeded failure/recovery + maintenance-drain trace.

    Each server runs an alternating-renewal process: up-times are
    exponential with the server **class**'s MTBF, down-times exponential
    with its MTTR (classes = distinct capacity rows, overridable per
    class index via ``class_mtbf``/``class_mttr``).  With ``drain_every``
    set, every ``drain_every`` slots a rotating ``drain_frac`` slice of
    the worker fleet is drained for ``drain_duration`` slots (graceful:
    the engine checkpoints victims at drain start).
    """
    T = cluster.T if T is None else int(T)
    rng = np.random.default_rng(seed)
    events: List[FleetEvent] = []
    pools = [("worker", cluster.worker_caps)]
    if include_ps:
        pools.append(("ps", cluster.ps_caps))
    for pool, caps in pools:
        cls = _server_classes(caps)
        for s in range(caps.shape[0]):
            mb = float((class_mtbf or {}).get(int(cls[s]), mtbf))
            mr = float((class_mttr or {}).get(int(cls[s]), mttr))
            t = rng.exponential(mb)
            while t < T:
                fail = max(1, int(math.ceil(t)))
                if fail >= T:
                    break
                dur = max(1, int(round(rng.exponential(mr))))
                events.append(FleetEvent(fail, "fail", pool, s))
                rec = fail + dur
                if rec < T:
                    events.append(FleetEvent(rec, "recover", pool, s))
                t = rec + rng.exponential(mb)
    if drain_every:
        H = cluster.H
        k = max(1, int(round(drain_frac * H)))
        start, idx = int(drain_every), 0
        while start < T - 1 and H:
            for j in range(k):
                s = (idx + j) % H
                events.append(FleetEvent(start, "drain_start", "worker", s))
                end = start + int(drain_duration)
                if end < T:
                    events.append(FleetEvent(end, "drain_end", "worker", s))
            idx += k
            start += int(drain_every)
    events.sort(key=lambda e: (e.slot, e.pool, e.server, e.kind))
    return FleetTrace(tuple(events))


def churn_trace(cluster: ClusterSpec, frac: float, seed: int = 0,
                T: Optional[int] = None,
                recover: bool = True) -> FleetTrace:
    """The scoreboard trace: exactly ``round(frac * pool_size)`` servers
    of each pool fail once, at a uniform slot in the middle ~3/4 of the
    horizon, each down for an exponential (mean ``T/6``) repair time
    (dropped past the horizon when ``recover`` and the draw run long).
    Deterministic in ``(cluster dims, frac, seed)``."""
    T = cluster.T if T is None else int(T)
    rng = np.random.default_rng(seed)
    events: List[FleetEvent] = []
    lo, hi = max(1, T // 8), max(2, (7 * T) // 8)
    for pool, n in (("worker", cluster.H), ("ps", cluster.K)):
        k = int(round(frac * n))
        if k <= 0:
            continue
        servers = rng.choice(n, size=min(k, n), replace=False)
        for s in sorted(int(x) for x in servers):
            fail = int(rng.integers(lo, hi))
            events.append(FleetEvent(fail, "fail", pool, s))
            if recover:
                rec = fail + max(1, int(round(rng.exponential(T / 6.0))))
                if rec < T:
                    events.append(FleetEvent(rec, "recover", pool, s))
    events.sort(key=lambda e: (e.slot, e.pool, e.server, e.kind))
    return FleetTrace(tuple(events))


class FleetState:
    """Run-time fold of a :class:`FleetTrace`: per-server up/down state,
    effective (masked) capacity arrays, and per-slot transitions.

    A server is *down* while failed or inside ≥1 drain window; the two
    conditions compose (a crash during a drain keeps the server down
    past ``drain_end`` until its ``recover``).  :meth:`step` applies all
    events at one slot and returns the servers whose up/down state
    actually flipped, tagged lossy (``fail`` among the slot's events for
    that server) or graceful.
    """

    def __init__(self, cluster: ClusterSpec, trace: FleetTrace):
        self.cluster = cluster
        self._failed = {"worker": np.zeros(cluster.H, dtype=bool),
                        "ps": np.zeros(cluster.K, dtype=bool)}
        self._drains = {"worker": np.zeros(cluster.H, dtype=np.int64),
                        "ps": np.zeros(cluster.K, dtype=np.int64)}
        self._by_slot: Dict[int, List[FleetEvent]] = {}
        for ev in trace.events:
            self._by_slot.setdefault(int(ev.slot), []).append(ev)
        self.event_slots: List[int] = sorted(self._by_slot)
        self._caps = {"worker": cluster.worker_caps, "ps": cluster.ps_caps}
        self._eff: Dict[str, np.ndarray] = {}
        self._gpu_total = max(float(cluster.worker_caps[:, 0].sum()), 1e-9)

    def _is_down(self, pool: str, server: int) -> bool:
        return bool(self._failed[pool][server]
                    or self._drains[pool][server] > 0)

    def step(self, t: int) -> List[Tuple[str, int, str]]:
        """Apply every event at slot ``t``; return ``(pool, server,
        transition)`` for servers whose up/down state flipped, lossy
        transitions first (a server hit by both a ``fail`` and a
        ``drain_start`` in the same slot is a crash)."""
        evs = self._by_slot.get(int(t))
        if not evs:
            return []
        prior: Dict[Tuple[str, int], bool] = {}
        lossy: set = set()
        for ev in evs:
            key = (ev.pool, ev.server)
            if key not in prior:
                prior[key] = self._is_down(*key)
            if ev.kind == "fail":
                self._failed[ev.pool][ev.server] = True
                lossy.add(key)
            elif ev.kind == "recover":
                self._failed[ev.pool][ev.server] = False
            elif ev.kind == "drain_start":
                self._drains[ev.pool][ev.server] += 1
            elif ev.kind == "drain_end":
                self._drains[ev.pool][ev.server] = max(
                    0, self._drains[ev.pool][ev.server] - 1)
            else:                               # pragma: no cover
                raise ValueError(f"unknown fleet event kind {ev.kind!r}")
        out: List[Tuple[str, int, str]] = []
        for (pool, srv), was_down in sorted(prior.items()):
            now_down = self._is_down(pool, srv)
            if now_down and not was_down:
                kind = DOWN_LOSSY if (pool, srv) in lossy else DOWN_GRACEFUL
                out.append((pool, srv, kind))
            elif was_down and not now_down:
                out.append((pool, srv, UP))
        if out:
            self._eff.clear()                   # masked caps changed
        # lossy first: victim classification must see crashes before drains
        out.sort(key=lambda x: (x[2] != DOWN_LOSSY, x[0], x[1]))
        return out

    def down_servers(self) -> List[Tuple[str, int]]:
        """Currently-down ``(pool, server)`` pairs, deterministic order."""
        out = []
        for pool in ("worker", "ps"):
            down = self._failed[pool] | (self._drains[pool] > 0)
            out.extend((pool, int(s)) for s in np.flatnonzero(down))
        return out

    def _effective(self, pool: str) -> np.ndarray:
        eff = self._eff.get(pool)
        if eff is None:
            up = ~(self._failed[pool] | (self._drains[pool] > 0))
            eff = self._caps[pool] * up[:, None].astype(float)
            self._eff[pool] = eff
        return eff

    @property
    def worker_caps(self) -> np.ndarray:
        """(H, R) effective worker capacities (0-rows for down servers)."""
        return self._effective("worker")

    @property
    def ps_caps(self) -> np.ndarray:
        return self._effective("ps")

    @property
    def live_frac(self) -> float:
        """Fraction of the worker pool's GPU capacity currently alive."""
        return float(self.worker_caps[:, 0].sum() / self._gpu_total)

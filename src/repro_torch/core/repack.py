"""Vectorized repack kernels for the reactive baselines (DRF/Dorm/RRH).

The port's own copy of the reference's ``core/repack.py``.  These
"kernels" are host code: numpy whole-round passes and heap and cursor
loops over Python scalars.  One repack touches a few hundred jobs x 5
resources, so a device launch would only add latency; nothing here
creates a torch tensor, and the floats replay the reference op for op,
so every placement equals the reference's bit for bit
(``tests/test_torch_repack.py``).

The reference's greedy loops (its ``step_reference``) repack the whole
live job set one chunk at a time: every event triggers O(jobs x chunks) Python-level ``_place(1, ...)``
calls, each a freshly-allocated ``(S, R)`` array scan that restarts from
server 0.  At the fig3-shaped 10x scale (T=500, 100+100 servers, 2000
jobs) DRF and Dorm each burn ~80 s of a CPU in that loop — the baselines, not
OASiS, became the simulation bottleneck once the sim-v2 event engine
landed.

This module re-derives the same repacks as **batch-round kernels** over
dense per-job state (demand rows, chunk counts, shares and first-fit
cursors are flat per-job vectors gathered from a ``DensePool``, not
``Job`` objects), built on three invariants of the greedy loops:

1.  **Free capacity is non-increasing within one repack.**  Successful
    placements subtract demand; the only additions are the PS-failure
    rollbacks, which restore exactly what the same turn subtracted.
    Hence (a) a job that once fails (no fitting worker server, or a PS
    rollback) can never succeed later in the same ``step`` call — the
    reference's futile retries for already-failed jobs, the dominant
    interpreter cost, are dropped without changing a single placement —
    and (b) each job's first-fit server index is *monotone
    non-decreasing*, so the reference's from-0 rescan per chunk
    collapses to a per-job **cursor** that only ever moves right and is
    validated at use.  Total cursor movement is bounded by the server
    count per job per repack, instead of per chunk.

2.  **Whole-set failure is detectable against capacity envelopes.**
    Servers are grouped into blocks carrying per-resource upper bounds
    on free capacity (stale-high is sound — placements only subtract —
    and bounds are tightened lazily when a scan through a passing block
    comes up empty).  A job demanding more than a block's bound in any
    resource skips the whole block in O(R), which is how the large
    hopeless tail of a saturated cluster — the reference's dominant
    cost — is retired in a handful of comparisons per job.

3.  **DRF's progressive filling is a lazy heap over linear shares.**
    ``share(count) = max(count * w / total_w)`` is strictly monotone in
    the chunk count, so the reference's ``min(candidates, key=shares)``
    pick is a ``(share, arrival-index)`` heap pop — first-minimum
    tie-break preserved — with stale entries skipped on pop.

All float updates replay the reference op-for-op on Python scalars
(IEEE-754 doubles, the same arithmetic numpy applies elementwise), so
placements match the greedy loops exactly; the single semantic deviation
is that a sub-ULP capacity wobble from a PS rollback (``x - d + d > x``)
can no longer resurrect a previously unfit server for a job whose cursor
moved past it — beyond the loops' own 1e-9 slack and unobserved on any
tested instance.  Exact equality of placements against the reference's
``step_reference`` holds on the seeded paper-scale instances and on
randomized adversarial instances (full-pool rejection, PS-placement
rollback, heterogeneous fleets).

The placement primitive ``_place_fast`` lives here too: it is the
bottom layer of the RRH/FIFO kernels and the multi-instance PS path.
"""
from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs as _obs
from .types import Job

Placement = Tuple[np.ndarray, np.ndarray]


# ---------------------------------------------------------------------------
# Placement primitives (round-robin onto servers).
# ---------------------------------------------------------------------------

def _place_fast(count: int, free: np.ndarray, demand: np.ndarray
                ) -> Optional[np.ndarray]:
    """Each round places one instance on every server (in index order) that
    still fits the demand; rounds repeat until all instances are placed or
    no server fits.  The whole round's fit mask is one array op — server
    rows are independent, so checking before the round equals checking at
    each visit, bit for bit, including the 1e-9 slack and the sequential
    ``free -= demand`` float updates of the per-server loop."""
    S = free.shape[0]
    out = np.zeros(S, dtype=np.int64)
    if count == 0:
        return out
    placed = 0
    while placed < count:
        fits = np.flatnonzero(np.all(free >= demand[None] - 1e-9, axis=1))
        if fits.size == 0:
            # rollback
            free += out[:, None] * demand[None]
            return None
        take = fits[:count - placed]
        free[take] -= demand[None]
        out[take] += 1
        placed += take.size
    return out


# ---------------------------------------------------------------------------
# Dense per-job state, maintained incrementally across events.
# ---------------------------------------------------------------------------

class DensePool:
    """Row-per-job scheduler state, updated on arrival/completion.

    Demands are stored as Python float tuples: the kernels' hot loops run
    scalar IEEE-754 arithmetic (bit-identical to numpy's elementwise
    ops) where per-call numpy overhead would dominate, and rebuilding
    this state from ``Job`` objects on every event would cost more
    interpreter time than the kernels themselves at scale.
    """

    def __init__(self, R: int):
        self._R = R
        self.wres: Dict[int, Tuple[float, ...]] = {}   # worker demand
        self.sres: Dict[int, Tuple[float, ...]] = {}   # PS demand
        self.maxc: Dict[int, int] = {}
        self.bw: Dict[int, float] = {}
        self.psbw: Dict[int, float] = {}

    def add(self, job: Job) -> None:
        jid = job.jid
        self.wres[jid] = tuple(float(v) for v in job.worker_res)
        self.sres[jid] = tuple(float(v) for v in job.ps_res)
        self.maxc[jid] = int(job.num_chunks)
        self.bw[jid] = float(job.worker_bw)
        self.psbw[jid] = float(job.ps_bw)

    def remove(self, jid: int) -> None:
        self.wres.pop(jid, None)
        self.sres.pop(jid, None)
        self.maxc.pop(jid, None)
        self.bw.pop(jid, None)
        self.psbw.pop(jid, None)


def _ps_for(count: int, bw: float, psbw: float) -> int:
    """``Job.ps_for`` with the exact scalar arithmetic of the dataclass
    (ceil(count * b / B - 1e-9); 0 workers need 0 parameter servers)."""
    if count == 0:
        return 0
    return math.ceil(count * bw / psbw - 1e-9)


class _CursorPool:
    """One server pool with per-job monotone first-fit cursors.

    ``free`` is a list of per-server Python float lists; ``find(j)``
    resumes job ``j``'s scan at its cursor — sound because capacity is
    non-increasing, so servers the cursor passed can never fit again.
    A two-level envelope accelerates the scan: servers are grouped into
    blocks of ``_BLOCK`` and each block keeps a per-resource upper bound
    on its free capacity.  A block whose bound is below the demand in
    any resource cannot contain a fit and is skipped in O(R); bounds are
    allowed to go stale high (sound, placements only subtract) and are
    tightened lazily whenever a walk through a passing block comes up
    empty.  Whole-pool rejection — the saturated cluster's hopeless tail
    that dominates reference runtime — thus costs O(S / _BLOCK * R)
    scalar compares per job instead of a fresh array scan per retry."""

    _BLOCK = 8

    def __init__(self, caps: np.ndarray, demands: List[Tuple[float, ...]]):
        self.free: List[List[float]] = [list(map(float, row)) for row in caps]
        self.S = len(self.free)
        self.R = caps.shape[1] if self.S else 0
        self._r5 = self.R == 5                # unrolled hot path
        self.d = demands
        self.dm = [tuple(v - 1e-9 for v in d) for d in demands]
        self.cursor = [0] * len(demands)
        B = self._BLOCK
        self._nb = (self.S + B - 1) // B
        self._benv = [[max(row[r] for row in self.free[b * B:b * B + B])
                       for r in range(self.R)]
                      for b in range(self._nb)]
        self._mut = [0] * self._nb            # block mutation counters
        self._tightened = [0] * self._nb      # mutation count at last tighten

    def _tighten(self, b: int) -> None:
        if self._tightened[b] == self._mut[b]:
            return                            # bound already exact
        B = self._BLOCK
        self._benv[b] = [max(row[r] for row in self.free[b * B:b * B + B])
                         for r in range(self.R)]
        self._tightened[b] = self._mut[b]

    def find(self, j: int) -> int:
        """First server fitting job ``j``'s demand (reference slack:
        ``free >= d - 1e-9``), or -1; advances the cursor."""
        s = self.cursor[j]
        S = self.S
        if s >= S:
            return -1
        dm = self.dm[j]
        free = self.free
        B = self._BLOCK
        R = self.R
        r5 = self._r5
        if r5:
            d0, d1, d2, d3, d4 = dm
        for b in range(s // B, self._nb):
            env = self._benv[b]
            if r5:
                if (d0 > env[0] or d1 > env[1] or d2 > env[2]
                        or d3 > env[3] or d4 > env[4]):
                    continue                  # no server in block can fit
            else:
                if any(dm[r] > env[r] for r in range(R)):
                    continue
            lo = s if b == s // B else b * B
            hi = min(S, b * B + B)
            if r5:
                for srv in range(lo, hi):
                    row = free[srv]
                    if (row[0] < d0 or row[1] < d1 or row[2] < d2
                            or row[3] < d3 or row[4] < d4):
                        continue
                    self.cursor[j] = srv
                    return srv
            else:
                for srv in range(lo, hi):
                    row = free[srv]
                    for fv, dv in zip(row, dm):
                        if fv < dv:
                            break
                    else:
                        self.cursor[j] = srv
                        return srv
            self._tighten(b)                  # bound was stale: pay it down
        self.cursor[j] = S
        return -1

    def take(self, s: int, j: int) -> None:
        row = self.free[s]
        d = self.d[j]
        for r in range(self.R):
            row[r] -= d[r]
        self._mut[s // self._BLOCK] += 1

    def give(self, s: int, j: int) -> None:
        """PS-failure rollback: the exact inverse float ops of ``take``.
        Re-raises the block bound, which may have been tightened from the
        temporarily-reduced row, so it stays a sound upper bound."""
        row = self.free[s]
        d = self.d[j]
        b = s // self._BLOCK
        env = self._benv[b]
        for r in range(self.R):
            row[r] += d[r]
            if row[r] > env[r]:
                env[r] = row[r]
        self._mut[b] += 1


class _PSCursor(_CursorPool):
    """PS-side placement.  ``_place_fast(need, ...)`` takes the ``need``
    lowest-index fitting servers per round; for the ubiquitous ``need ==
    1`` case that is exactly the cursor's first fit.  Larger requests
    (and their partial-placement rollbacks) run the same scan per
    instance with a within-call reset: one call's instances restart from
    the cursor, a sound lower bound, as ``_place_fast`` rounds restart
    from server 0."""

    def place(self, j: int, need: int) -> Optional[Dict[int, int]]:
        if need == 1:
            s = self.find(j)
            if s < 0:
                return None
            self.take(s, j)
            return {s: 1}
        # multi-instance: a _place_fast round spreads over fitting servers
        # in index order (one instance each), rounds repeat until placed
        out: Dict[int, int] = {}
        dm = self.dm[j]
        start = self.cursor[j]
        placed = 0
        while placed < need:
            round_any = False
            s = start
            while s < self.S and placed < need:
                row = self.free[s]
                for fv, dv in zip(row, dm):
                    if fv < dv:
                        break
                else:
                    self.take(s, j)
                    out[s] = out.get(s, 0) + 1
                    placed += 1
                    round_any = True
                s += 1
            if not round_any:
                for srv, cnt in out.items():
                    for _ in range(cnt):
                        self.give(srv, j)
                return None
        return out


def _emit(jids: Sequence[int], counts: List[int], H: int, K: int,
          ys: List[Optional[Dict[int, int]]],
          zs: List[Optional[Dict[int, int]]]) -> Dict[int, Placement]:
    out: Dict[int, Placement] = {}
    for i, jid in enumerate(jids):
        if counts[i] <= 0:
            continue
        y = np.zeros(H, dtype=np.int64)
        for s, c in ys[i].items():
            y[s] = c
        z = np.zeros(K, dtype=np.int64)
        if zs[i]:
            for s, c in zs[i].items():
                z[s] = c
        out[jid] = (y, z)
    return out


# ---------------------------------------------------------------------------
# DRF: progressive filling as a lazy heap over linear shares.
# ---------------------------------------------------------------------------

def drf_repack(worker_caps: np.ndarray, ps_caps: np.ndarray, pool: DensePool,
               jids: Sequence[int]) -> Dict[int, Placement]:
    """Dominant-resource progressive filling over the whole live set.

    The pick sequence replicates the reference exactly: the next job is
    the heap minimum of ``(share, arrival index)`` — the same
    first-minimum tie-break as ``min()`` over the arrival-ordered
    candidate list — its chunk goes to the cursor's first-fit server,
    and a job blocks at its first failed pick, the same turn the
    reference would block it on (failed picks mutate nothing, so
    skipping the reference's further retries is placement-identical).
    """
    n = len(jids)
    if n == 0:
        return {}
    H, K = worker_caps.shape[0], ps_caps.shape[0]
    total_w = np.maximum(worker_caps.sum(axis=0), 1e-9)
    tot_sc = tuple(float(v) for v in total_w)
    W = [pool.wres[j] for j in jids]
    Sd = [pool.sres[j] for j in jids]
    maxc = [pool.maxc[j] for j in jids]
    bw = [pool.bw[j] for j in jids]
    psbw = [pool.psbw[j] for j in jids]

    wp = _CursorPool(worker_caps, W)
    ps = _PSCursor(ps_caps, Sd)
    counts = [0] * n
    zsum = [0] * n
    shares = [0.0] * n
    ys: List[Optional[Dict[int, int]]] = [None] * n
    zs: List[Optional[Dict[int, int]]] = [None] * n
    heap = [(0.0, i) for i in range(n)]       # already heap-ordered
    blocked = [False] * n
    n_blocked = 0
    while heap and n_blocked < n:
        share, j = heapq.heappop(heap)
        if blocked[j] or share != shares[j]:
            continue                          # stale entry
        if counts[j] >= maxc[j]:
            blocked[j] = True
            n_blocked += 1
            continue
        s = wp.find(j)
        if s < 0:
            blocked[j] = True                 # no fit anywhere: blocked
            n_blocked += 1
            if _obs.ENABLED:
                _obs.inc("repack.futile_elisions")
            continue
        wp.take(s, j)
        need = _ps_for(counts[j] + 1, bw[j], psbw[j]) - zsum[j]
        if need > 0:
            z = ps.place(j, need)
            if z is None:                     # PS rollback -> job blocks
                wp.give(s, j)
                blocked[j] = True
                n_blocked += 1
                if _obs.ENABLED:
                    _obs.inc("repack.futile_elisions")
                continue
            if zs[j] is None:
                zs[j] = z
            else:
                for srv, cnt in z.items():
                    zs[j][srv] = zs[j].get(srv, 0) + cnt
            zsum[j] += need
        counts[j] += 1
        if ys[j] is None:
            ys[j] = {s: 1}
        else:
            ys[j][s] = ys[j].get(s, 0) + 1
        c = counts[j]
        # exact reference arithmetic: max(count * w_r / total_r), scalar
        # IEEE doubles == numpy elementwise
        sh = max(c * w / tw for w, tw in zip(W[j], tot_sc))
        shares[j] = sh
        heapq.heappush(heap, (sh, j))
    return _emit(jids, counts, H, K, ys, zs)


# ---------------------------------------------------------------------------
# Dorm: round-robin water filling as whole-round passes.
# ---------------------------------------------------------------------------

def dorm_repack(worker_caps: np.ndarray, ps_caps: np.ndarray, pool: DensePool,
                jids: Sequence[int]) -> Dict[int, Placement]:
    """Round-robin water filling: each round walks the still-active jobs
    in arrival order and places one chunk each; a job leaves the active
    set when it reaches its chunk count or first fails (worker or PS) —
    futile-retry elision per the module invariant.  The reference's
    no-progress termination is implied: while any job is active, every
    round makes progress."""
    n = len(jids)
    if n == 0:
        return {}
    H, K = worker_caps.shape[0], ps_caps.shape[0]
    W = [pool.wres[j] for j in jids]
    Sd = [pool.sres[j] for j in jids]
    maxc = [pool.maxc[j] for j in jids]
    bw = [pool.bw[j] for j in jids]
    psbw = [pool.psbw[j] for j in jids]

    wp = _CursorPool(worker_caps, W)
    ps = _PSCursor(ps_caps, Sd)
    counts = [0] * n
    zsum = [0] * n
    ys: List[Optional[Dict[int, int]]] = [None] * n
    zs: List[Optional[Dict[int, int]]] = [None] * n
    active = list(range(n))
    while active:
        if _obs.ENABLED:
            _obs.inc("repack.rounds")
        nxt = []
        for j in active:
            if counts[j] >= maxc[j]:
                continue                      # reached its chunk count
            s = wp.find(j)
            if s < 0:
                if _obs.ENABLED:
                    _obs.inc("repack.futile_elisions")
                continue                      # no server fits, ever again
            wp.take(s, j)
            need = _ps_for(counts[j] + 1, bw[j], psbw[j]) - zsum[j]
            if need > 0:
                z = ps.place(j, need)
                if z is None:
                    wp.give(s, j)
                    if _obs.ENABLED:
                        _obs.inc("repack.futile_elisions")
                    continue                  # PS rollback -> job is done
                if zs[j] is None:
                    zs[j] = z
                else:
                    for srv, cnt in z.items():
                        zs[j][srv] = zs[j].get(srv, 0) + cnt
                zsum[j] += need
            counts[j] += 1
            if ys[j] is None:
                ys[j] = {s: 1}
            else:
                ys[j][s] = ys[j].get(s, 0) + 1
            nxt.append(j)
        active = nxt
    return _emit(jids, counts, H, K, ys, zs)


# ---------------------------------------------------------------------------
# RRH / FIFO helpers: batched keep-allocation deduction + resume order.
# ---------------------------------------------------------------------------

def deduct_running(free: np.ndarray, allocs: List[np.ndarray],
                   demands: List[np.ndarray]) -> None:
    """``free -= sum_i alloc_i[:, None] * demand_i[None]`` as one einsum.

    Summation order differs from the reference's per-job loop only in
    float associativity (well inside the placement slack)."""
    if allocs:
        free -= np.einsum("ns,nr->sr", np.stack(allocs).astype(float),
                          np.stack(demands))


def rrh_resume_order(jobs: Sequence[Job],
                     meta: Sequence[Tuple[int, int, int, float]],
                     t: int) -> np.ndarray:
    """Payoff-density order for RRH's paused jobs: the utilities are
    Python callables (one call per job, as in the reference), but the
    sort runs once over the whole batch; ``kind="stable"`` reproduces
    ``sorted``'s tie behaviour on identical float keys."""
    dens = np.array([-job.utility(dur + (t - job.arrival)) / denom
                     for job, (nw, nps, dur, denom) in zip(jobs, meta)])
    return np.argsort(dens, kind="stable")

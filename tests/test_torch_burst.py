"""The port's batched arrival path against its sequential path and the
JAX package's.

* **A burst decided together.**  ``OASiS(core="tiled").on_arrivals`` —
  the speculative ``decide_burst`` pass, then commits, re-solving through
  each job's ``RowCache`` once prices moved — equals the port's own
  ``on_arrival`` one job at a time and the reference's ``impl="jax"``
  batched run, bit for bit, on the instance of
  ``tests/test_fused_engine.py::
  test_on_arrivals_burst_equals_sequential_full_size_jobs`` (T=60,
  40+40 servers, 100 full-size jobs, seed 0, quantum 0): accepted set,
  finish slots, every placement and the total utility.
* **Lanes.**  ``decide_burst`` with B lanes a launch equals B one-lane
  launches: decision, payoff, the rows of every visited tile, the cost
  columns and the materialized schedule.
* **The batched chain tile.**  ``ops.minplus_chain`` over (B, n, DC+1)
  lanes on the CPU (the plain version) equals ``minplus_tile`` lane by
  lane, also when the lanes are rows of larger tables.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import jax_shims  # noqa: F401  (fixture)
from repro.core import OASiS as RefOASiS
from repro.core import price_params_from_jobs as ref_params
from repro.sim import make_cluster as ref_make_cluster
from repro.sim import make_jobs as ref_make_jobs
from repro.sim.engine import _with_quantum as ref_with_quantum
from repro_torch import compat
from repro_torch.core import schedule_torch as st
from repro_torch.core.oasis import OASiS
from repro_torch.core.pricing import PriceState, price_params_from_jobs
from repro_torch.kernels.minplus import ops
from repro_torch.kernels.minplus.tiled import TILE, minplus_tile
from repro_torch.sim import engine
from repro_torch.sim.workload import make_cluster, make_jobs


def _bits(a, b):
    a = np.atleast_1d(np.asarray(a, np.float64))
    b = np.atleast_1d(np.asarray(b, np.float64))
    return a.shape == b.shape and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


def _same_trajectory(got, want):
    assert set(got.accepted) == set(want.accepted)
    assert got.total_utility == want.total_utility
    for jid, w in want.accepted.items():
        g = got.accepted[jid]
        assert g.finish == w.finish, jid
        assert sorted(g.workers) == sorted(w.workers), jid
        for t in w.workers:
            assert np.array_equal(g.workers[t], w.workers[t]), (jid, t)
            assert np.array_equal(g.ps[t], w.ps[t]), (jid, t)


def test_on_arrivals_burst_equals_sequential_and_jax(jax_shims):
    T, H, K = 60, 40, 40
    rcluster = ref_make_cluster(T=T, H=H, K=K)
    rjobs = [ref_with_quantum(j, 0)
             for j in ref_make_jobs(100, T=T, seed=0, small=False)]
    rparams = ref_params(rjobs, rcluster)
    by_slot = {}
    for j in rjobs:
        by_slot.setdefault(j.arrival, []).append(j)
    bursts = [sorted(by_slot.get(t, []), key=lambda x: x.jid)
              for t in range(T)]
    assert max(len(b) for b in bursts) >= 2

    ref = RefOASiS(rcluster, rparams, impl="jax")
    for burst in bursts:
        ref.on_arrivals(burst)

    cluster, params = compat.cluster(rcluster), compat.price_params(rparams)
    seq = OASiS(cluster, params, device="cpu", core="tiled")
    for j in sorted(rjobs, key=lambda x: (x.arrival, x.jid)):
        seq.on_arrival(compat.job(j))
    st.monotone_counters_reset()
    bat = OASiS(cluster, params, device="cpu", core="tiled")
    for burst in bursts:
        bat.on_arrivals([compat.job(j) for j in burst])
    snap = st.monotone_counters_snapshot()

    _same_trajectory(bat, seq)
    _same_trajectory(bat, ref)
    assert len(bat.decision_seconds) == len(rjobs)
    assert np.array_equal(bat.state._g_host, ref.state._g_host)
    # the bursts ran speculatively, and some jobs were re-solved through
    # their row caches (a one-tile horizon: every commit dirties it)
    assert snap["speculative"] > 0 and snap["resolves"] > 0
    assert snap["decisions"] == snap["speculative"] + snap["resolves"] + (
        len(rjobs) - snap["speculative"])


def _state_with_commits(T=130, H=6, K=6, n=24, seed=4, small=True):
    cluster = make_cluster(T=T, H=H, K=K)
    jobs = [engine._with_quantum(j, 0)
            for j in make_jobs(n, T=T, seed=seed, small=small)]
    state = PriceState(cluster, price_params_from_jobs(jobs, cluster),
                       device="cpu")
    for j in sorted(jobs, key=lambda x: (x.arrival, x.jid))[:n // 2]:
        s = st.best_schedule_fused(j, state, core="tiled")
        if s is not None:
            state.commit(j, s.workers, s.ps)
    return state, sorted(jobs, key=lambda x: x.jid)[n // 2:]


@pytest.mark.parametrize("lanes", [2, 4, 8])
@pytest.mark.parametrize("small", [True, False])
def test_lanes_equal_single_lane_runs(monkeypatch, lanes, small):
    state, jobs = _state_with_commits(small=small)
    monkeypatch.setenv("REPRO_BURST_LANES", "1")
    one = st.decide_burst(jobs, state)
    monkeypatch.setenv("REPRO_BURST_LANES", str(lanes))
    st.monotone_counters_reset()
    many = st.decide_burst(jobs, state)
    snap = st.monotone_counters_snapshot()
    groups = {}
    for j in jobs:
        groups.setdefault(st._shape_bucket(j), []).append(j)
    assert snap["launches"] == sum(-(-len(g) // lanes)
                                   for g in groups.values())
    assert snap["speculative"] == snap["decisions"] == len(jobs)
    accepts = 0
    for job, p1, pb in zip(jobs, one, many):
        assert p1.best_t == pb.best_t, job.jid
        assert _bits(p1.payoff, pb.payoff)
        v1 = p1.cache.valid
        assert np.all(pb.cache.valid[v1])           # visits a superset
        for k in np.flatnonzero(v1):
            sl = slice(k * TILE, (k + 1) * TILE)
            assert torch.equal(p1.rows_full[p1.lane, sl],
                               pb.rows_full[pb.lane, sl]), (job.jid, k)
        if p1.best_t >= 0:
            accepts += 1
            a, d = job.arrival, job.workload
            assert torch.equal(p1.cost_full[p1.lane, a:p1.best_t + 1, :d + 1],
                               pb.cost_full[pb.lane, a:pb.best_t + 1, :d + 1])
            s1, sb = st._materialize(p1, state), st._materialize(pb, state)
            assert s1.cost == sb.cost and s1.finish == sb.finish
            for t in s1.workers:
                assert np.array_equal(s1.workers[t], sb.workers[t])
                assert np.array_equal(s1.ps[t], sb.ps[t])
    assert accepts > 0


def test_burst_groups_timings_and_batch():
    """decide_burst groups by shape bucket, rejects dcap-0 jobs without
    solving, shares each group's wall time among its jobs, and its
    candidates, materialized at the same prices, place what
    best_schedule_fused would."""
    state, jobs = _state_with_commits(small=False, n=20)
    jobs = jobs + [engine._with_quantum(j, 0) for j in make_jobs(
        1, T=130, seed=9, small=True)]
    jobs[-1] = dataclasses.replace(jobs[-1], epochs=0)
    assert st._shape_bucket(jobs[-1]) is None
    times = []
    pends = st.decide_burst(jobs, state, timings=times)
    assert pends[-1] is None and times[-1] == 0.0
    assert len(times) == len(jobs) and all(t > 0 for t in times[:-1])
    assert len({st._shape_bucket(j) for j in jobs[:-1]}) > 1
    for job, pend in zip(jobs, pends):
        got = None if pend is None else st._materialize(pend, state)
        want = st.best_schedule_fused(job, state, core="tiled")
        assert (got is None) == (want is None)
        if want is not None:
            assert got.cost == want.cost and got.finish == want.finish
            for t in want.workers:
                assert np.array_equal(got.workers[t], want.workers[t])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,dc1,d1", [(1, 17, 65, 300), (3, 64, 64, 1280),
                                        (8, 5, 640, 1280), (5, 33, 17, 33)])
def test_batched_chain_tile_equals_minplus_tile(B, n, dc1, d1, dtype):
    rng = np.random.default_rng(B * n + dc1)
    rows = np.round(rng.random((B, n + 3, dc1)) * 8) / 8
    rows[rng.random(rows.shape) < 0.2] = np.inf
    rows[..., 0] = 0.0
    prev = np.round(rng.random((B, 2, d1)) * 8) / 8
    prev[rng.random(prev.shape) < 0.3] = np.inf
    rows_t = torch.tensor(rows, dtype=dtype)[:, 2:n + 2]   # lane views
    prev_t = torch.tensor(prev, dtype=dtype)[:, 1]
    table = torch.full((B, n + 6, d1), float("nan"), dtype=dtype)
    out = ops.minplus_chain(rows_t, prev_t, table[:, 3:n + 3])
    assert out.shape == (B, n, d1)
    for b in range(B):
        _, cols = minplus_tile(rows_t[b][:, None, :], prev_t[b][None])
        assert _bits(table[b, 3:n + 3].numpy(), cols[:, 0].numpy()), b
        one = torch.empty((n, d1), dtype=dtype)
        ops.minplus_chain(rows_t[b], prev_t[b], one)
        assert _bits(one.numpy(), cols[:, 0].numpy())
    assert torch.isnan(table[:, :3]).all() and torch.isnan(
        table[:, n + 3:]).all()


def test_engine_tiled_runs_bursts_whole_does_not():
    cluster = make_cluster(T=40, H=6, K=6)
    jobs = make_jobs(40, T=40, seed=5, small=True)
    st.monotone_counters_reset()
    tiled = engine.run(cluster, jobs, device="cpu", quantum=0, core="tiled")
    snap = st.monotone_counters_snapshot()
    assert snap["speculative"] > 0
    assert tiled.accepted > 0 and len(tiled.decision_seconds) == len(jobs)
    st.monotone_counters_reset()
    osched = OASiS(cluster, price_params_from_jobs(jobs, cluster),
                   device="cpu", core="whole")
    osched.on_arrivals([j for j in jobs if j.arrival == jobs[0].arrival])
    assert st.monotone_counters_snapshot()["decisions"] == 0

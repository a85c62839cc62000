"""The port's tiled early-exit decision route against the JAX package.

* **The core, on shared rows.**  ``schedule_torch._decide_tiled_core``
  and the reference's ``_decide_tiled`` (float64, one lane) run on the
  same padded price state and the same COST rows — the port's rows, fed
  to the reference through its row cache with every tile valid.  Best
  slot, payoff, visited tiles, per-branch tile counts, every live DP
  column and the banded backtrack's split must agree bit for bit.  (The
  rows themselves are not shared bit for bit otherwise: on a CPU with FMA XLA
  contracts the multiply-adds of the unit prices and greedy costs into
  fused multiply-adds and evaluates ``exp`` with its own polynomial, so
  its rows differ from PyTorch's in the last ulps.)
* **Each decision, end to end.**  ``best_schedule_fused(core="tiled")``
  against the reference's ``best_schedule_fused`` on the same evolving
  states: accept/reject, finish slot, the per-slot placements of every
  server, and the cost to rel 1e-12 (the last-ulp row difference above).
  Both the plateau branch (m_pad 64) and the chain branch (m_pad >= 128)
  run, and a job the live cost floor rejects before its first tile.
* **Trajectories.**  ``engine.run(core="tiled")`` on the CPU equals the
  reference ``impl="fast"`` exactly on the paper-scale seeds 0 and 2,
  with the plateau branch firing, and the reference's tiled route
  ``impl="jax"`` exactly on a full-size instance (T=100, 20+20 servers,
  40 full-size jobs, seed 1), where ``impl="fast"`` differs from both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_shims  # noqa: F401  (fixture)
from repro.core import price_params_from_jobs
from repro.core import schedule_jax as sj
from repro.core.pricing import PriceState as RefPriceState
from repro.core.types import SigmoidUtility as RefSigmoid
from repro.sim import make_cluster, make_jobs, simulate
from repro.sim.engine import _with_quantum as ref_with_quantum
from repro_torch import compat
from repro_torch.core import schedule_torch as st
from repro_torch.core.oasis import OASiS
from repro_torch.core.pricing import PriceState
from repro_torch.kernels.minplus.tiled import TILE
from repro_torch.sim import engine, workload


def _bits(a, b):
    a = np.atleast_1d(np.asarray(a, np.float64))
    b = np.atleast_1d(np.asarray(b, np.float64))
    return a.shape == b.shape and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


def _core_parity(job, rjob, state, ref_state):
    """Run both tiled cores on the port's rows; returns the port's
    (best_t, k0, k_end, paths)."""
    m_pad, d1 = st._shape_bucket(job)
    T = state.horizon
    T_pad = st._pad_tiles(T)
    psd = st._padded_state(state, torch.float64, T_pad)
    lane, _ = st._job_arrays_tiled(job, T, T_pad, m_pad)
    jd = st._stack_lanes([lane], T, torch.float64, state.device)
    mono = 1 if m_pad <= st.MONO_BAND else 0
    out = st._decide_tiled_core(psd, jd, T=T, d1=d1, mono=mono)
    best_t, pay, rows, cost = int(out.best_t[0]), out.payoff[0], \
        out.rows[0], out.cost[0]
    k0, k_end, paths, live = out.k0, out.k_end, out.paths, out.live
    full = torch.cat([st._tile_rows(psd[0], jd, t0)[0]
                      for t0 in range(0, T_pad, TILE)])
    assert torch.equal(rows[k0 * TILE:k_end * TILE],
                       full[k0 * TILE:k_end * TILE])
    with jax.enable_x64(True):
        sd = tuple(jnp.asarray(x.numpy()) for x in psd[0])
        lane, _ = sj._job_arrays_tiled(rjob, ref_state, T, T_pad, m_pad,
                                       jnp.float64)
        out = sj._decide_tiled(
            sd, sj._stack_lanes([lane], jnp.float64),
            sj._dummy_tabs("float64"), jnp.asarray(full.numpy())[None],
            jnp.ones((1, T_pad // TILE), bool), T=T, d1=d1, use_cache=True,
            mono=mono, use_tabs=False)
        j_best_t, j_pay, j_rows, j_cost, j_k0, j_kend, j_paths = \
            jax.device_get(out)
    assert int(j_best_t[0]) == best_t
    assert _bits(j_pay[0], pay)
    assert (int(j_k0), int(j_kend)) == (k0, k_end)
    assert list(np.asarray(j_paths)) == paths
    lo, hi = max(job.arrival, k0 * TILE), min(T, k_end * TILE)
    assert sum(live) == max(hi - lo, 0)
    assert [n > 0 for n in live] == [n > 0 for n in paths]
    assert _bits(cost[lo:hi].numpy(), j_cost[0, lo:hi])
    if best_t >= 0:
        a, d_tot = job.arrival, job.workload
        with jax.enable_x64(True):
            j_total, j_left, j_slots = jax.device_get(sj._backtrack(
                jnp.asarray(j_rows[0]), jnp.asarray(j_cost[0]),
                jnp.int32(best_t), jnp.int32(d_tot), jnp.int32(k0 * TILE)))
        d_left, d_slots = st._backtrack(
            rows[a:best_t + 1].numpy(),
            cost[a:best_t, :d_tot + 1].numpy(), a, best_t, d_tot)
        assert d_left == int(j_left) == 0
        assert np.array_equal(d_slots, np.asarray(j_slots)[:best_t + 1])
        assert _bits(cost[best_t, d_tot].numpy(), j_total)
    return best_t, k0, k_end, paths


def _same_schedule(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert got.finish == want.finish
    assert got.utility == want.utility
    assert got.cost == pytest.approx(want.cost, rel=1e-12, abs=0)
    assert sorted(got.workers) == sorted(want.workers)
    for t in want.workers:
        assert np.array_equal(got.workers[t], want.workers[t]), t
        assert np.array_equal(got.ps[t], want.ps[t]), t


def _states(cluster, jobs):
    params = price_params_from_jobs(jobs, cluster)
    return (PriceState(compat.cluster(cluster), compat.price_params(params),
                       device="cpu"),
            RefPriceState(cluster, params))


INSTANCES = {
    # small jobs: every band is 64 wide, so the plateau branch runs
    "plateau": (dict(T=100, H=10, K=10), dict(n=30, seed=3, small=True)),
    # full-size jobs: bands of 64..384, mostly through the chain branch
    "chain": (dict(T=100, H=20, K=20), dict(n=10, seed=1, small=False)),
}


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_tiled_decisions_equal_jax(jax_shims, name):
    ckw, jkw = INSTANCES[name]
    cluster = make_cluster(**ckw)
    jobs = make_jobs(jkw["n"], T=ckw["T"], seed=jkw["seed"],
                     small=jkw["small"])
    state, ref_state = _states(cluster, jobs)
    branches = [0, 0, 0]
    accepts = 0
    for rjob in sorted(jobs, key=lambda j: (j.arrival, j.jid)):
        rjob = ref_with_quantum(rjob, 0)
        job = compat.job(rjob)
        _, _, _, paths = _core_parity(job, rjob, state, ref_state)
        branches = [x + y for x, y in zip(branches, paths)]
        got = st.best_schedule_fused(job, state, core="tiled")
        with jax.enable_x64(True):
            want = sj.best_schedule_fused(rjob, ref_state, use_pallas=False)
        _same_schedule(got, want)
        if got is not None:
            accepts += 1
            state.commit(job, got.workers, got.ps)
            ref_state.commit(rjob, got.workers, got.ps)
    assert accepts > 0
    if name == "plateau":
        assert branches[1] > 0
    else:
        assert branches[2] > 0
    assert np.array_equal(state._g_host, ref_state._g_host)


def test_floor_rejects_before_first_tile(jax_shims):
    """A job worth less than the live cost floor is rejected without
    visiting a tile, by both cores."""
    cluster = make_cluster(T=100, H=10, K=10)
    jobs = make_jobs(30, T=100, seed=3, small=True)
    state, ref_state = _states(cluster, jobs)
    for rjob in sorted(jobs, key=lambda j: (j.arrival, j.jid))[:12]:
        rjob = ref_with_quantum(rjob, 0)
        got = st.best_schedule_fused(compat.job(rjob), state, core="tiled")
        if got is not None:
            state.commit(compat.job(rjob), got.workers, got.ps)
            ref_state.commit(rjob, got.workers, got.ps)
    rjob = dataclasses.replace(ref_with_quantum(jobs[-1], 0),
                               utility=RefSigmoid(1e-9, 0.0, 1.0))
    best_t, k0, k_end, paths = _core_parity(compat.job(rjob), rjob, state,
                                            ref_state)
    assert best_t == -1 and k_end == k0 and paths == [0, 0, 0]
    st.monotone_counters_reset()
    assert st.best_schedule_fused(compat.job(rjob), state,
                                  core="tiled") is None
    snap = st.monotone_counters_snapshot()
    assert snap["slots"] == 0 and snap["decisions"] == 1


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_tiled_trajectory_equals_fast_paper_scale(seed):
    want = simulate(make_cluster(T=100, H=50, K=50),
                    make_jobs(200, T=100, seed=seed, small=True),
                    scheduler="oasis", impl="fast", quantum=0)
    st.monotone_counters_reset()
    got = engine.run(workload.make_cluster(T=100, H=50, K=50),
                     workload.make_jobs(200, T=100, seed=seed, small=True),
                     device="cpu", quantum=0, core="tiled")
    snap = st.monotone_counters_snapshot()
    assert got.accepted == want.accepted
    assert got.completion == want.completion
    assert got.total_utility == want.total_utility
    assert got.device_uploads == 1
    # every job decided once (a burst's speculatively), plus the re-solves
    # of the bursts' jobs after an earlier commit
    assert snap["plateau"] > 0
    assert snap["decisions"] == 200 + snap["resolves"]
    assert 0 < snap["speculative"] <= 200


def test_tiled_trajectory_equals_jax_full_size(jax_shims):
    cluster = make_cluster(T=100, H=20, K=20)
    jobs = make_jobs(40, T=100, seed=1)
    want = simulate(cluster, jobs, scheduler="oasis", impl="jax", quantum=0)
    fast = simulate(cluster, jobs, scheduler="oasis", impl="fast", quantum=0)
    st.monotone_counters_reset()
    got = engine.run(workload.make_cluster(T=100, H=20, K=20),
                     workload.make_jobs(40, T=100, seed=1), device="cpu",
                     quantum=0, core="tiled")
    snap = st.monotone_counters_snapshot()
    assert got.accepted == want.accepted
    assert got.completion == want.completion
    assert got.total_utility == want.total_utility
    assert fast.total_utility != want.total_utility
    assert snap["plateau"] > 0 and snap["chain"] > 0


def test_core_choice_is_checked():
    cluster = workload.make_cluster(T=10, H=2, K=2)
    jobs = workload.make_jobs(3, T=10, seed=0, small=True)
    with pytest.raises(ValueError, match="core"):
        engine.run(cluster, jobs, device="cpu", core="bogus")
    params = engine.price_params_from_jobs(jobs, cluster)
    with pytest.raises(ValueError, match="core"):
        OASiS(cluster, params, device="cpu", core="pallas")
    state = PriceState(cluster, params, device="cpu")
    with pytest.raises(ValueError, match="core"):
        st.best_schedule_fused(jobs[0], state, core="sweep")


def test_padded_state_follows_versions():
    """The padded state is computed once per price-state version and
    again after a commit or a write to the host mirror."""
    cluster = workload.make_cluster(T=70, H=3, K=3)
    jobs = workload.make_jobs(6, T=70, seed=0, small=True)
    state = PriceState(cluster, engine.price_params_from_jobs(jobs, cluster),
                       device="cpu")
    first = st._padded_state(state, torch.float64, 128)
    assert st._padded_state(state, torch.float64, 128) is first
    assert first[0][0].shape[0] == 128 and first[1].shape == (128, 5)
    v0 = state.version
    state.commit(jobs[0], {3: np.array([1, 0, 0])}, {})
    assert state.version == v0 + 1
    second = st._padded_state(state, torch.float64, 128)
    assert second is not first and not torch.equal(first[0][9], second[0][9])
    state.g[5, 0, 0] += 1.0
    assert st._padded_state(state, torch.float64, 128) is not second

"""The float32 route (``precision="x32"``, the reference's TPU precision)
on both decision cores against the JAX package's float32 route.

* **(i) Shared rows.**  The port's float32 tiled core and the reference's
  ``_decide_tiled`` in float32 on the port's rows (through its row
  cache), at monotone levels 0, 1 and 2: best slot, payoff, visited
  tiles, tile counts, every live DP column and the backtrack bit for bit.
* **(ii) Decision by decision.**  ``best_schedule_fused(precision="x32")``
  on both routes against the reference's float32 routes (tiled;
  ``use_pallas=True``, the Pallas sweep in interpret mode, for the whole
  route) on the paper seeds 0..4, each side committing its own decisions
  to its own state: accept and finish slot must agree.  The reference
  prices in float32 with XLA's ``exp`` where the port rounds numpy's
  float64 prices, so the rows differ in the last ulps and a float32
  near-tie may flip; a disagreement is allowed only where the port's own
  float32 payoffs at the two finish slots are within 4 ulps of each
  other, and the seed's comparison stops there.
* **(iii) Residency.**  The float32 residency equals the reference's bit
  for bit across 300 commits (past the resync at 256) and a release.
* **(iv) The default.**  ``"auto"`` is float64: its trajectories equal
  ``"x64"``'s and the reference's ``impl="fast"`` exactly.
* **(v) Refusal.**  An unknown precision raises.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import jax_shims, one_torch_thread  # noqa: F401
from repro.core import schedule_jax as sj
from repro.sim import make_cluster, make_jobs, simulate
from repro.sim.engine import _with_quantum as ref_with_quantum
from repro_torch import compat
from repro_torch.core import schedule_torch as st
from repro_torch.core.oasis import OASiS
from repro_torch.sim import engine, workload
from test_torch_monotone import core_parity, states

ULPS = 4


@pytest.mark.parametrize("name,mono", [("plateau", 1), ("dnc", 2),
                                       ("chain", 0)])
def test_core_x32_equals_jax_on_shared_rows(jax_shims, name, mono):
    """(i): paper-scale small jobs (m_pad 64) at levels 1 and 2, and
    full-size jobs (m_pad 64..384) through the chain; each float32 accept
    committed to both states."""
    if name == "chain":
        cluster, jobs = make_cluster(T=100, H=20, K=20), make_jobs(
            10, T=100, seed=1)
    else:
        cluster, jobs = make_cluster(T=100, H=50, K=50), make_jobs(
            200, T=100, seed=0, small=True)
    state, ref_state = states(cluster, jobs)
    totals, accepts = [0, 0, 0], 0
    order = sorted(jobs, key=lambda j: (j.arrival, j.jid))[:30]
    for rjob in order:
        rjob = ref_with_quantum(rjob, 0)
        job = compat.job(rjob)
        level = mono if st._shape_bucket(job)[0] <= st.MONO_BAND else 0
        _, _, _, paths = core_parity(job, rjob, state, ref_state,
                                     torch.float32, level)
        totals = [x + y for x, y in zip(totals, paths)]
        got = st.best_schedule_fused(job, state, core="tiled",
                                     precision="x32")
        if got is not None:
            accepts += 1
            state.commit(job, got.workers, got.ps)
            ref_state.commit(rjob, got.workers, got.ps)
    assert accepts > 0
    assert totals[{"plateau": 1, "dnc": 0, "chain": 2}[name]] > 0


def _port_payoffs32(job, state):
    """The port's float32 payoff at every slot of the horizon (-inf where
    infeasible or before arrival): the tiled core with its early exit
    held open, so that every slot's DP column is computed."""
    m_pad, d1 = st._shape_bucket(job)
    T = state.horizon
    T_pad = st._pad_tiles(T)
    psd = st._padded_state(state, torch.float32, T_pad)
    lane, _ = st._job_arrays_tiled(job, T, T_pad, m_pad)
    jd = st._stack_lanes([lane], T, torch.float32, state.device)
    jd = jd._replace(usmax=np.full_like(jd.usmax, np.inf))
    out = st._decide_tiled_core(psd, jd, T=T, d1=d1, mono=0)
    cost = out.cost[0, :T, job.workload].numpy()
    pay = np.full(T, -np.inf, np.float32)
    live = np.isfinite(cost) & (np.arange(T) >= job.arrival)
    pay[live] = jd.u[0, :T][live] - cost[live]
    return pay


def _near_tie(job, state, got, want):
    """Whether the port's float32 payoffs at the two decisions' finish
    slots (0 for a reject) are within ``ULPS`` ulps of each other."""
    pay = _port_payoffs32(job, state)
    a = np.float32(0.0) if got is None else pay[got.finish]
    b = np.float32(0.0) if want is None else pay[want.finish]
    if not (np.isfinite(a) and np.isfinite(b)):
        return False
    return abs(float(a) - float(b)) <= ULPS * float(
        np.spacing(np.float32(max(abs(a), abs(b)))))


@pytest.mark.parametrize("core", ["tiled", "whole"])
def test_x32_decisions_equal_jax_x32(jax_shims, core):
    """(ii) on the paper seeds 0..4."""
    flips = []
    for seed in range(5):
        cluster = make_cluster(T=100, H=50, K=50)
        jobs = make_jobs(200, T=100, seed=seed, small=True)
        state, ref_state = states(cluster, jobs)
        accepts = 0
        order = sorted(jobs, key=lambda j: (j.arrival, j.jid))
        for i, rjob in enumerate(order):
            rjob = ref_with_quantum(rjob, 0)
            job = compat.job(rjob)
            got = st.best_schedule_fused(job, state, core=core,
                                         precision="x32")
            with jax.enable_x64(False):
                want = sj.best_schedule_fused(
                    rjob, ref_state, use_pallas=core == "whole",
                    precision="x32")
            if (got is None) != (want is None) or (
                    got is not None and got.finish != want.finish):
                assert _near_tie(job, state, got, want), (seed, i)
                flips.append((seed, i))
                break
            if got is not None:
                accepts += 1
                state.commit(job, got.workers, got.ps)
                ref_state.commit(rjob, want.workers, want.ps)
        assert accepts > 0
    # every near-tie flip is named in CHANGES.md; none on these seeds
    assert flips == []


def test_x32_residency_equals_jax(jax_shims):
    """(iii): random commits fetched after each, as the decision loop
    does, past the float32 resync at 256 commits, then a release."""
    from test_torch_pricing import _alloc, _job_pair, _states
    state, ref = _states()
    rng = np.random.default_rng(9)
    T, H, K = state.cluster.T, state.cluster.H, state.cluster.K
    committed = []

    def same():
        g, v = state.device_state(torch.float32)[:2]
        with jax.enable_x64(False):
            rg, rv = ref.device_state(np.float32)[:2]
        return (g.dtype == torch.float32
                and np.array_equal(g.numpy().view(np.uint32),
                                   np.asarray(rg).view(np.uint32))
                and np.array_equal(v.numpy().view(np.uint32),
                                   np.asarray(rv).view(np.uint32)))

    assert same()
    for i in range(300):
        wres = rng.uniform(0, 0.02, 5)
        sres = rng.uniform(0, 0.02, 5)
        sres[0] = 0.0
        job, rjob = _job_pair(i, wres, sres)
        workers = _alloc(rng, T, H, int(rng.integers(1, T)))
        ps = _alloc(rng, T, K, int(rng.integers(1, T)))
        state.commit(job, workers, ps)
        ref.commit(rjob, workers, ps)
        committed.append((job, rjob, workers, ps))
        assert same(), i
    assert state.device_uploads >= 2          # the cadence resync ran
    job, rjob, workers, ps = committed[17]
    state.release(job, workers, ps)
    ref.release(rjob, workers, ps)
    assert same()
    g = state.device_state(torch.float32)[0]
    assert torch.equal(g, torch.tensor(state._g_host, dtype=torch.float32))


@pytest.mark.parametrize("core", ["whole", "tiled"])
def test_auto_is_float64(core):
    """(iv): the default's trajectory is ``"x64"``'s and the reference's
    ``impl="fast"``, and it decides in float64 (the default's float64
    pins at paper scale and 10x are the other test files')."""
    want = simulate(make_cluster(T=60, H=12, K=12),
                    make_jobs(40, T=60, seed=3, small=True),
                    scheduler="oasis", impl="fast", quantum=0)
    runs = [engine.run(workload.make_cluster(T=60, H=12, K=12),
                       workload.make_jobs(40, T=60, seed=3, small=True),
                       device="cpu", quantum=0, core=core, precision=p)
            for p in ("auto", "x64")]
    for got in runs:
        assert got.completion == want.completion
        assert got.total_utility == want.total_utility
        assert got.device_uploads == 1
    assert st.route_dtype("auto") == st.route_dtype("x64") == torch.float64
    assert st.route_dtype("x32") == torch.float32


def test_batch_equals_one_at_a_time():
    """``best_schedule_fused_batch`` at one state equals each job's
    ``best_schedule_fused`` there, in both precisions."""
    cluster = workload.make_cluster(T=60, H=8, K=8)
    jobs = workload.make_jobs(10, T=60, seed=4, small=True)
    osched = OASiS(cluster, engine.price_params_from_jobs(jobs, cluster),
                   device="cpu", core="tiled")
    osched.on_arrivals(jobs[:4])
    for precision in ("x64", "x32"):
        batch = st.best_schedule_fused_batch(jobs[4:], osched.state,
                                             precision=precision)
        for job, got in zip(jobs[4:], batch):
            want = st.best_schedule_fused(job, osched.state, core="tiled",
                                          precision=precision)
            assert (got is None) == (want is None)
            if got is not None:
                assert got.finish == want.finish and got.cost == want.cost
                for t in want.workers:
                    assert np.array_equal(got.workers[t], want.workers[t])
                    assert np.array_equal(got.ps[t], want.ps[t])


def test_x32_engine_runs_on_both_routes():
    """``engine.run``/``run_stream(precision="x32")`` reach the float32
    route: the residency is float32 and every decision is made."""
    cluster = workload.make_cluster(T=40, H=6, K=6)
    jobs = workload.make_jobs(16, T=40, seed=1, small=True)
    for core in ("whole", "tiled"):
        res = engine.run(cluster, jobs, device="cpu", quantum=0, core=core,
                         precision="x32")
        assert res.accepted > 0 and len(res.decision_seconds) == 16
    osched = OASiS(cluster, engine.price_params_from_jobs(jobs, cluster),
                   device="cpu", core="tiled", precision="x32")
    osched.on_arrivals(jobs[:6])
    assert osched.state._dev_dtype == torch.float32
    import itertools
    res = engine.run_stream(cluster, itertools.islice(
        workload.stream_jobs(rate=0.5, seed=1, small=True), 12), window=16,
        device="cpu", precision="x32")
    assert res.n_jobs == 12 and res.accepted > 0


@pytest.mark.parametrize("bad", ["x16", "fp32", "", "X32"])
def test_unknown_precision_raises(bad):
    """(v)."""
    cluster = workload.make_cluster(T=10, H=2, K=2)
    jobs = workload.make_jobs(3, T=10, seed=0, small=True)
    params = engine.price_params_from_jobs(jobs, cluster)
    with pytest.raises(ValueError, match="precision"):
        OASiS(cluster, params, device="cpu", precision=bad)
    with pytest.raises(ValueError, match="precision"):
        engine.run(cluster, jobs, device="cpu", precision=bad)
    state = OASiS(cluster, params, device="cpu").state
    for core in ("whole", "tiled"):
        with pytest.raises(ValueError, match="precision"):
            st.best_schedule_fused(jobs[0], state, core=core,
                                   precision=bad)
    with pytest.raises(ValueError, match="precision"):
        st.decide_burst(jobs, state, precision=bad)
    with pytest.raises(ValueError, match="precision"):
        st.best_schedule_fused_batch(jobs, state, precision=bad)

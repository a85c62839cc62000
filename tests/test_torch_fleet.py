"""Fleet churn and cancellations on the port against the JAX package.

* ``repro_torch.sim.fleet`` draws the reference's traces field by field
  (``churn_trace``, ``make_fleet_trace``) and folds them as its
  ``FleetState`` does;
* ``PriceState.block_server`` / ``unblock_server`` invert bit for bit,
  on the host mirror and on the device residency, from any state;
* ``engine.run`` under churn (and churn with cancellations) equals the
  reference's ``impl="fast"`` exactly on the whole route (accepted,
  completions, utility, preemption counters, utilization, live
  fraction), and on the tiled route has the completions of the
  reference's tiled engine (``impl="jax"``) and its utility within rel
  1e-9;
* an empty ``FleetTrace()`` is an exact no-op, episodic and streamed.
"""
import itertools

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.sim import engine as ref_engine
from repro.sim import fleet as ref_fleet
from repro.sim import make_cluster, make_jobs
from repro.sim.scenarios import cancellation_trace
from repro_torch import compat
from repro_torch.core.pricing import PriceState, price_params_from_jobs
from repro_torch.core.schedule_torch import best_schedule_fused
from repro_torch.core.types import ClusterSpec, Job, SigmoidUtility
from repro_torch.sim import engine, fleet, workload

from _torch_parity import jax_shims, one_torch_thread  # noqa: F401

_RESULT_FIELDS = ("accepted", "completed", "completion", "total_utility",
                  "preempted", "preempt_dropped", "canceled", "utilization",
                  "live_frac")


def _events(trace):
    return [(e.slot, e.kind, e.pool, e.server) for e in trace.events]


@pytest.mark.parametrize("frac,seed,T", [(0.05, 1, None), (0.2, 1, None),
                                         (0.25, 2, None), (0.25, 2, 200),
                                         (0.5, 7, 2000)])
def test_churn_trace_matches_reference(frac, seed, T):
    ref_c = make_cluster(T=100, H=40, K=40)
    c = workload.make_cluster(T=100, H=40, K=40)
    want = ref_fleet.churn_trace(ref_c, frac=frac, seed=seed, T=T)
    got = fleet.churn_trace(c, frac=frac, seed=seed, T=T)
    assert _events(got) == _events(want) and got.slots == want.slots
    assert _events(compat.fleet_trace(want)) == _events(want)


@pytest.mark.parametrize("kw", [
    {}, {"seed": 3, "mtbf": 50.0, "mttr": 8.0},
    {"seed": 1, "drain_every": 15, "drain_frac": 0.25, "include_ps": False},
    {"seed": 2, "mtbf": 80.0, "class_mtbf": {1: 20.0},
     "class_mttr": {0: 3.0}, "drain_every": 30}])
def test_make_fleet_trace_matches_reference(kw):
    ref_c = make_cluster(T=120, H=10, K=10)
    c = workload.make_cluster(T=120, H=10, K=10)
    want = ref_fleet.make_fleet_trace(ref_c, **kw)
    got = fleet.make_fleet_trace(c, **kw)
    assert _events(got) == _events(want)


def test_fleet_state_matches_reference():
    """Per-slot transitions, down servers, effective capacities and the
    live fraction, slot by slot, over a trace with failures and drains."""
    ref_c = make_cluster(T=120, H=10, K=10)
    c = workload.make_cluster(T=120, H=10, K=10)
    kw = dict(seed=4, mtbf=60.0, mttr=10.0, drain_every=20, drain_frac=0.3)
    want = ref_fleet.FleetState(ref_c, ref_fleet.make_fleet_trace(ref_c, **kw))
    got = fleet.FleetState(c, fleet.make_fleet_trace(c, **kw))
    assert got.event_slots == want.event_slots
    for t in range(120):
        assert got.step(t) == want.step(t), t
        assert got.down_servers() == want.down_servers(), t
        assert np.array_equal(got.worker_caps, want.worker_caps)
        assert np.array_equal(got.ps_caps, want.ps_caps)
        assert got.live_frac == want.live_frac


def test_empty_trace_is_falsy():
    assert not fleet.FleetTrace()
    assert fleet.FleetTrace((fleet.FleetEvent(3, "fail", "worker", 0),))


# ---------------------------------------------------------------------------
# server blocking on the price state
# ---------------------------------------------------------------------------

def _populated_state(seed, T=16, H=3, K=3, n=5, small=True, window=None):
    """A port price state with a residency, after committing every job of
    a seeded trace that the whole route accepts."""
    cluster = workload.make_cluster(T=T, H=H, K=K)
    jobs = workload.make_jobs(n, T=T, seed=seed, small=small)
    state = PriceState(cluster, price_params_from_jobs(jobs, cluster),
                       device="cpu", window=window)
    state.device_state()
    committed = []
    for j in jobs:
        s = best_schedule_fused(engine._with_quantum(j, 0), state)
        if s is not None:
            state.commit(j, s.workers, s.ps)
            committed.append((j, s))
    return cluster, state, committed


def _snapshot(state):
    return [state._g_host.copy(), state._v_host.copy()] + [
        x.clone() for x in state._dev]


def _same(state, snap):
    """Host mirror and all five resident tables equal ``snap`` bit for
    bit."""
    now = _snapshot(state)
    return all(np.array_equal(a, b) for a, b in zip(now[:2], snap[:2])) \
        and all(torch.equal(a, b) for a, b in zip(now[2:], snap[2:]))


def _release_victims(state, committed, pool, srv, t0):
    """The engine's failure protocol: victims on the dead server release
    their tails from t0 on before the block."""
    for j, s in committed:
        alloc = s.workers if pool == "worker" else s.ps
        if any(a[srv] > 0 for tt, a in alloc.items() if tt >= t0):
            state.release(j, {tt: y for tt, y in s.workers.items()
                              if tt >= t0},
                          {tt: z for tt, z in s.ps.items() if tt >= t0})


def test_block_unblock_roundtrip_is_bit_exact():
    cluster, state, committed = _populated_state(0, n=3)
    _release_victims(state, committed, "worker", 1, 0)
    snap = _snapshot(state)
    v0 = state.version
    assert state.block_server("worker", 1, 0) >= 0.0
    assert np.all(state._g_host[:, 1, :] >= cluster.worker_caps[1] - 1e-9)
    assert state.dirty_spans_since(v0) == [(0, state.horizon)]
    # the residency's prices are the host pricing of the blocked mirror
    fresh = PriceState(cluster, state.params, device="cpu")
    fresh._g_host, fresh._v_host = state._g_host.copy(), state._v_host.copy()
    assert all(torch.equal(a, b) for a, b in zip(state.device_prices(),
                                                  fresh.device_prices()))
    state.unblock_server("worker", 1, 0)
    assert _same(state, snap)
    state.block_server("ps", 2, 0)
    state.unblock_server("ps", 2, 0)
    assert _same(state, snap)
    assert state.device_uploads == 1


def _ref_state(state):
    """A reference ``PriceState`` holding copies of the port state's host
    mirror (the reference's constructor and fields)."""
    from repro.core.pricing import PriceParams as RefParams
    from repro.core.pricing import PriceState as RefState
    from repro.core.types import ClusterSpec as RefCluster
    c = state.cluster
    p = state.params
    ref = RefState(RefCluster(T=c.T, worker_caps=c.worker_caps.copy(),
                              ps_caps=c.ps_caps.copy()),
                   RefParams(U1=p.U1.copy(), U2=p.U2.copy(), L1=p.L1,
                             L2=p.L2), window=state.horizon)
    ref.g, ref.v = state._g_host.copy(), state._v_host.copy()
    return ref


def _mirror_priced(state):
    """The residency holds the host mirror and its fresh pricing, bit for
    bit."""
    fresh = PriceState(state.cluster, state.params, device="cpu",
                       window=state.horizon)
    fresh._g_host = state._g_host.copy()
    fresh._v_host = state._v_host.copy()
    want = fresh.device_state()[:2] + fresh.device_prices()
    return all(torch.equal(a, b) for a, b in zip(state._dev, want))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 50), srv=st.integers(0, 2),
       pool=st.sampled_from(["worker", "ps"]), t0=st.integers(0, 12))
def test_block_unblock_inverts_from_any_state(seed, srv, pool, t0):
    """From an arbitrarily populated state (victims released first, as the
    engine does), block and unblock move the host mirror exactly as the
    reference's do, and the residency with it.  The unblock leaves the
    server's slots [t0, T) at exactly 0 and every other entry as it was:
    so block then unblock restores the host mirror and all five resident
    tables bit for bit whenever the release left the server empty, the
    engine's case.  (A release can leave a rounding residue, ``(a + b) -
    a - b != 0``; the reference's unblock zeroes it, and so does the
    port's: its own property test fails on such a state, seed=1, srv=0,
    pool='worker', t0=0.)"""
    cluster, state, committed = _populated_state(seed)
    _release_victims(state, committed, pool, srv, t0)
    ref = _ref_state(state)
    snap = _snapshot(state)
    pool_i = 0 if pool == "worker" else 1
    empty = not snap[pool_i][t0:, srv].any()
    got = state.block_server(pool, srv, t0)
    assert got == ref.block_server(pool, srv, t0)
    assert np.array_equal(state._g_host, ref._g_host)
    assert np.array_equal(state._v_host, ref._v_host)
    assert _mirror_priced(state)
    assert state.unblock_server(pool, srv, t0) == ref.unblock_server(
        pool, srv, t0)
    assert np.array_equal(state._g_host, ref._g_host)
    assert np.array_equal(state._v_host, ref._v_host)
    assert _mirror_priced(state)
    host = state._g_host if pool == "worker" else state._v_host
    assert not host[t0:, srv].any()
    want = snap[pool_i].copy()
    want[t0:, srv] = 0.0
    assert np.array_equal(host, want)
    assert np.array_equal(state._v_host if pool == "worker"
                          else state._g_host, snap[1 - pool_i])
    if empty:
        assert _same(state, snap)
    assert state.device_uploads == 1


# ---------------------------------------------------------------------------
# the episodic driver under churn and cancellations
# ---------------------------------------------------------------------------

def _churn_instance():
    ref_c = make_cluster(T=60, H=12, K=12)
    jobs = make_jobs(30, T=60, seed=0)
    return (ref_c, jobs, ref_fleet.churn_trace(ref_c, frac=0.25, seed=2),
            workload.make_cluster(T=60, H=12, K=12),
            workload.make_jobs(30, T=60, seed=0))


def _same_result(got, want):
    for f in _RESULT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("cancel", [False, True])
def test_churn_run_equals_fast_on_whole_route(cancel):
    ref_c, jobs, tr, c, pjobs = _churn_instance()
    kw = {"cancellations": cancellation_trace(jobs, frac=0.25, seed=3)} \
        if cancel else {}
    want = ref_engine.run(ref_c, jobs, impl="fast", quantum=0, check=True,
                          fleet=tr, **kw)
    got = engine.run(c, pjobs, quantum=0, check=True, device="cpu",
                     fleet=compat.fleet_trace(tr), **kw)
    # the issue's oracle values for this instance
    assert (want.accepted, want.preempted, want.preempt_dropped,
            want.canceled) == ((6, 8, 1, 2) if cancel else (7, 8, 1, 0))
    _same_result(got, want)
    assert got.device_uploads == 1


def test_churn_run_tiled_matches_reference_tiled_engine(jax_shims):
    """Churn, then churn with cancellations, in one test: the reference's
    tiled engine compiles once."""
    ref_c, jobs, tr, c, pjobs = _churn_instance()
    for kw in ({}, {"cancellations": cancellation_trace(jobs, frac=0.25,
                                                         seed=3)}):
        want = ref_engine.run(ref_c, jobs, impl="jax", quantum=0, check=True,
                              fleet=tr, **kw)
        got = engine.run(c, pjobs, quantum=0, check=True, device="cpu",
                         core="tiled", fleet=compat.fleet_trace(tr), **kw)
        assert got.completion == want.completion
        assert (got.preempted, got.canceled) == (want.preempted,
                                                 want.canceled)
        assert got.total_utility == pytest.approx(want.total_utility,
                                                  rel=1e-9)


@pytest.mark.parametrize("seed", range(5))
def test_zero_churn_bit_identity_episodic(seed):
    c = workload.make_cluster(T=60, H=12, K=12)
    jobs = workload.make_jobs(30, T=60, seed=seed)
    a = engine.run(c, jobs, quantum=0, check=False, device="cpu")
    b = engine.run(c, jobs, quantum=0, check=False, device="cpu",
                   fleet=fleet.FleetTrace())
    _same_result(b, a)
    assert set(b.schedules) == set(a.schedules)
    assert b.preempted == 0 and b.preempt_dropped == 0


@pytest.mark.parametrize("seed", range(5))
def test_zero_churn_bit_identity_streaming(seed):
    c = workload.make_cluster(T=32, H=12, K=12)

    def trace():
        return itertools.islice(
            workload.stream_jobs(rate=0.3, seed=seed, small=True), 60)

    a = engine.run_stream(c, trace(), window=32, device="cpu")
    b = engine.run_stream(c, trace(), window=32, device="cpu",
                          fleet=fleet.FleetTrace())
    _same_result(b, a)
    assert b.preempted == 0 and b.preempt_dropped == 0


def test_cancel_of_dropped_victim_is_noop():
    """Every worker fails mid-run, so the preempted job cannot be
    re-admitted and is dropped; its later cancellation is then a no-op,
    not a second release."""
    caps = np.full((2, 5), 8.0)
    cluster = ClusterSpec(T=40, worker_caps=caps.copy(), ps_caps=caps.copy())
    job = Job(jid=0, arrival=0, epochs=6, num_chunks=4,
              minibatches_per_chunk=10, tau=0.02, grad_size=0.05,
              worker_bw=1.0, ps_bw=4.0,
              worker_res=np.array([1.0, 1.0, 1.0, 1.0, 1.0]),
              ps_res=np.array([0.0, 1.0, 1.0, 1.0, 4.0]),
              utility=SigmoidUtility(50.0, 5.0, 10.0))
    tr = fleet.FleetTrace((fleet.FleetEvent(3, "fail", "worker", 0),
                           fleet.FleetEvent(3, "fail", "worker", 1),
                           fleet.FleetEvent(30, "recover", "worker", 0),
                           fleet.FleetEvent(30, "recover", "worker", 1)))
    r = engine.run(cluster, [job], check=True, fleet=tr,
                   cancellations={0: 20}, device="cpu")
    assert (r.preempted, r.preempt_dropped, r.canceled, r.completed) == (
        1, 1, 0, 0)
    assert r.total_utility == 0.0

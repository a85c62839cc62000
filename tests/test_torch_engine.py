"""The port's slice end to end against the JAX package.

``repro_torch.sim.engine.run(device="cpu", quantum=0)`` must reproduce
``repro.sim.simulate(impl="fast", quantum=0)`` exactly on the paper-scale
instances (T=100, 50+50 servers, 200 small jobs): the accepted count,
every completion slot and the total utility, and the per-slot worker
counts of every accepted schedule.  Seed 2 carries a unit-price tie
that an ulp of price difference (numpy ``**`` against ``exp/log``) can
break either way, so per-server placements are not part of the
contract, though they agree on these seeds.  A run can also start on the
port from a reference state in the middle of the trajectory
(``repro_torch.compat``).
"""
import numpy as np
import pytest

from repro.core import OASiS as RefOASiS
from repro.core import price_params_from_jobs
from repro.sim import make_cluster, make_jobs, simulate
from repro.sim import engine as ref_engine
from repro.sim.engine import _with_quantum as ref_with_quantum
from repro_torch import compat
from repro_torch.core.oasis import OASiS
from repro_torch.sim import engine
from repro_torch.sim import workload


def _paper(seed):
    return (make_cluster(T=100, H=50, K=50),
            make_jobs(200, T=100, seed=seed, small=True))


def _ref_schedules(cluster, jobs):
    """The reference OASiS's schedules on the engine's event order."""
    sched = RefOASiS(cluster, price_params_from_jobs(jobs, cluster))
    by_slot = {}
    for j in jobs:
        by_slot.setdefault(j.arrival, []).append(ref_with_quantum(j, 0))
    for t in sorted(by_slot):
        sched.on_arrivals(by_slot[t])
    return sched


def _counts(s):
    return {t: int(y.sum()) for t, y in s.workers.items()}


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_engine_reproduces_fast_trajectory(seed):
    cluster, jobs = _paper(seed)
    want = simulate(cluster, jobs, scheduler="oasis", impl="fast", quantum=0)
    got = engine.run(workload.make_cluster(T=100, H=50, K=50),
                     workload.make_jobs(200, T=100, seed=seed, small=True),
                     device="cpu", quantum=0)
    assert got.accepted == want.accepted
    assert got.completion == want.completion
    assert got.total_utility == want.total_utility
    assert got.utilization == want.utilization
    assert got.device_uploads == 1
    ref = _ref_schedules(cluster, jobs)
    assert ref.total_utility == want.total_utility
    assert set(got.schedules) == set(ref.accepted)
    for jid, s in got.schedules.items():
        assert _counts(s) == _counts(ref.accepted[jid]), jid


def test_generator_matches_reference_draws():
    """The port's own workload generator draws the reference trace."""
    cluster, jobs = _paper(3)
    c = workload.make_cluster(T=100, H=50, K=50)
    assert np.array_equal(c.worker_caps, cluster.worker_caps)
    assert np.array_equal(c.ps_caps, cluster.ps_caps)
    for a, b in zip(workload.make_jobs(200, T=100, seed=3, small=True), jobs):
        b = compat.job(b)
        for f in ("jid", "arrival", "epochs", "num_chunks",
                  "minibatches_per_chunk", "tau", "grad_size", "worker_bw",
                  "ps_bw", "utility"):
            assert getattr(a, f) == getattr(b, f), f
        assert np.array_equal(a.worker_res, b.worker_res)
        assert np.array_equal(a.ps_res, b.ps_res)


def test_port_continues_reference_state_mid_trajectory():
    """The reference decides the first half of a trace; the port takes
    its price state over (compat) and decides the rest exactly as the
    reference does."""
    cluster, jobs = _paper(1)
    jobs = sorted(jobs, key=lambda j: j.arrival)[:120]
    params = price_params_from_jobs(jobs, cluster)
    ref = RefOASiS(cluster, params)
    ref.on_arrivals([ref_with_quantum(j, 0) for j in jobs[:60]])
    port = OASiS(compat.cluster(cluster), compat.price_params(params),
                 device="cpu")
    port.state = compat.price_state(ref.state, device="cpu")
    for rjob in jobs[60:]:
        want = ref.on_arrival(ref_with_quantum(rjob, 0))
        got = port.on_arrival(engine._with_quantum(compat.job(rjob), 0))
        assert (got is None) == (want is None), rjob.jid
        if want is not None:
            assert got.finish == want.finish
            assert got.utility == want.utility
            assert _counts(got) == _counts(want), rjob.jid
    assert np.array_equal(port.state._g_host, ref.state._g_host)


@pytest.mark.parametrize("kw", [{"scheduler": "learned"},
                                {"scheduler": "fifo",
                                 "policy": lambda dp: None},
                                {"policy": lambda dp: None}])
def test_learned_needs_policy_and_reject_all_matches_reference(kw):
    """``scheduler="learned"`` without a policy raises ``ValueError``, as
    the reference does; a reject-all policy gives the reference's run."""
    cluster = workload.make_cluster(T=10, H=2, K=2)
    jobs = workload.make_jobs(3, T=10, seed=0, small=True)
    rc, rj = make_cluster(T=10, H=2, K=2), make_jobs(3, T=10, seed=0,
                                                     small=True)
    if "policy" not in kw:
        with pytest.raises(ValueError, match="policy"):
            engine.run(cluster, jobs, device="cpu", **kw)
        with pytest.raises(ValueError, match="policy"):
            ref_engine.run(rc, rj, **kw)
        return
    got = engine.run(cluster, jobs, device="cpu", **kw)
    want = ref_engine.run(rc, rj, **kw)
    assert (got.accepted, got.completed, got.total_utility, got.completion,
            got.n_jobs) == (want.accepted, want.completed,
                            want.total_utility, want.completion,
                            want.n_jobs) == (0, 0, 0.0, {}, 3)
    assert len(got.decision_seconds) == 3


@pytest.mark.parametrize("name", ["repro_torch.core.oasis",
                                  "repro_torch.core.pricing",
                                  "repro_torch.sim.engine"])
def test_port_doctests(name):
    import doctest
    import importlib
    result = doctest.testmod(importlib.import_module(name),
                             optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0 and result.failed == 0, result


def test_duality_tracking_matches_reference():
    """Lemma-2 increments (track_duality) equal the reference's."""
    cluster, jobs = make_cluster(T=30, H=6, K=6), make_jobs(
        30, T=30, seed=4, small=True)
    params = price_params_from_jobs(jobs, cluster)
    ref = RefOASiS(cluster, params, track_duality=True)
    port = OASiS(compat.cluster(cluster), compat.price_params(params),
                 track_duality=True, device="cpu")
    ref.on_arrivals(jobs)
    port.on_arrivals([compat.job(j) for j in jobs])
    assert sorted(port.accepted) == sorted(ref.accepted)
    assert port.primal_deltas == ref.primal_deltas
    np.testing.assert_allclose(port.dual_deltas, ref.dual_deltas,
                               rtol=1e-9)

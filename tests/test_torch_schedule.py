"""The port's whole-horizon decision core against the JAX package.

On the instances of tests/test_fused_engine.py::
test_fused_equals_ref_randomized, with prices evolving through the
reference oracle's commits, the port's ``best_schedule_fused`` on the CPU
must make the JAX ``_decide_one(use_pallas=False)`` decision (float64):
the same accept/reject, finish slot and per-slot worker counts, and a
cost within rel 1e-12 (the two compute prices and prefix sums with
different libraries, so the last ulps may differ).  Against
``best_schedule_ref`` it is held to that test's tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import jax_shims  # noqa: F401  (fixture)
from repro.core import best_schedule_ref, price_params_from_jobs
from repro.core.pricing import PriceState as RefPriceState
from repro.core.schedule_jax import (_decide_one, _job_arrays,
                                     _schedule_from_outputs, _shape_bucket)
from repro.sim import make_cluster, make_jobs
from repro_torch import compat
from repro_torch.core import schedule_torch
from repro_torch.core.pricing import PriceState


def _jax_decide(job, state):
    key = _shape_bucket(job)
    if key is None:
        return None
    m_pad, d1 = key
    with jax.enable_x64(True):
        sd = state.device_state(np.float64)
        jd = _job_arrays(job, state.horizon, m_pad, jnp.float64)
        best_t, _, cost, d_left, d_slots, y, z = _decide_one(
            sd, jd, d1=d1, use_pallas=False)
        return _schedule_from_outputs(
            job, state, int(best_t), float(cost), int(d_left),
            np.asarray(d_slots), np.asarray(y), np.asarray(z))


def _counts(sched):
    return {t: int(y.sum()) for t, y in sched.workers.items()}


@pytest.mark.parametrize("seed,T,H,K", [(0, 12, 4, 4), (7, 16, 5, 5),
                                        (21, 10, 3, 2)])
def test_decide_core_equals_jax_and_ref(jax_shims, seed, T, H, K):
    cluster = make_cluster(T=T, H=H, K=K)
    jobs = make_jobs(10, T=T, seed=seed, small=True)
    params = price_params_from_jobs(jobs, cluster)
    ref_state = RefPriceState(cluster, params)
    state = PriceState(compat.cluster(cluster), compat.price_params(params),
                       device="cpu")
    for rjob in jobs:
        job = compat.job(rjob)
        got = schedule_torch.best_schedule_fused(job, state)
        want = _jax_decide(rjob, ref_state)
        ref = best_schedule_ref(rjob, ref_state)
        assert (got is None) == (want is None) == (ref is None), rjob.jid
        if ref is not None:
            assert got.finish == want.finish == ref.finish, rjob.jid
            assert got.cost == pytest.approx(want.cost, rel=1e-12, abs=0)
            assert _counts(got) == _counts(want), rjob.jid
            assert got.payoff == pytest.approx(ref.payoff, rel=1e-6,
                                               abs=1e-9)
            assert got.cost == pytest.approx(ref.cost, rel=1e-6, abs=1e-9)
            assert got.utility == pytest.approx(ref.utility, rel=1e-6)
            for t, y in got.workers.items():
                assert y.sum() == ref.workers[t].sum(), (rjob.jid, t)
            ref_state.commit(rjob, ref.workers, ref.ps)
            state.commit(job, ref.workers, ref.ps)
    assert state.device_uploads == 1


@pytest.mark.parametrize("n", [1, 3, 7])
def test_greedy_pieces_equal_jax(jax_shims, n):
    """Prefix tables, greedy costs and greedy placement equal the jnp
    helpers on one random state (prices from the same formula)."""
    import torch
    from repro.core import schedule_jax as sj
    rng = np.random.default_rng(n)
    T, S = 6, 5
    prices = rng.uniform(0.5, 3.0, (T, S, 5))
    prices[:, 1] = prices[:, 0]                   # a tie: stable order
    headroom = rng.integers(0, 30, (T, S, 5)).astype(np.float64)
    demand = np.array([0.0, 1.5, 2.0, 0.5, 1.0]) * n
    counts = rng.integers(0, 12, (T, 4)).astype(np.float64)
    with jax.enable_x64(True):
        want = sj._prefix_tables_jnp(jnp.asarray(prices),
                                     jnp.asarray(headroom),
                                     jnp.asarray(demand))
        order, scap, scost, ccap, ccost = [np.asarray(x) for x in want]
        want_cost = np.asarray(sj._greedy_cost_jnp(
            *want[3:], want[2], jnp.asarray(counts)))
        want_place = np.asarray(sj._greedy_place_jnp(
            want[0], want[1], want[3], jnp.asarray(counts[:, 1])))
    got = schedule_torch._prefix_tables(torch.tensor(prices),
                                        torch.tensor(headroom),
                                        torch.tensor(demand))
    for g, w in zip(got, (order, scap, scost, ccap, ccost)):
        assert np.array_equal(g.numpy(), w)
    got_cost = schedule_torch._greedy_cost(got[3], got[4], got[2],
                                           torch.tensor(counts))
    assert np.array_equal(got_cost.numpy(), want_cost)
    got_place = schedule_torch._greedy_place(got[0], got[1], got[3],
                                             torch.tensor(counts[:, 1]))
    assert np.array_equal(got_place.numpy(), want_place)


def test_zero_capacity_job_is_rejected_without_solving():
    from repro_torch.core.types import Job, SigmoidUtility
    cluster = compat.cluster(make_cluster(T=8, H=2, K=2))
    job = Job(jid=0, arrival=0, epochs=1, num_chunks=1,
              minibatches_per_chunk=10, tau=0.5, grad_size=0.05,
              worker_bw=1.0, ps_bw=4.0, worker_res=np.ones(5),
              ps_res=np.ones(5), utility=SigmoidUtility(50.0, 1.0, 3.0))
    assert job.max_chunks_per_slot == 0
    assert schedule_torch._shape_bucket(job) is None
    state = PriceState(cluster, compat.price_params(price_params_from_jobs(
        make_jobs(4, T=8, seed=0, small=True), make_cluster(T=8, H=2, K=2))),
        device="cpu")
    assert schedule_torch.best_schedule_fused(job, state) is None
    assert state.device_uploads == 0

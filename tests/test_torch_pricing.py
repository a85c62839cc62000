"""The port's PriceState against the JAX package's.

After the same interleaved commits and releases, the host mirrors must
be bitwise equal; the torch residency must equal the mirror in float64
after one upload for the whole run; reading ``.g``/``.v`` drops it; and
the float32 residency keeps the reference's resync rule.
"""
import numpy as np
import pytest
import torch

from _torch_parity import jax_shims  # noqa: F401  (fixture)
from repro.core.pricing import PriceState as RefPriceState
from repro.core.pricing import price_params_from_jobs as ref_params
from repro.core.types import Job as RefJob
from repro.core.types import SigmoidUtility as RefSigmoid
from repro.sim import make_cluster as ref_make_cluster
from repro.sim import make_jobs as ref_make_jobs
from repro_torch import compat
from repro_torch.core.pricing import PriceState, price_params_from_jobs
from repro_torch.core.types import Job, SigmoidUtility
from repro_torch.sim.workload import make_cluster, make_jobs


def _job_pair(jid, wres, sres):
    kw = dict(jid=jid, arrival=0, epochs=2, num_chunks=3,
              minibatches_per_chunk=10, tau=0.02, grad_size=0.05,
              worker_bw=1.0, ps_bw=4.0)
    return (Job(**kw, worker_res=wres, ps_res=sres,
                utility=SigmoidUtility(50.0, 1.0, 3.0)),
            RefJob(**kw, worker_res=wres, ps_res=sres,
                   utility=RefSigmoid(50.0, 1.0, 3.0)))


def _alloc(rng, T, S, n_slots):
    slots = rng.choice(T, size=min(n_slots, T), replace=False)
    return {int(t): rng.integers(0, 4, size=S).astype(np.int64)
            for t in slots}


def _states(T=12, H=4, K=4):
    c, rc = make_cluster(T=T, H=H, K=K), ref_make_cluster(T=T, H=H, K=K)
    p = price_params_from_jobs(make_jobs(8, T=T, seed=0, small=True), c)
    rp = ref_params(ref_make_jobs(8, T=T, seed=0, small=True), rc)
    assert np.array_equal(p.U1, rp.U1) and p.L1 == rp.L1 and p.L2 == rp.L2
    return PriceState(c, p, device="cpu"), RefPriceState(rc, rp)


def _interleave(state, ref, rng, n=30, dtype=torch.float64):
    """Random commits with every third one released again; residency
    fetched between mutations, as the decision loop does."""
    T, H, K = state.cluster.T, state.cluster.H, state.cluster.K
    for i in range(n):
        wres = rng.uniform(0, 4, 5)
        sres = rng.uniform(0, 4, 5)
        sres[0] = 0.0                  # PS servers have no GPUs
        job, rjob = _job_pair(i, wres, sres)
        workers = _alloc(rng, T, H, int(rng.integers(1, T)))
        ps = _alloc(rng, T, K, int(rng.integers(1, T)))
        state.commit(job, workers, ps)
        ref.commit(rjob, workers, ps)
        state.device_state(dtype)
        if i % 3 == 2:
            state.release(job, workers, ps)
            ref.release(rjob, workers, ps)
            state.device_state(dtype)


def test_mirror_bitwise_equals_reference_after_interleaving():
    state, ref = _states()
    _interleave(state, ref, np.random.default_rng(3))
    assert np.array_equal(state._g_host, ref._g_host)
    assert np.array_equal(state._v_host, ref._v_host)
    assert np.array_equal(state.worker_prices(), ref.worker_prices())
    assert np.array_equal(state.ps_prices(), ref.ps_prices())


def test_f64_residency_equals_mirror_with_one_upload():
    state, ref = _states()
    _interleave(state, ref, np.random.default_rng(4))
    g, v = state.device_state(torch.float64)[:2]
    assert state.device_uploads == 1
    assert np.array_equal(g.numpy(), state._g_host)
    assert np.array_equal(v.numpy(), state._v_host)


def test_upload_copies_the_mirror():
    """The residency never aliases the host mirror."""
    state, _ = _states()
    g = state.device_state()[0]
    state._g_host[0, 0, 0] = 5.0
    assert g[0, 0, 0].item() == 0.0


def test_reading_g_or_v_drops_residency():
    state, _ = _states()
    state.device_state()
    _ = state.g
    state.device_state()
    assert state.device_uploads == 2
    _ = state.v
    state.device_state()
    assert state.device_uploads == 3


def test_f32_residency_resyncs_on_release_and_cadence():
    state, _ = _states()
    rng = np.random.default_rng(5)
    job, _ = _job_pair(0, np.full(5, 0.25), np.full(5, 0.25))
    T, H, K = state.cluster.T, state.cluster.H, state.cluster.K
    state.device_state(torch.float32)
    w, z = _alloc(rng, T, H, 3), _alloc(rng, T, K, 3)
    state.commit(job, w, z)
    assert state._dev is not None              # in-place add
    state.release(job, w, z)
    assert state._dev is None                  # release resyncs
    state.device_state(torch.float32)
    for _ in range(PriceState._F32_RESYNC_EVERY):
        state.commit(job, w, z)
    assert state._dev is not None
    state.commit(job, w, z)
    assert state._dev is None                  # cadence resync
    g = state.device_state(torch.float32)[0]
    assert torch.equal(g, torch.tensor(state._g_host, dtype=torch.float32))


def test_compat_carries_reference_state_over(jax_shims):
    """compat.price_state copies the reference mirrors, and the port then
    prices exactly as the reference does."""
    state, ref = _states()
    _interleave(state, ref, np.random.default_rng(6), n=10)
    ported = compat.price_state(ref, device="cpu")
    assert np.array_equal(ported.worker_prices(), ref.worker_prices())
    assert np.array_equal(ported.ps_prices(), ref.ps_prices())
    g = ported.device_state()[0]
    assert np.array_equal(g.numpy(), ref._g_host)
    ref_g = np.asarray(ref.device_state(np.float64)[0])
    assert np.array_equal(g.numpy(), ref_g)


def test_default_device_needs_cuda(monkeypatch):
    state, _ = _states()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PriceState(state.cluster, state.params)

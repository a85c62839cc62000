"""Continuous serving on the port against the JAX package.

* ``stream_jobs`` yields the reference's jobs field by field;
* ``PriceState(window=).advance`` slides the host mirror as the
  reference's does, and the device residency in place: surviving slots
  keep their bits in all five tables, the tail equals a fresh pricing,
  no upload is made, and a stale ``RowCache`` re-solves as a cold solve;
* ``engine.run_stream`` is a translation of the episodic run, equals the
  reference's ``impl="fast"`` exactly on the whole route, churned or not,
  and on the tiled route has its completions (the reference's tiled
  engine's under churn) and its utility within rel 1e-9.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.core.pricing import PriceState as RefPriceState
from repro.core.pricing import price_params_from_jobs as ref_params
from repro.sim import engine as ref_engine
from repro.sim import fleet as ref_fleet
from repro.sim import make_cluster, make_jobs, stream_jobs
from repro_torch import compat
from repro_torch.core.oasis import OASiS
from repro_torch.core.pricing import PriceState, price_params_from_jobs
from repro_torch.core.schedule_torch import (RowCache, best_schedule_fused,
                                             decide_burst)
from repro_torch.sim import engine, fleet, workload

from _torch_parity import jax_shims, one_torch_thread  # noqa: F401

W = 24
_JOB_FIELDS = ("jid", "arrival", "epochs", "num_chunks",
               "minibatches_per_chunk", "tau", "grad_size", "worker_bw",
               "ps_bw", "utility", "quantum", "work_scale")


@pytest.mark.parametrize("kw", [dict(rate=0.2, seed=0, max_slots=3000),
                                dict(rate=0.3, seed=6, max_slots=400,
                                     small=True),
                                dict(rate=1.5, seed=3, max_slots=200,
                                     burst_prob=0.1, diurnal_period=50)])
def test_stream_jobs_matches_reference(kw):
    want = list(stream_jobs(**kw))
    got = list(workload.stream_jobs(**kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        b = compat.job(b)
        for f in _JOB_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert np.array_equal(a.worker_res, b.worker_res)
        assert np.array_equal(a.ps_res, b.ps_res)


# ---------------------------------------------------------------------------
# the rolling window
# ---------------------------------------------------------------------------

def _windowed(window=32, T=40, H=4, K=4, n=12, seed=1):
    """Port and reference windowed states after the same commits."""
    ref_c = make_cluster(T=T, H=H, K=K)
    jobs = make_jobs(n, T=window, seed=seed, small=True)
    params = ref_params(jobs, ref_c)
    ref = RefPriceState(ref_c, params, window=window)
    port = PriceState(compat.cluster(ref_c), compat.price_params(params),
                      device="cpu", window=window)
    port.device_state()
    for j in jobs:
        pj = compat.job(j)
        s = best_schedule_fused(engine._with_quantum(pj, 0), port)
        if s is not None:
            port.commit(pj, s.workers, s.ps)
            ref.commit(j, s.workers, s.ps)
    return ref, port, jobs


def _fresh_prices(port):
    """The five resident tables of a fresh residency of ``port``'s mirror."""
    fresh = PriceState(port.cluster, port.params, device="cpu",
                       window=port.horizon)
    fresh._g_host = port._g_host.copy()
    fresh._v_host = port._v_host.copy()
    return fresh.device_state()[:2] + fresh.device_prices()


@pytest.mark.parametrize("steps", [(5,), (1, 7, 13), (32,), (40, 3)])
def test_advance_slides_mirror_and_residency(steps):
    ref, port, _ = _windowed()
    Wn = port.horizon
    assert port.window_bytes == ref.window_bytes == Wn * 8 * 5 * 8
    now = 0
    for k in steps:
        before = [x.clone() for x in port._dev]
        version = port.version
        now += k
        port.advance(now)
        ref.advance(now)
        assert np.array_equal(port._g_host, ref._g_host)
        assert np.array_equal(port._v_host, ref._v_host)
        assert (port.origin, port.retired_slots, port.retired_gpu_slots) == (
            ref.origin, ref.retired_slots, ref.retired_gpu_slots)
        keep = max(Wn - k, 0)
        for old, new in zip(before, port._dev):
            assert torch.equal(new[:keep], old[k:k + keep])
        # the tail (and so the whole table) equals a fresh pricing
        for got, want in zip(port._dev, _fresh_prices(port)):
            assert torch.equal(got, want)
        assert port.device_uploads == 1
        assert port.dirty_spans_since(version) is None
        assert port.dirty_spans_since(port.version) == []
    with pytest.raises(ValueError):
        port.advance(now - 1)


def test_serving_window_bytes():
    c = workload.make_cluster(T=64, H=50, K=50)
    jobs = workload.make_jobs(4, T=64, seed=0)
    state = PriceState(c, price_params_from_jobs(jobs, c), device="cpu",
                       window=64)
    assert state.window_bytes == 256000


def test_stale_row_cache_after_advance_equals_cold_solve():
    """A tiled decision, a commit and a slide, then a re-solve through the
    job's now stale ``RowCache`` equals a cold solve."""
    _, port, jobs = _windowed(window=64, T=64, n=20, seed=2)
    job = engine._with_quantum(
        dataclasses.replace(compat.job(jobs[0]), jid=99, arrival=0), 0)
    pend = decide_burst([job], port)[0]
    cache = pend.cache
    s = best_schedule_fused(job, port, core="tiled")
    port.commit(job, s.workers, s.ps)
    port.advance(5)
    cached = best_schedule_fused(job, port, core="tiled",
                                 row_cache=cache.sync(port))
    cold = best_schedule_fused(job, port, core="tiled",
                               row_cache=RowCache.empty(port, job))
    assert (cached is None) == (cold is None)
    if cold is not None:
        assert (cached.finish, cached.cost, cached.utility) == (
            cold.finish, cold.cost, cold.utility)
        for t in cold.workers:
            assert np.array_equal(cached.workers[t], cold.workers[t])
            assert np.array_equal(cached.ps[t], cold.ps[t])


def test_port_continues_reference_windowed_state():
    """compat carries a reference windowed state, mid-stream: the port's
    state has its mirror and its place on the clock."""
    ref, port, _ = _windowed()
    ref.advance(9)
    got = compat.price_state(ref, device="cpu")
    assert np.array_equal(got._g_host, ref._g_host)
    assert (got.horizon, got.origin, got.retired_slots,
            got.retired_gpu_slots) == (ref.horizon, ref.origin,
                                       ref.retired_slots,
                                       ref.retired_gpu_slots)


# ---------------------------------------------------------------------------
# the streamed driver
# ---------------------------------------------------------------------------

def _jobs_at(arrival, n=10, seed=2):
    jobs = workload.make_jobs(n, T=10, seed=seed, small=True)
    return [dataclasses.replace(j, arrival=arrival) for j in jobs]


@pytest.mark.parametrize("core", ["whole", "tiled"])
def test_oasis_stream_is_translation_of_episodic(core):
    cluster = workload.make_cluster(T=W, H=6, K=6)
    jobs0 = _jobs_at(0)
    params = price_params_from_jobs(jobs0, cluster)
    ep = engine.run(cluster, jobs0, params=params, quantum=0, check=True,
                    device="cpu", core=core)
    shift = 5
    st = engine.run_stream(cluster, iter(_jobs_at(shift)), params=params,
                           window=W, quantum=0, check=True, device="cpu",
                           core=core)
    assert st.total_utility == ep.total_utility
    assert st.accepted == ep.accepted and st.completed == ep.completed
    assert st.completion == {j: c + shift for j, c in ep.completion.items()}
    assert st.window_bytes == W * (6 + 6) * 5 * 8


@pytest.mark.parametrize("core", ["whole", "tiled"])
def test_stream_matches_fast(core):
    """The port's stream (W=24, H=K=5, the first 30 jobs of a small
    stream) against the reference's ``impl="fast"``: exact on the whole
    route; the tiled route's completions equal, utility within 1e-9."""
    ref_c = make_cluster(T=W, H=5, K=5)
    jobs = list(itertools.islice(stream_jobs(rate=0.3, seed=6, small=True),
                                 30))
    params = ref_params([dataclasses.replace(j, arrival=0) for j in jobs],
                        dataclasses.replace(ref_c, T=W))
    want = ref_engine.run_stream(ref_c, iter(jobs), params=params,
                                 impl="fast", window=W, quantum=0,
                                 check=True)
    got = engine.run_stream(compat.cluster(ref_c),
                            iter([compat.job(j) for j in jobs]),
                            params=compat.price_params(params), window=W,
                            quantum=0, check=True, device="cpu", core=core)
    assert got.accepted == want.accepted
    assert got.completion == want.completion
    if core == "whole":
        assert got.total_utility == want.total_utility
        assert got.utilization == want.utilization
    else:
        assert got.total_utility == pytest.approx(want.total_utility,
                                                  rel=1e-9)
    assert got.device_uploads == 1


def test_streamed_trace_completes():
    H = K = 6
    cluster = workload.make_cluster(T=W, H=H, K=K)
    trace = workload.stream_jobs(rate=0.15, seed=0, max_slots=250,
                                 small=True)
    r = engine.run_stream(cluster, trace, window=W, check=True, quantum=0,
                          device="cpu")
    assert r.n_jobs > 0
    assert r.completed <= r.accepted <= r.n_jobs
    assert max(r.completion.values(), default=0) < 250 + 10 * W
    assert r.window_bytes == W * (H + K) * 5 * 8
    assert r.device_uploads == 1


def _stream_churn_instance():
    ref_c = make_cluster(T=32, H=8, K=8)
    jobs = list(itertools.islice(stream_jobs(rate=0.2, seed=0), 30))
    tr = ref_fleet.churn_trace(ref_c, frac=0.25, seed=2, T=200)
    return ref_c, jobs, tr


def test_stream_churn_equals_fast_on_whole_route():
    ref_c, jobs, tr = _stream_churn_instance()
    want = ref_engine.run_stream(ref_c, iter(jobs), impl="fast", window=32,
                                 quantum=0, check=True, fleet=tr)
    got = engine.run_stream(compat.cluster(ref_c),
                            iter([compat.job(j) for j in jobs]), window=32,
                            quantum=0, check=True, device="cpu",
                            fleet=compat.fleet_trace(tr))
    # the issue's oracle values for this instance
    assert (want.accepted, want.preempted, want.preempt_dropped) == (13, 4, 1)
    for f in ("accepted", "completed", "completion", "total_utility",
              "preempted", "preempt_dropped", "utilization", "live_frac",
              "window_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.device_uploads == 1


def test_stream_churn_tiled_matches_reference_tiled_engine(jax_shims):
    ref_c, jobs, tr = _stream_churn_instance()
    want = ref_engine.run_stream(ref_c, iter(jobs), impl="jax", window=32,
                                 quantum=0, check=True, fleet=tr)
    got = engine.run_stream(compat.cluster(ref_c),
                            iter([compat.job(j) for j in jobs]), window=32,
                            quantum=0, check=True, device="cpu", core="tiled",
                            fleet=compat.fleet_trace(tr))
    assert got.completion == want.completion
    assert got.preempted == want.preempted
    assert got.total_utility == pytest.approx(want.total_utility, rel=1e-9)


def test_stream_churn_routes_agree():
    """Both routes on a churned stream of the port's own generators."""
    c = workload.make_cluster(T=32, H=8, K=8)
    tr = fleet.churn_trace(c, frac=0.25, seed=2, T=120)

    def jobs():
        return itertools.islice(workload.stream_jobs(rate=0.4, seed=0,
                                                     small=True), 40)

    runs = [engine.run_stream(c, jobs(), window=32, check=True, fleet=tr,
                              quantum=0, device="cpu", core=core)
            for core in ("whole", "tiled")]
    assert runs[0].completed > 0
    assert runs[0].completion == runs[1].completion
    assert runs[1].total_utility == pytest.approx(runs[0].total_utility,
                                                  rel=1e-9)


def test_run_stream_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None takes it")
    c = workload.make_cluster(T=W, H=2, K=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.run_stream(c, iter(_jobs_at(0, n=2)), window=W)


def test_on_arrivals_bursts_in_the_stream(monkeypatch):
    """The streamed driver decides a slot's burst through
    ``OASiS.on_arrivals`` (on the tiled route, ``decide_burst``)."""
    calls = []
    orig = OASiS.on_arrivals

    def spy(self, batch):
        calls.append(len(batch))
        return orig(self, batch)

    monkeypatch.setattr(OASiS, "on_arrivals", spy)
    engine.run_stream(workload.make_cluster(T=W, H=4, K=4),
                      iter(_jobs_at(3, n=4)), window=W, quantum=0,
                      device="cpu", core="tiled")
    assert calls == [4]

"""The reactive drivers and the perturbed OASiS accounting on the port
against the JAX package.

* ``engine.run`` and ``simulate`` for FIFO, DRF, RRH and Dorm equal the
  reference field by field, exactly: plain, with cancellations, under
  churn, and under ``StragglerThroughput`` without detection (the
  stateless ``rate_matrix`` path) and with it (the stateful slot-by-slot
  path); ``run_stream`` equals the reference on a quick serving stream,
  churned or not; ``simulate`` equals the reference's per-slot loop
  (``simulate_reference``) as the reference's own engine does;
* OASiS under ``throughput=``: the whole route equals ``impl="fast"``
  exactly, the tiled route has the reference's tiled engine's
  (``impl="jax"``) completions and its utility within rel 1e-9;
* the reactive path creates no torch tensor; ``scheduler="learned"``
  without a policy raises ``ValueError`` and a reject-all ``policy=``
  gives the reference's runs.
"""
import itertools

import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.sim import engine as ref_engine
from repro.sim import fleet as ref_fleet
from repro.sim import make_cluster, make_jobs, simulate_reference, stream_jobs
from repro.sim.scenarios import StragglerThroughput as RefStraggler
from repro.sim.scenarios import cancellation_trace
from repro_torch import compat
from repro_torch.sim import engine, simulator, workload
from repro_torch.sim.fleet import churn_trace
from repro_torch.sim.scenarios import StragglerThroughput

from _torch_parity import jax_shims, one_torch_thread  # noqa: F401

REACTIVE = ["fifo", "drf", "rrh", "dorm"]
_FIELDS = ("n_jobs", "accepted", "completed", "completion", "total_utility",
           "utilization", "canceled", "preempted", "preempt_dropped",
           "live_frac", "target_gap", "arrivals", "window_bytes")


def _same(got, want, fields=_FIELDS):
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f


def _instance(T=60, H=12, K=12, n=40, seed=9, small=False):
    return (make_cluster(T=T, H=H, K=K), make_jobs(n, T=T, seed=seed,
                                                   small=small),
            workload.make_cluster(T=T, H=H, K=K),
            workload.make_jobs(n, T=T, seed=seed, small=small))


def _hooks(kind, c, jobs, seed=1):
    """(reference kwargs, port kwargs) of one scenario hook."""
    if kind == "cancel":
        kw = {"cancellations": cancellation_trace(jobs, frac=0.3, seed=seed)}
        return kw, kw
    if kind == "churn":
        tr = ref_fleet.churn_trace(c, frac=0.25, seed=seed + 1)
        return {"fleet": tr}, {"fleet": compat.fleet_trace(tr)}
    if kind == "churn+cancel":
        a, b = _hooks("churn", c, jobs, seed)
        kw = _hooks("cancel", c, jobs, seed)[0]
        return {**a, **kw}, {**b, **kw}
    detect = kind == "detected"
    return ({"throughput": RefStraggler(seed=seed, slow_frac=0.4,
                                        slowdown=4.0, detect=detect)},
            {"throughput": StragglerThroughput(seed=seed, slow_frac=0.4,
                                               slowdown=4.0,
                                               detect=detect)})


@pytest.mark.parametrize("kind", ["plain", "cancel", "churn", "churn+cancel",
                                  "undetected", "detected"])
@pytest.mark.parametrize("name", REACTIVE)
def test_reactive_run_equals_reference(name, kind):
    """Full-size jobs on T=60, H=K=12: every hook, every field, exactly;
    the repack count too."""
    c, jobs, pc, pjobs = _instance()
    rkw, pkw = _hooks(kind, c, jobs) if kind != "plain" else ({}, {})
    want = ref_engine.run(c, jobs, scheduler=name, check=True, **rkw)
    got = engine.run(pc, pjobs, scheduler=name, check=True, device="cpu",
                     **pkw)
    _same(got, want)
    assert len(got.decision_seconds) == len(want.decision_seconds)


@pytest.mark.parametrize("seed", range(5))
def test_reactive_paper_scale_equals_reference(seed):
    """The paper's setting (T=100, 50+50 servers, 200 jobs), seeds 0..4,
    through ``simulate`` and quantized (a DP-only knob)."""
    c, jobs, pc, pjobs = _instance(T=100, H=50, K=50, n=200, seed=seed,
                                   small=True)
    for name in REACTIVE:
        want = ref_engine.run(c, jobs, scheduler=name, check=True)
        _same(simulator.simulate(pc, pjobs, scheduler=name, check=True,
                                 device="cpu"), want)
        _same(engine.run(pc, pjobs, scheduler=name, check=True, quantum=5,
                         device="cpu"), want)


@pytest.mark.parametrize("instance", [
    dict(T=40, H=8, K=8, n=30, seed=9, small=False),
    dict(T=60, H=12, K=12, n=60, seed=1, small=True)])
def test_simulate_equals_reference_loop(instance):
    """The event engine against the reference's per-slot loop, every
    scheduler, OASiS (whole route) included, to the standard of the
    reference's own engine-against-loop test: accepted, completed and
    completions equal, utility within rel 1e-9."""
    c, jobs, pc, pjobs = _instance(**instance)
    for name in ["oasis"] + REACTIVE:
        kw = {"quantum": 0} if name == "oasis" else {}
        want = simulate_reference(c, jobs, scheduler=name, check=True, **kw)
        got = simulator.simulate(pc, pjobs, scheduler=name, check=True,
                                 device="cpu", **kw)
        assert (got.accepted, got.completed) == (want.accepted,
                                                 want.completed), name
        assert got.completion == want.completion, name
        assert got.total_utility == pytest.approx(want.total_utility,
                                                  rel=1e-9, abs=1e-9)
        assert got.utilization == pytest.approx(want.utilization,
                                                rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("churn", [False, True])
@pytest.mark.parametrize("name", REACTIVE)
def test_reactive_stream_equals_reference(name, churn):
    """The quick serving stream (``SERVING_DIMS_QUICK``: H = K = 12, 600
    slots at rate 0.1); churned by ``churn_trace(0.25, T=600)`` with
    full-size jobs, which the churn reaches."""
    c = make_cluster(T=32, H=12, K=12)
    pc = workload.make_cluster(T=32, H=12, K=12)
    kw = dict(rate=0.1, seed=0, max_slots=600, small=not churn)
    rkw, pkw = {}, {}
    if churn:
        tr = ref_fleet.churn_trace(c, frac=0.25, seed=1, T=600)
        rkw, pkw = {"fleet": tr}, {"fleet": compat.fleet_trace(tr)}
    want = ref_engine.run_stream(c, stream_jobs(**kw), scheduler=name,
                                 check=True, **rkw)
    got = engine.run_stream(pc, workload.stream_jobs(**kw), scheduler=name,
                            check=True, device="cpu", **pkw)
    _same(got, want)
    assert got.window_bytes == 0 and (got.preempted > 0) == churn


@pytest.mark.parametrize("kind", ["undetected", "detected", "churn"])
def test_oasis_throughput_equals_fast_on_whole_route(kind):
    """The perturbed completion accounting over the committed slots; under
    churn the live copies carry the post-checkpoint work."""
    c, jobs, pc, pjobs = _instance(T=50, H=10, K=10, n=30, seed=6,
                                   small=True)
    rkw, pkw = _hooks("detected" if kind == "detected" else "undetected",
                      c, jobs, seed=6)
    if kind == "churn":
        a, b = _hooks("churn", make_cluster(T=60, H=12, K=12), jobs, seed=1)
        c, jobs, pc, pjobs = _instance()
        rkw, pkw = {**rkw, **a}, {**pkw, **b}
    base = ref_engine.run(c, jobs, impl="fast", quantum=0)
    want = ref_engine.run(c, jobs, impl="fast", quantum=0, check=True,
                          **rkw)
    got = engine.run(pc, pjobs, quantum=0, check=True, device="cpu", **pkw)
    _same(got, want, _FIELDS[:-1])
    if kind != "churn":
        assert want.accepted == base.accepted
        assert want.completed < base.completed      # the perturbation bites


def test_oasis_throughput_tiled_matches_reference_tiled_engine(jax_shims):
    """Undetected, then detected stragglers, in one test: the reference's
    tiled engine compiles once."""
    c, jobs, pc, pjobs = _instance(T=50, H=10, K=10, n=30, seed=6,
                                   small=True)
    for kind in ("undetected", "detected"):
        rkw, pkw = _hooks(kind, c, jobs, seed=6)
        want = ref_engine.run(c, jobs, impl="jax", quantum=0, check=True,
                              **rkw)
        got = engine.run(pc, pjobs, quantum=0, check=True, device="cpu",
                         core="tiled", **pkw)
        assert got.completion == want.completion
        assert got.total_utility == pytest.approx(want.total_utility,
                                                  rel=1e-9)


class _TensorSpy(TorchFunctionMode):
    """Records every torch function that returns a tensor."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor):
            self.calls.append(func)
        return out


@pytest.mark.parametrize("name", REACTIVE)
def test_reactive_path_creates_no_tensor(name):
    """No torch function runs on the reactive path, churned, perturbed
    and streamed; the spy sees the OASiS path's."""
    pc = workload.make_cluster(T=40, H=4, K=4)
    pjobs = workload.make_jobs(30, T=40, seed=3, small=True)
    with _TensorSpy() as spy:
        engine.run(pc, pjobs, scheduler=name, device="cpu",
                   fleet=churn_trace(pc, frac=0.25, seed=2),
                   throughput=StragglerThroughput(seed=1, detect=True))
        engine.run_stream(pc, itertools.islice(workload.stream_jobs(
            rate=0.3, seed=1, small=True), 40), scheduler=name,
            device="cpu")
    assert spy.calls == []
    with _TensorSpy() as spy:
        engine.run(pc, pjobs[:3], device="cpu")
    assert spy.calls


@pytest.mark.parametrize("kw", [{"scheduler": "learned"},
                                {"policy": lambda dp: None},
                                {"scheduler": "drf",
                                 "policy": lambda dp: None}])
def test_learned_needs_policy_and_reject_all_streams(kw):
    """``scheduler="learned"`` without a policy raises ``ValueError`` in
    ``run`` and ``run_stream``, as the reference does; a reject-all policy
    through both equals the reference's runs with the same policy."""
    c, jobs, pc, pjobs = _instance(T=10, H=2, K=2, n=3, seed=0, small=True)
    if "policy" not in kw:
        for fn, args in ((engine.run, (pc, pjobs)),
                         (engine.run_stream, (pc, iter(pjobs))),
                         (ref_engine.run, (c, jobs)),
                         (ref_engine.run_stream, (c, iter(jobs)))):
            with pytest.raises(ValueError, match="policy"):
                fn(*args, **({"device": "cpu"} if fn in (
                    engine.run, engine.run_stream) else {}), **kw)
        return
    _same(engine.run(pc, pjobs, device="cpu", **kw),
          ref_engine.run(c, jobs, **kw))
    got = engine.run_stream(pc, iter(pjobs), device="cpu", window=16, **kw)
    want = ref_engine.run_stream(c, iter(jobs), window=16, **kw)
    _same(got, want)
    assert (got.accepted, got.total_utility, got.n_jobs) == (0, 0.0, 3)


def test_reactive_without_card_raises(monkeypatch):
    """``device=None`` is the card for every scheduler: without one a
    reactive run raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pc = workload.make_cluster(T=10, H=2, K=2)
    pjobs = workload.make_jobs(3, T=10, seed=0, small=True)
    for call in (lambda: engine.run(pc, pjobs, scheduler="dorm"),
                 lambda: engine.run_stream(pc, iter(pjobs), scheduler="rrh"),
                 lambda: simulator.simulate(pc, pjobs, scheduler="fifo")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()

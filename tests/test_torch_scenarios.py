"""The scenario library on the port against the JAX package.

* its pieces: ``make_hetero_cluster``, ``cancellation_trace``,
  ``StragglerThroughput`` (call by call, with and without detection, and
  its ``rate_matrix``), ``runtime.straggler``, and ``PriceParams.scaled``
  / ``alpha``;
* every ``run_scenario(name, quick=True, device="cpu")`` row equals the
  reference's: reactive rows and OASiS rows of the whole route exactly
  (the reference's rows use ``impl="fast"``; serving's OASiS row, which
  the reference runs on ``impl="jax"``, is held to a direct
  ``impl="fast"`` run); the tiled route's OASiS rows (heterogeneous
  fleet, stragglers, misestimated bounds, cancellations) have the
  reference's tiled engine's (``impl="jax"``) completions and utility
  within rel 1e-9;
* the paper's claims on the port: OASiS beats every reactive baseline
  under scarcity, and its utility is within the competitive ratio
  ``2 alpha`` of the offline optimum (the reference's ``offline_optimum``
  on the port's trajectory).
"""
import doctest
import importlib

import numpy as np
import pytest

from repro.core.offline_opt import offline_optimum
from repro.core.pricing import price_params_from_jobs as ref_params
from repro.runtime import straggler as ref_straggler
from repro.sim import engine as ref_engine
from repro.sim import make_cluster, make_jobs, stream_jobs
from repro.sim import scenarios as ref_scenarios
from repro_torch import compat
from repro_torch.core.oasis import OASiS
from repro_torch.core.pricing import price_params_from_jobs
from repro_torch.runtime import straggler
from repro_torch.sim import engine, scenarios, simulator, workload

from _torch_parity import jax_shims, one_torch_thread  # noqa: F401

_ROW_FIELDS = ("scenario", "scheduler", "variant", "utility", "accepted",
               "completed", "canceled", "utilization", "retention",
               "preempted", "preempt_dropped", "live_frac", "window_bytes",
               "n_jobs")


def _same_row(got, want):
    for f in _ROW_FIELDS:
        assert getattr(got, f) == getattr(want, f), (want.scheduler,
                                                     want.variant, f)


@pytest.mark.parametrize("seed", [0, 1, 4])
def test_hetero_cluster_and_cancellations_match_reference(seed):
    want = ref_scenarios.make_hetero_cluster(T=50, H=17, K=9, seed=seed)
    got = scenarios.make_hetero_cluster(T=50, H=17, K=9, seed=seed)
    assert np.array_equal(got.worker_caps, want.worker_caps)
    assert np.array_equal(got.ps_caps, want.ps_caps)
    assert len(np.unique(got.worker_caps[:, 0])) > 1
    jobs = make_jobs(40, T=60, seed=seed)
    assert scenarios.cancellation_trace(
        workload.make_jobs(40, T=60, seed=seed), frac=0.3, seed=seed) == \
        ref_scenarios.cancellation_trace(jobs, frac=0.3, seed=seed)


@pytest.mark.parametrize("detect", [False, True])
def test_straggler_factors_match_reference(detect):
    """Call by call in one order (the detected model is stateful); the
    stateless model's ``rate_matrix`` equals its calls and the
    reference's."""
    jobs = make_jobs(6, T=30, seed=3, small=True)
    pjobs = workload.make_jobs(6, T=30, seed=3, small=True)
    kw = dict(seed=3, slow_frac=0.4, slowdown=4.0, detect=detect)
    ref, port = ref_scenarios.StragglerThroughput(**kw), \
        scenarios.StragglerThroughput(**kw)
    assert port.stateless == (not detect)
    for slot in range(12):
        for rj, pj in zip(jobs, pjobs):
            n = 1 + (slot + rj.jid) % rj.num_chunks
            assert port(pj, n, slot) == ref(rj, n, slot)
    if detect:
        with pytest.raises(RuntimeError):
            port.rate_matrix(pjobs[0], 2, 0, 4)
        return
    m = port.rate_matrix(pjobs[0], 4, 7, 9)
    assert np.array_equal(m, ref.rate_matrix(jobs[0], 4, 7, 9))
    fresh = scenarios.StragglerThroughput(**kw)
    assert np.array_equal(m, [fresh(pjobs[0], 4, 7 + i) for i in range(9)])


def test_runtime_straggler_matches_reference():
    rng = np.random.default_rng(0)
    ref_m = ref_straggler.StragglerMonitor(6)
    port_m = straggler.StragglerMonitor(6)
    for _ in range(40):
        w, dt = int(rng.integers(0, 6)), float(rng.uniform(0.5, 4.0))
        ref_m.record(w, dt)
        port_m.record(w, dt)
        assert port_m.stragglers() == ref_m.stragglers()
        assert port_m.healthy_workers() == ref_m.healthy_workers()
    assert np.array_equal(port_m.emas, ref_m.emas)
    q = straggler.BoundedStaleness(2)
    assert [q.push(g) for g in range(5)] == [None, None, 0, 1, 2]


@pytest.mark.parametrize("floor_frac", [0.0, 0.05])
def test_price_params_scaled_and_alpha_match_reference(floor_frac):
    cluster = make_cluster(T=60, H=12, K=12)
    jobs = make_jobs(40, T=60, seed=2)
    want = ref_params(jobs, cluster, floor_frac=floor_frac)
    got = price_params_from_jobs(workload.make_jobs(40, T=60, seed=2),
                                 workload.make_cluster(T=60, H=12, K=12),
                                 floor_frac=floor_frac)
    assert got.alpha == want.alpha
    for f in (0.25, 1.0, 4.0):
        a, b = got.scaled(f), want.scaled(f)
        assert np.array_equal(a.U1, b.U1) and np.array_equal(a.U2, b.U2)
        assert (a.L1, a.L2) == (b.L1, b.L2)


@pytest.mark.parametrize("name", ["hetero", "cancel", "straggler", "misest",
                                  "scale", "churn"])
def test_quick_scenario_rows_equal_reference(name):
    """Every row of the quick scenario, in order: the reactive rows and
    the whole route's OASiS rows exactly."""
    want = ref_scenarios.run_scenario(name, quick=True)
    got = scenarios.run_scenario(name, quick=True, device="cpu")
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _same_row(g, w)


def test_quick_serving_rows_equal_reference():
    """The reactive rows against the reference's; the OASiS row against a
    direct ``impl="fast"`` run of the reference on the same stream (its
    own row runs ``impl="jax"``)."""
    got = scenarios.run_scenario("serving", quick=True, device="cpu")
    want = ref_scenarios.run_scenario("serving", quick=True,
                                      schedulers=ref_scenarios.REACTIVE)
    assert [r.scheduler for r in got] == ["oasis"] + [r.scheduler
                                                       for r in want]
    for g, w in zip(got[1:], want):
        _same_row(g, w)
    dims = ref_scenarios.SERVING_DIMS_QUICK
    fast = ref_engine.run_stream(
        make_cluster(T=dims["window"], H=dims["H"], K=dims["K"]),
        stream_jobs(rate=dims["rate"], seed=0, max_slots=dims["slots"],
                    small=True),
        window=dims["window"], quantum=0, check=True, impl="fast")
    oasis = got[0]
    assert oasis.completion == fast.completion
    assert (oasis.utility, oasis.accepted, oasis.completed,
            oasis.utilization, oasis.n_jobs) == (
        fast.total_utility, fast.accepted, fast.completed,
        fast.utilization, fast.n_jobs)
    assert oasis.window_bytes == fast.window_bytes


def _reference_tiled_runs(name):
    """(variant, cluster, jobs, run kwargs) of the quick scenario ``name``'s
    OASiS rows, built as the reference's runner builds them."""
    if name == "hetero":
        return [("mixed-fleet",
                 ref_scenarios.make_hetero_cluster(T=60, H=20, K=20, seed=0),
                 make_jobs(40, T=60, seed=0, small=True), {})]
    T, H, n = (60, 16, 30) if name == "straggler" else (60, 16, 40)
    cluster = make_cluster(T=T, H=H, K=H)
    jobs = make_jobs(n, T=T, seed=0, small=True)
    if name == "cancel":
        return [("none", cluster, jobs, {}),
                ("frac=0.25", cluster, jobs, {
                    "cancellations": ref_scenarios.cancellation_trace(
                        jobs, frac=0.25, seed=0)})]
    if name == "misest":
        exact = ref_params(jobs, cluster)
        return [(f"x{f}", cluster, jobs, {"params": exact.scaled(f)})
                for f in (0.25, 0.5, 1.0, 2.0, 4.0)]
    return [("none", cluster, jobs, {})] + [
        (label, cluster, jobs, {"throughput":
                                ref_scenarios.StragglerThroughput(
                                    seed=0, slow_frac=0.15, slowdown=3.0,
                                    detect=detect)})
        for detect, label in [(False, "undetected"), (True, "detected")]]


@pytest.mark.parametrize("name", ["hetero", "straggler", "misest",
                                  "cancel"])
def test_tiled_oasis_rows_match_reference_tiled_engine(jax_shims, name):
    """Every quick OASiS row of the tiled route against the reference's
    tiled engine on the same instance: the heterogeneous fleet (unequal
    worker rows through the tiled route's padded state), stragglers,
    misestimated price bounds (``PriceParams.scaled``) and
    cancellations."""
    rows = {r.variant: r for r in scenarios.run_scenario(
        name, quick=True, device="cpu", core="tiled")
        if r.scheduler == "oasis"}
    runs = _reference_tiled_runs(name)
    assert sorted(rows) == sorted(v for v, *_ in runs)
    for variant, cluster, jobs, kw in runs:
        want = ref_engine.run(cluster, jobs, impl="jax", quantum=0,
                              check=False, **kw)
        got = rows[variant]
        assert got.completion == want.completion, variant
        assert (got.accepted, got.completed, got.canceled) == (
            want.accepted, want.completed, want.canceled), variant
        assert got.utility == pytest.approx(want.total_utility, rel=1e-9)


def test_full_size_misest_routes_match_reference_engines(jax_shims):
    """At the full misest size (T 100, H = K = 20, 60 full-size jobs) the
    two routes part at x0.25 and x4: each follows its reference engine,
    the whole route ``impl="fast"`` exactly, the tiled route the tiled
    engine (``impl="jax"``)."""
    cluster, jobs = make_cluster(T=100, H=20, K=20), make_jobs(
        60, T=100, seed=0, small=False)
    exact = ref_params(jobs, cluster)
    pc, pjobs = compat.cluster(cluster), [compat.job(j) for j in jobs]
    pexact = price_params_from_jobs(pjobs, pc)
    parted = 0
    for f in (0.25, 4.0):
        fast, tiled_ref = (ref_engine.run(cluster, jobs, impl=impl, quantum=0,
                                          check=False,
                                          params=exact.scaled(f))
                           for impl in ("fast", "jax"))
        whole, tiled = (engine.run(pc, pjobs, quantum=0, check=False,
                                   device="cpu", core=core,
                                   params=pexact.scaled(f))
                        for core in ("whole", "tiled"))
        assert whole.completion == fast.completion, f
        assert whole.total_utility == fast.total_utility, f
        assert tiled.completion == tiled_ref.completion, f
        assert tiled.total_utility == pytest.approx(tiled_ref.total_utility,
                                                    rel=1e-9)
        parted += whole.completion != tiled.completion
    assert parted == 2


def test_oasis_beats_baselines_under_scarcity():
    """Fig. 3's claim on the port: mean total utility over seeds 2..4 at
    T=100, H=K=20, 60 full-size jobs."""
    results = {}
    for seed in (2, 3, 4):
        cluster = workload.make_cluster(T=100, H=20, K=20)
        jobs = workload.make_jobs(60, T=100, seed=seed, small=False)
        for name in ("oasis",) + scenarios.REACTIVE:
            kw = dict(quantum=0) if name == "oasis" else {}
            r = simulator.simulate(cluster, jobs, scheduler=name, check=True,
                                   device="cpu", **kw)
            results.setdefault(name, []).append(r.total_utility)
    means = {k: float(np.mean(v)) for k, v in results.items()}
    assert means["oasis"] >= max(v for k, v in means.items()
                                 if k != "oasis"), means


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_competitive_ratio_bound(seed):
    """Theorem 4 on the port's trajectory: OPT / online lies in [1,
    2 alpha], with the literal (unfloored) U/L and the port's alpha."""
    cluster = make_cluster(T=6, H=2, K=2, scale=0.6)
    jobs = make_jobs(5, T=6, seed=seed, small=True)
    pc = compat.cluster(cluster)
    params = price_params_from_jobs([compat.job(j) for j in jobs], pc,
                                    floor_frac=0.0)
    sched = OASiS(pc, params, device="cpu")
    for j in sorted(jobs, key=lambda x: x.arrival):
        sched.on_arrival(compat.job(j))
    online = sched.total_utility
    opt = offline_optimum(cluster, jobs, time_limit=60.0)
    assert opt >= online - 1e-6 * max(1.0, abs(opt))
    if online > 1e-9:
        assert opt / online <= 2 * params.alpha + 1e-6


def test_learned_in_scale_is_refused(tmp_path):
    """A ``"learned"`` row runs the default policy, or the checkpoint at
    ``policy_ckpt``; a path with no checkpoint is refused, as in the
    reference."""
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        scenarios.run_scale(T=30, H=4, K=4, n=6, schedulers=("learned",),
                            device="cpu", policy_ckpt=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ref_scenarios.run_scale(T=30, H=4, K=4, n=6,
                                schedulers=("learned",),
                                policy_ckpt=str(tmp_path))
    row, = scenarios.run_scale(T=30, H=4, K=4, n=6, schedulers=("learned",),
                               device="cpu")
    assert row.scheduler == "learned" and row.accepted <= 6


@pytest.mark.parametrize("name", ["repro_torch.sim.scenarios",
                                  "repro_torch.sim.simulator"])
def test_port_doctests(name):
    result = doctest.testmod(importlib.import_module(name),
                             optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0 and result.failed == 0, result

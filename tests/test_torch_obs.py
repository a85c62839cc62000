"""The port's flight recorder (``repro_torch.obs``) against the JAX
package's (``repro.obs``).

* **Unit tests.**  Every test of ``tests/test_obs.py`` on the port's
  classes: spans nest and time, the ring bounds memory and counts drops,
  the Chrome and JSONL exports, the registry, scoped and global
  activation, the disabled helpers' cost, and the engine integration
  (``engine.run(..., obs=)`` / ``run_stream(..., obs=)``) on both
  decision routes, on the CPU: an enabled run is bit-identical to a
  disabled one and a disabled run emits nothing.
* **Recorder parity.**  One seeded sequence of ``span`` / ``event`` /
  ``inc`` / ``observe`` / ``set_gauge`` calls into both packages' ``Obs``
  gives equal metrics snapshots and equal Chrome and JSONL exports once
  the clock fields (``ts``, ``dur``), the process and thread ids and the
  category (``cat``, which names the package) are dropped.
* **Run parity.**  The same instance through both engines, each with a
  recorder: the port's whole route against the reference's
  ``impl="fast"``, its tiled route against ``impl="jax"`` (the tiled
  engine the reference takes off the TPU), and the reactive baselines.
  The counters are equal, the histogram counts are equal, and so are the
  multisets of span names, but for three differences, each named where
  it is folded in (``_expected_counters``).
* **The decision-stage profile** (``REPRO_DECIDE_PROFILE``) leaves the
  tiled route's decisions unchanged, and **the CLI**
  (``python -m repro_torch.launch.cluster_sim``) records a trace and
  prints the reference's scenario rows.
"""
import collections
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import jax_shims, one_torch_thread  # noqa: F401
from repro import obs as ref_obs
from repro.sim import engine as ref_engine
from repro.sim import scenarios as ref_scenarios
from repro.sim.fleet import make_fleet_trace as ref_fleet_trace
from repro.sim.workload import make_cluster as ref_make_cluster
from repro.sim.workload import make_jobs as ref_make_jobs
from repro.sim.workload import stream_jobs as ref_stream_jobs
from repro_torch import obs as obslib
from repro_torch.core import schedule_torch as st
from repro_torch.core.oasis import BURST_MIN
from repro_torch.launch import cluster_sim
from repro_torch.obs.metrics import Histogram, Registry
from repro_torch.obs.trace import NULL_SPAN, Tracer
from repro_torch.sim import engine
from repro_torch.sim.fleet import make_fleet_trace
from repro_torch.sim.workload import make_cluster, make_jobs, stream_jobs

ROOT = Path(__file__).resolve().parent.parent
CORES = ("whole", "tiled")


@pytest.fixture(autouse=True)
def _no_leak():
    """Every test leaves both packages' process-global recorders
    uninstalled."""
    yield
    assert obslib.ENABLED is False and obslib.current() is None
    assert ref_obs.ENABLED is False and ref_obs.current() is None


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def test_spans_nest_and_record_duration():
    tr = Tracer()
    with tr.span("outer", jid=1):
        with tr.span("inner"):
            time.sleep(0.001)
    evs = list(tr.events())
    assert [e["name"] for e in evs] == ["inner", "outer"]
    inner, outer = evs
    assert inner["depth"] == 1 and outer["depth"] == 0
    assert outer["dur_us"] >= inner["dur_us"] > 0
    assert outer["ts_us"] <= inner["ts_us"]
    assert (inner["ts_us"] + inner["dur_us"]
            <= outer["ts_us"] + outer["dur_us"])
    assert outer["args"] == {"jid": 1}


def test_span_set_merges_attrs():
    tr = Tracer()
    with tr.span("s", a=1) as sp:
        sp.set(b=2)
    (ev,) = tr.events()
    assert ev["args"] == {"a": 1, "b": 2}


def test_ring_bounds_memory_and_counts_drops():
    tr = Tracer(capacity=4)
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    assert len(tr) == 4
    assert tr.dropped == 6
    assert [e["name"] for e in tr.events()] == ["s6", "s7", "s8", "s9"]
    tr.clear()
    assert len(tr) == 0 and tr.dropped == 0


def test_chrome_export_schema(tmp_path):
    tr = Tracer()
    with tr.span("decide", jid=7, core="tiled"):
        with tr.span("dp_sweep", arr=np.arange(3)):   # non-scalar arg
            pass
    tr.instant("stream_advance", t=128)
    path = tmp_path / "trace.json"
    n = tr.export_chrome(str(path), metrics={"counters": {"x": 1}})
    assert n == 3
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    assert doc["metrics"] == {"counters": {"x": 1}}
    evs = doc["traceEvents"]
    assert len(evs) == 3
    for ev in evs:
        assert set(ev) >= {"name", "cat", "ph", "ts", "pid", "tid"}
        assert ev["cat"] == "repro_torch"
        assert isinstance(ev["ts"], (int, float))
    complete = [e for e in evs if e["ph"] == "X"]
    instants = [e for e in evs if e["ph"] == "i"]
    assert len(complete) == 2 and len(instants) == 1
    for ev in complete:
        assert ev["dur"] >= 0
    assert instants[0]["s"] == "t"
    for ev in evs:
        for v in ev.get("args", {}).values():
            assert isinstance(v, (int, float, bool, str, type(None)))
    by_name = {e["name"]: e for e in complete}
    parent, child = by_name["decide"], by_name["dp_sweep"]
    assert parent["ts"] <= child["ts"]
    assert child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + 1e-6


def test_jsonl_export_round_trips(tmp_path):
    tr = Tracer()
    with tr.span("a", k="v"):
        pass
    path = tmp_path / "t.jsonl"
    assert tr.export_jsonl(str(path)) == 1
    (line,) = path.read_text().splitlines()
    ev = json.loads(line)
    assert ev["name"] == "a" and ev["args"] == {"k": "v"}


def test_dropped_events_recorded_in_chrome_export(tmp_path):
    tr = Tracer(capacity=2)
    for i in range(5):
        tr.instant(f"e{i}")
    path = tmp_path / "trace.json"
    tr.export_chrome(str(path))
    doc = json.loads(path.read_text())
    assert doc["otherData"] == {"dropped_events": 3}


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_counters_gauges_histograms_snapshot_roundtrip():
    reg = Registry()
    reg.inc("a")
    reg.inc("a", 2)
    reg.set_gauge("g", 0.5)
    reg.observe("h", 0.002)
    reg.observe("h", 5.0)
    snap = reg.snapshot()
    assert snap["counters"] == {"a": 3}
    assert snap["gauges"] == {"g": 0.5}
    h = snap["histograms"]["h"]
    assert h["count"] == 2
    assert h["sum"] == pytest.approx(5.002)
    assert sum(h["counts"]) == 2
    assert len(h["counts"]) == len(h["edges"]) + 1   # +Inf overflow
    snap["counters"]["a"] = 99
    assert reg.snapshot()["counters"]["a"] == 3
    reg.reset()
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_histogram_buckets_cover_range():
    h = Histogram(edges=(0.1, 1.0))
    for v in (0.05, 0.5, 50.0):
        h.observe(v)
    d = h.to_dict()
    assert d["count"] == 3
    assert d["counts"] == [1, 1, 1]        # <=0.1, (0.1,1.0], +Inf
    assert d["sum"] == pytest.approx(50.55)
    with pytest.raises(ValueError):
        Histogram(edges=(1.0, 0.1))        # unsorted edges refused


def test_registry_validate_flags_non_finite():
    reg = Registry()
    reg.inc("ok")
    assert reg.validate() == []
    reg.set_gauge("bad", float("nan"))
    assert any("bad" in p for p in reg.validate())


# ---------------------------------------------------------------------------
# activation + the disabled-mode contract
# ---------------------------------------------------------------------------

def test_disabled_helpers_are_noops():
    assert obslib.span("x") is NULL_SPAN
    with obslib.span("x") as sp:
        sp.set(a=1)
    obslib.inc("c")
    obslib.observe("h", 1.0)
    obslib.set_gauge("g", 1.0)
    obslib.event("e")
    assert obslib.current() is None and obslib.ENABLED is False


def test_activate_scopes_and_restores():
    ob = obslib.Obs()
    with obslib.activate(ob):
        assert obslib.ENABLED and obslib.current() is ob
        obslib.inc("k")
        inner = obslib.Obs()
        with obslib.activate(inner):
            assert obslib.current() is inner
        assert obslib.current() is ob and obslib.ENABLED
    assert obslib.ENABLED is False and obslib.current() is None
    assert ob.metrics.snapshot()["counters"] == {"k": 1}
    with obslib.activate(None) as got:
        assert got is None and obslib.ENABLED is False


def test_enable_disable_process_global():
    ob = obslib.enable()
    try:
        assert obslib.ENABLED and obslib.current() is ob
        obslib.inc("n")
    finally:
        obslib.disable()
    assert ob.metrics.snapshot()["counters"] == {"n": 1}


def test_disabled_overhead_micro_pin():
    """The disabled fast path stays allocation-free and cheap: one module
    global read per emission (the reference's loose 50x pin)."""
    N = 20000
    t0 = time.perf_counter()
    acc = 0.0
    for _ in range(N):
        acc += 1.0
    base = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(N):
        obslib.inc("c")
        obslib.span("s")
    cost = time.perf_counter() - t0
    assert cost < max(50 * base, 0.05), (cost, base)


# ---------------------------------------------------------------------------
# engine integration, both routes, on the CPU
# ---------------------------------------------------------------------------

def _instance(T=24, HK=3, n=8):
    cluster = make_cluster(T=T, H=HK, K=HK)
    return cluster, make_jobs(n, T=T, seed=0, small=True)


def _same_run(a, b):
    """Bit-identical results: digest, completions, every placement."""
    assert a.summary() == b.summary()
    assert a.completion == b.completion
    assert a.decision_seconds and len(a.decision_seconds) == len(
        b.decision_seconds)
    assert sorted(a.schedules) == sorted(b.schedules)
    for jid, s in a.schedules.items():
        o = b.schedules[jid]
        assert (s.finish, s.cost, s.utility) == (o.finish, o.cost, o.utility)
        assert sorted(s.workers) == sorted(o.workers)
        for t in s.workers:
            assert np.array_equal(s.workers[t], o.workers[t])
            assert np.array_equal(s.ps[t], o.ps[t])


@pytest.mark.parametrize("core", CORES)
def test_enabled_run_bit_identical_and_emits_catalog(core):
    cluster, jobs = _instance()
    r0 = engine.run(cluster, jobs, device="cpu", core=core)
    ob = obslib.Obs()
    r1 = engine.run(cluster, jobs, device="cpu", core=core, obs=ob)
    _same_run(r0, r1)
    c = ob.metrics.snapshot()["counters"]
    assert c["decide.decisions"] == r1.n_jobs
    assert c["engine.arrivals"] == r1.n_jobs
    assert c["price.commits"] == r1.accepted
    assert c["price.device_uploads"] == 1
    names = {e["name"] for e in ob.tracer.events()}
    assert {"decide", "price.commit"} <= names
    # observed per proposal, as in the reference: a burst's decisions
    # (tiled route) count in decide.decisions only
    hist = ob.metrics.snapshot()["histograms"]["decide.seconds"]
    n_decide = sum(e["name"] == "decide" for e in ob.tracer.events())
    assert hist["count"] == n_decide
    if core == "tiled":
        assert {"decide.dp_sweep", "decide.backtrack",
                "decide.placement", "decide_burst"} <= names
        assert c["decide.launches"] >= c["decide.decisions"]
        assert 0 < c["decide.tiles_visited"] <= c["decide.tiles_horizon"]
    else:
        assert n_decide == c["decide.decisions"]
        assert [k for k in c if k.startswith("decide.")] == [
            "decide.decisions"]


@pytest.mark.parametrize("core", CORES)
def test_disabled_run_emits_nothing(core):
    cluster, jobs = _instance()
    ob = obslib.Obs()
    with obslib.activate(ob):
        pass                                # installed, but no run inside
    engine.run(cluster, jobs, device="cpu", core=core)
    assert len(ob.tracer) == 0
    assert ob.metrics.snapshot()["counters"] == {}


def test_reactive_run_records_repack_and_ffwd():
    cluster, jobs = _instance()
    ob = obslib.Obs()
    r = engine.run(cluster, jobs, scheduler="drf", device="cpu", obs=ob)
    c = ob.metrics.snapshot()["counters"]
    assert c["engine.completions"] == r.completed
    assert c["engine.ffwd_slots"] >= 1
    names = {e["name"] for e in ob.tracer.events()}
    assert {"repack", "ffwd"} <= names
    assert len(r.decision_seconds) >= 1
    assert all(d >= 0 for d in r.decision_seconds)


def _churn_instance(mk_cluster=make_cluster, mk_jobs=make_jobs,
                    mk_fleet=make_fleet_trace):
    cluster = mk_cluster(T=48, H=6, K=6)
    jobs = mk_jobs(24, T=48, seed=0, small=True)
    fleet = mk_fleet(cluster, seed=1, mtbf=cluster.T / 1.6,
                     mttr=cluster.T / 12)
    return cluster, jobs, fleet


@pytest.mark.parametrize("scheduler", ["dorm", "oasis-whole", "oasis-tiled"])
def test_churn_run_records_preemptions_and_live_frac(scheduler):
    cluster, jobs, fleet = _churn_instance()
    sched, _, core = scheduler.partition("-")
    kw = dict(scheduler=sched, device="cpu", core=core or "whole")
    ob = obslib.Obs()
    r = engine.run(cluster, jobs, fleet=fleet, obs=ob, **kw)
    c = ob.metrics.snapshot()["counters"]
    assert c.get("engine.preemptions", 0) == r.preempted > 0
    assert c.get("engine.preempt_dropped", 0) == r.preempt_dropped
    assert "churn_step" in {e["name"] for e in ob.tracer.events()}
    s = r.summary()
    assert s["preempted"] == r.preempted
    assert s["preempt_dropped"] == r.preempt_dropped
    assert 0.0 < s["live_frac"] <= 1.0
    r0 = engine.run(cluster, jobs, fleet=fleet, **kw)
    assert r0.summary() == s and r0.completion == r.completion
    assert engine.run(cluster, jobs, **kw).summary()["live_frac"] == 1.0
    if sched == "oasis":
        assert c["price.server_blocks"] > 0
        assert c["price.releases"] >= r.preempted


@pytest.mark.parametrize("core", CORES)
def test_stream_run_bit_identical_and_counts(core):
    cluster, jobs = _instance()
    r0 = engine.run_stream(cluster, iter(jobs), device="cpu", core=core)
    ob = obslib.Obs()
    r1 = engine.run_stream(cluster, iter(jobs), device="cpu", core=core,
                           obs=ob)
    assert r0.summary() == r1.summary() and r0.completion == r1.completion
    c = ob.metrics.snapshot()["counters"]
    assert c["engine.arrivals"] == r1.n_jobs
    assert c["price.window_advances"] >= 1
    assert c["price.device_uploads"] == r1.device_uploads == 1
    assert "stream_advance" in {e["name"] for e in ob.tracer.events()}


@pytest.mark.parametrize("core", CORES)
def test_obs_export_embeds_metrics(tmp_path, core):
    cluster, jobs = _instance()
    ob = obslib.Obs()
    engine.run(cluster, jobs, device="cpu", core=core, obs=ob)
    path = tmp_path / "run.json"
    n = ob.export_chrome(str(path))
    doc = json.loads(path.read_text())
    assert len(doc["traceEvents"]) == n > 0
    assert doc["metrics"]["counters"]["decide.decisions"] >= 1


def test_policy_run_records_inside_the_scope():
    """``policy=``: the decision generator is made and exhausted inside
    the recorder's scope."""
    cluster, jobs = _instance()
    ob = obslib.Obs()
    r = engine.run(cluster, jobs, device="cpu", obs=ob,
                   policy=lambda dp: dp.expert)
    c = ob.metrics.snapshot()["counters"]
    assert c["decide.decisions"] == c["engine.arrivals"] == r.n_jobs
    assert c["price.commits"] == r.accepted


# ---------------------------------------------------------------------------
# recorder parity with the reference
# ---------------------------------------------------------------------------

def _drive(lib, seed, capacity):
    """One seeded sequence of recorder calls through ``lib``'s module
    helpers, into a fresh ``Obs`` of that package."""
    rng = np.random.default_rng(seed)
    names = ["decide", "price.commit", "repack", "ffwd", "decide.dp_sweep"]
    ob = lib.Obs(capacity=capacity)

    def attrs():
        out = {}
        for k in rng.choice(["jid", "t", "core", "frac", "arr"],
                            size=int(rng.integers(0, 3)), replace=False):
            out[str(k)] = {"jid": int(rng.integers(0, 99)),
                           "t": int(rng.integers(0, 500)),
                           "core": "tiled", "frac": float(rng.random()),
                           "arr": np.arange(int(rng.integers(1, 4)))}[k]
        return out

    def step(depth):
        for _ in range(int(rng.integers(1, 5))):
            op = int(rng.integers(0, 6))
            name = names[int(rng.integers(0, len(names)))]
            if op == 0 and depth < 3:
                with lib.span(name, **attrs()) as sp:
                    step(depth + 1)
                    if rng.random() < 0.5:
                        sp.set(**attrs())
            elif op == 1:
                lib.event(name, **attrs())
            elif op == 2:
                lib.inc(name + ".n", int(rng.integers(1, 4)))
            elif op == 3:
                lib.observe(name + ".s", float(rng.random() * 10 ** int(
                    rng.integers(-5, 2))))
            elif op == 4:
                lib.set_gauge(name + ".g", float(rng.random()))
            else:
                lib.observe("decide.early_exit_frac", float(rng.random()))

    with lib.activate(ob):
        for _ in range(40):
            step(0)
    return ob


def _strip(ev, keys):
    return {k: v for k, v in ev.items() if k not in keys}


@pytest.mark.parametrize("seed,capacity", [(0, 65536), (1, 65536), (2, 16)])
def test_recorder_parity_with_reference(tmp_path, seed, capacity):
    ref = _drive(ref_obs, seed, capacity)
    got = _drive(obslib, seed, capacity)
    assert got.metrics.snapshot() == ref.metrics.snapshot()
    assert got.metrics.validate() == ref.metrics.validate() == []
    assert len(got.tracer) == len(ref.tracer) > 0
    assert got.tracer.dropped == ref.tracer.dropped
    assert (capacity < 65536) == (got.tracer.dropped > 0)
    docs = []
    for ob, tag in ((ref, "ref"), (got, "port")):
        path = tmp_path / f"{tag}.json"
        ob.export_chrome(str(path))
        doc = json.loads(path.read_text())
        doc["traceEvents"] = [_strip(e, ("ts", "dur", "pid", "tid", "cat"))
                              for e in doc["traceEvents"]]
        jl = tmp_path / f"{tag}.jsonl"
        ob.tracer.export_jsonl(str(jl))
        lines = [_strip(json.loads(x), ("ts_us", "dur_us"))
                 for x in jl.read_text().splitlines()]
        docs.append((doc, lines))
    assert docs[0] == docs[1]


# ---------------------------------------------------------------------------
# run parity with the reference
# ---------------------------------------------------------------------------

def _expected_counters(ref: dict, route: str) -> dict:
    """The reference's counters as the port should count them.

    * ``decide.jit_cold_launches`` is dropped: nothing in the port is
      compiled per launch shape.
    * ``decide.pad_patch`` folds into ``decide.pad_full``: the port
      re-pads the padded state in full where the reference patches it.
    * On the whole route the reference's ``impl="fast"`` prices on the
      host and never uploads a price state, while the port's route decides
      on the state's residency: one ``price.device_uploads``."""
    want = dict(ref)
    want.pop("decide.jit_cold_launches", None)
    patched = want.pop("decide.pad_patch", 0)
    if patched:
        want["decide.pad_full"] = want.get("decide.pad_full", 0) + patched
    if route == "whole":
        assert "price.device_uploads" not in want
        want["price.device_uploads"] = 1
    return want


def _span_names(ob):
    c = collections.Counter(e["name"] for e in ob.tracer.events())
    c.pop("jit_cold_compile", None)
    return c


def _hist_counts(ob):
    return {k: h["count"]
            for k, h in ob.metrics.snapshot()["histograms"].items()}


def _burst_jobs(mk_jobs):
    """Same-slot bursts of at least ``BURST_MIN`` jobs over three tiles:
    the tiled route re-solves through row caches, some of their tiles
    still valid."""
    jobs = mk_jobs(30, T=200, seed=0, small=True)
    return [dataclasses.replace(j, arrival=(j.arrival // 50) * 50)
            for j in jobs]


def _run_pair(which, route, scheduler="oasis"):
    """(reference result and recorder, port result and recorder)."""
    impl = {"whole": "fast", "tiled": "jax"}[route]
    kw_ref = dict(impl=impl) if scheduler == "oasis" else {}
    kw_port = dict(core=route, device="cpu")
    ro, po = ref_obs.Obs(), obslib.Obs()
    if which == "stream":
        cl_r, cl_p = (mk(T=24, H=3, K=3)
                      for mk in (ref_make_cluster, make_cluster))
        r = ref_engine.run_stream(
            cl_r, itertools.islice(ref_stream_jobs(rate=0.5, seed=1,
                                                   small=True), 30),
            scheduler=scheduler, window=16, obs=ro, **kw_ref)
        p = engine.run_stream(
            cl_p, itertools.islice(stream_jobs(rate=0.5, seed=1, small=True),
                                   30),
            scheduler=scheduler, window=16, obs=po, **kw_port)
        return r, ro, p, po
    if which == "churn":
        (cl_r, jobs_r, fl_r), (cl_p, jobs_p, fl_p) = (
            _churn_instance(ref_make_cluster, ref_make_jobs,
                            ref_fleet_trace), _churn_instance())
        kw_ref["fleet"], kw_port["fleet"] = fl_r, fl_p
    elif which == "burst":
        cl_r, cl_p = (mk(T=200, H=2, K=2)
                      for mk in (ref_make_cluster, make_cluster))
        jobs_r, jobs_p = _burst_jobs(ref_make_jobs), _burst_jobs(make_jobs)
    else:
        cl_r, cl_p = (mk(T=24, H=3, K=3)
                      for mk in (ref_make_cluster, make_cluster))
        jobs_r, jobs_p = (mk(8, T=24, seed=0, small=True)
                          for mk in (ref_make_jobs, make_jobs))
    r = ref_engine.run(cl_r, jobs_r, scheduler=scheduler, obs=ro, **kw_ref)
    p = engine.run(cl_p, jobs_p, scheduler=scheduler, obs=po, **kw_port)
    return r, ro, p, po


def _assert_parity(r, ro, p, po, route):
    assert p.completion == r.completion
    assert p.total_utility == r.total_utility
    got = po.metrics.snapshot()["counters"]
    assert got == _expected_counters(ro.metrics.snapshot()["counters"],
                                     route)
    assert _hist_counts(po) == _hist_counts(ro)
    assert _span_names(po) == _span_names(ro)
    return got


@pytest.mark.parametrize("which", ["instance", "churn", "stream", "burst"])
@pytest.mark.parametrize("route", CORES)
def test_oasis_counters_equal_reference(jax_shims, which, route):  # noqa: F811
    got = _assert_parity(*_run_pair(which, route), route)
    assert got["price.device_uploads"] == 1
    assert got["decide.decisions"] >= got["engine.arrivals"] > 0
    if route == "tiled":
        assert got["decide.launches"] > 0
        assert got["decide.pad_full"] > 0
    if which == "churn":
        assert got["engine.preemptions"] > 0
    if which == "stream":
        assert got["price.window_slots_retired"] > 0
    if which == "burst":
        assert min(collections.Counter(
            j.arrival for j in _burst_jobs(make_jobs)).values()) >= BURST_MIN
        if route == "tiled":
            assert got["decide.row_cache_syncs"] > 0
            assert 0 < got["decide.cache_tiles_valid"] < got[
                "decide.cache_tiles_total"]


@pytest.mark.parametrize("which", ["instance", "churn", "stream"])
@pytest.mark.parametrize("scheduler", ["fifo", "drf", "rrh", "dorm"])
def test_reactive_counters_equal_reference(which, scheduler):
    r, ro, p, po = _run_pair(which, "tiled", scheduler)
    assert p.completion == r.completion
    assert p.total_utility == r.total_utility
    got = po.metrics.snapshot()["counters"]
    assert got == ro.metrics.snapshot()["counters"]
    assert got["engine.ffwd_slots"] > 0
    assert _hist_counts(po) == _hist_counts(ro)
    assert _span_names(po) == _span_names(ro)
    if scheduler == "dorm":
        assert got["repack.rounds"] > 0


# ---------------------------------------------------------------------------
# the decision-stage profile and the CLI
# ---------------------------------------------------------------------------

def test_decide_profile_leaves_tiled_decisions_unchanged(monkeypatch):
    cluster = make_cluster(T=200, H=2, K=2)
    jobs = _burst_jobs(make_jobs)
    monkeypatch.delenv("REPRO_DECIDE_PROFILE", raising=False)
    st.decide_profile_reset()
    r0 = engine.run(cluster, jobs, device="cpu", core="tiled")
    assert st.decide_profile_snapshot()["decisions"] == 0.0
    monkeypatch.setenv("REPRO_DECIDE_PROFILE", "1")
    ob = obslib.Obs()
    r1 = engine.run(cluster, jobs, device="cpu", core="tiled", obs=ob)
    snap = st.decide_profile_snapshot()
    _same_run(r0, r1)
    assert snap["decisions"] == ob.metrics.snapshot()["counters"][
        "decide.launches"] > 0
    for stage in ("row_build", "dp_sweep", "backtrack", "placement"):
        assert snap[stage] > 0.0, stage
    st.decide_profile_reset()
    assert set(st.decide_profile_snapshot().values()) == {0.0}


def _row_line(r):
    return (f"{r.scheduler:6s} {r.variant:14s} {r.utility:9.1f} "
            f"acc={r.accepted:4d} comp={r.completed:4d} "
            f"util={r.utilization:5.2f} ")


def test_cli_churn_trace_matches_reference(tmp_path):
    path = tmp_path / "churn.json"
    # one torch thread, as in the other tests: the test workers run side
    # by side
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster_sim",
         "--scenario", "churn", "--quick", "--device", "cpu",
         "--trace", str(path)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    doc = json.loads(path.read_text())
    c = doc["metrics"]["counters"]
    for k in ("decide.decisions", "engine.arrivals", "engine.preemptions"):
        assert c[k] > 0, k
    assert {"decide", "churn_step", "repack", "ffwd",
            "price.commit"} <= {e["name"] for e in doc["traceEvents"]}
    assert f"trace events -> {path}" in out.stdout
    want = ref_scenarios.run_scenario("churn", quick=True)
    lines = [ln for ln in out.stdout.splitlines() if " util=" in ln]
    assert len(lines) == len(want)
    for ln, w in zip(lines, want):
        assert ln.startswith(_row_line(w)), (ln, _row_line(w))


def test_cli_scale10x_tiled_profile(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_DECIDE_PROFILE", "0")
    st.decide_profile_reset()
    cluster_sim.main(["--scenario", "scale10x", "--scheduler", "oasis",
                      "--core", "tiled", "--quick", "--profile",
                      "--device", "cpu"])
    text = capsys.readouterr().out
    assert "== scenario: scale10x (seed=0, quick) ==" in text
    assert "decision stage breakdown" in text
    snap = st.decide_profile_snapshot()
    assert snap["decisions"] > 0 and snap["dp_sweep"] > 0
    st.decide_profile_reset()


def test_cli_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster_sim.main(["--jobs", "4", "--T", "20", "--servers", "3",
                          "--seeds", "1"])


def test_cli_refuses_misplaced_flags():
    for argv in (["--scenario", "churn", "--scheduler", "oasis"],
                 ["--scenario", "scale", "--scheduler", "learned"],
                 ["--scenario", "scale", "--policy-ckpt", "x"]):
        with pytest.raises(SystemExit):
            cluster_sim.main(argv)

"""The reactive baselines' placements on the port against the JAX
package's (``core/repack.py``, ``core/baselines.py``).

* ``_place_fast`` places and rolls back exactly as the reference's
  ``_place_fast`` and its per-server scan ``_place_loop``, free
  capacities included;
* the ``step`` of FIFO, DRF, RRH and Dorm gives, at every step of a
  replayed trace, the placements of the reference's ``step_kernel`` and
  of its greedy loops ``step_reference``: paper scale (seeds 0..4),
  full-size jobs, a heterogeneous fleet, both worker counts, randomized
  instances that force full-pool rejections and PS rollbacks, and a
  hand-built PS rollback;
* the ``dirty`` contract: no-op events leave the flag unset, and the
  engine repacks only when it is set.
"""
import numpy as np
import pytest

from repro.core import baselines as ref_baselines
from repro.core.types import ClusterSpec as RefCluster
from repro.core.types import Job as RefJob
from repro.core.types import SigmoidUtility as RefSigmoid
from repro.sim import make_cluster, make_jobs
from repro.sim.scenarios import make_hetero_cluster
from repro_torch import compat
from repro_torch.core import baselines
from repro_torch.core.baselines import BASELINES, DRF, FIFO, RRH
from repro_torch.sim import engine, scenarios, workload

from _torch_parity import one_torch_thread  # noqa: F401

REACTIVE = ["fifo", "drf", "rrh", "dorm"]


def _same_steps(steps, ctx):
    """Every placement map of ``steps`` equals the first's, exactly."""
    a = steps[0]
    for b in steps[1:]:
        assert set(a) == set(b), f"{ctx}: placed-job sets differ"
        for jid in a:
            assert np.array_equal(a[jid][0], b[jid][0]), f"{ctx}: y, {jid}"
            assert np.array_equal(a[jid][1], b[jid][1]), f"{ctx}: z, {jid}"


def _port(cluster, jobs):
    return compat.cluster(cluster), [compat.job(j) for j in jobs]


def _replay(cluster, jobs, name, fixed_workers=8, churn_seed=None):
    """Drive the port's scheduler, and the reference's on its kernels and
    on its greedy loops, through one event sequence; every repack's
    placements must be equal.  Completions follow the port's
    kernel allocation; ``churn_seed`` adds random mid-run completions
    (pool removals)."""
    pc, pjobs = _port(cluster, jobs)
    scheds = [BASELINES[name](pc, fixed_workers=fixed_workers)] + [
        ref_baselines.BASELINES[name](cluster, fixed_workers=fixed_workers)
        for _ in range(2)]
    steps = [scheds[0].step, scheds[1].step_kernel, scheds[2].step_reference]
    by_slot = {}
    for pj, rj in zip(pjobs, jobs):
        if rj.arrival < cluster.T:
            by_slot.setdefault(rj.arrival, []).append((pj, rj))
    remaining = {}
    rng = np.random.default_rng(churn_seed) if churn_seed is not None \
        else None
    for t in range(cluster.T):
        for pj, rj in by_slot.get(t, ()):
            got = [s.on_arrival(pj if i < 1 else rj, t)
                   for i, s in enumerate(scheds)]
            assert len(set(got)) == 1, (t, pj.jid)
            if got[0]:
                remaining[pj.jid] = pj.total_work_slots
        out = [step(t) for step in steps]
        _same_steps(out, f"{name} t={t}")
        done = []
        for jid, (y, _) in out[0].items():
            remaining[jid] -= float(y.sum())
            if remaining[jid] <= 1e-9:
                done.append(jid)
        if rng is not None and remaining and rng.random() < 0.3:
            jid = list(remaining)[int(rng.integers(len(remaining)))]
            if jid not in done:
                done.append(jid)
        for jid in done:
            for s in scheds:
                s.on_completion(jid, t)
            del remaining[jid]


def test_place_primitives_equal_reference():
    """Round-robin placement, partial fits rolled back: the port's
    placements equal the reference's fast and loop ones, free capacity
    included."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        S = int(rng.integers(1, 12))
        free = rng.uniform(0, 6, (S, 5))
        demand = rng.uniform(0, 3, 5)
        count = int(rng.integers(0, 12))
        frees = [free.copy() for _ in range(3)]
        outs = [ref_baselines._place_fast(count, frees[0], demand),
                baselines._place_fast(count, frees[1], demand),
                ref_baselines._place_loop(count, frees[2], demand)]
        assert len({o is None for o in outs}) == 1
        if outs[0] is not None:
            assert all(np.array_equal(outs[0], o) for o in outs[1:])
        assert all(np.array_equal(frees[0], f) for f in frees[1:])


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("name", REACTIVE)
def test_placements_equal_reference_paper_scale(seed, name):
    """Fig3-shaped T=100, 50+50 servers, 200 jobs, five seeds."""
    _replay(make_cluster(T=100, H=50, K=50),
            make_jobs(200, T=100, seed=seed, small=True), name)


@pytest.mark.parametrize("name", REACTIVE)
def test_placements_equal_reference_full_size(name):
    """Full-size jobs: DRF and Dorm repack hundreds of chunks per event and
    PS placements span servers."""
    _replay(make_cluster(T=60, H=12, K=12),
            make_jobs(30, T=60, seed=3, small=False), name, churn_seed=1)


@pytest.mark.parametrize("fixed_workers", [2, 8])
def test_fixed_workers_reaches_the_schedulers(fixed_workers):
    """The fixed worker count of FIFO and RRH, set at construction."""
    for name in ("fifo", "rrh"):
        _replay(make_cluster(T=40, H=8, K=8),
                make_jobs(25, T=40, seed=2, small=False), name,
                fixed_workers=fixed_workers, churn_seed=3)


@pytest.mark.parametrize("name", REACTIVE)
def test_placements_equal_reference_hetero_fleet(name):
    """Unequal worker rows: first-fit cursors and block envelopes see
    servers of three classes."""
    _replay(make_hetero_cluster(T=50, H=17, K=9, seed=4),
            make_jobs(40, T=50, seed=4, small=False), name, churn_seed=2)


def _random_instance(rng, tight_ps=False, tight_pool=False):
    H = int(rng.integers(1, 7))
    K = int(rng.integers(1, 7))
    scale = 0.35 if tight_pool else 1.0
    wcaps = rng.uniform(0.5, 8.0, (H, 5)) * scale
    scaps = rng.uniform(0.05 if tight_ps else 0.5, 6.0, (K, 5)) * \
        (0.25 if tight_ps else 1.0)
    cluster = RefCluster(T=8, worker_caps=wcaps, ps_caps=scaps)
    jobs = []
    for jid in range(int(rng.integers(1, 9))):
        w = rng.uniform(0, 3.0, 5)
        if rng.random() < 0.3:
            w[rng.integers(0, 5)] = 0.0        # zero-demand resources
        s = rng.uniform(0, 2.0, 5)
        jobs.append(RefJob(
            jid=jid, arrival=0, epochs=1,
            num_chunks=int(rng.integers(1, 7)),
            minibatches_per_chunk=5, tau=0.01, grad_size=0.1,
            worker_bw=float(rng.uniform(0.1, 5.0)),
            ps_bw=float(rng.uniform(0.2, 8.0)),
            worker_res=w, ps_res=s, utility=RefSigmoid(10.0, 0.1, 4.0)))
    return cluster, jobs


@pytest.mark.parametrize("mode", ["plain", "tight_ps", "tight_pool"])
def test_placements_equal_reference_randomized(mode):
    """300 randomized instances a regime: ``tight_ps`` forces PS rollbacks
    (a worker fits, its PS does not), ``tight_pool`` full-pool
    rejections; every scheduler, against both of the reference's repack
    implementations."""
    rng = np.random.default_rng({"plain": 0, "tight_ps": 1,
                                 "tight_pool": 2}[mode])
    saw_placement = saw_rejection = False
    for _ in range(300):
        cluster, jobs = _random_instance(
            rng, tight_ps=mode == "tight_ps", tight_pool=mode == "tight_pool")
        pc, pjobs = _port(cluster, jobs)
        for name in REACTIVE:
            port = BASELINES[name](pc)
            ref = [ref_baselines.BASELINES[name](cluster) for _ in range(2)]
            for pj, rj in zip(pjobs, jobs):
                assert {s.on_arrival(rj, 0) for s in ref} == {
                    port.on_arrival(pj, 0)}
            out = [port.step(0), ref[0].step_kernel(0),
                   ref[1].step_reference(0)]
            _same_steps(out, f"{name} {mode}")
            saw_placement = saw_placement or bool(out[0])
            placed = sum(int(y.sum()) for y, _ in out[0].values())
            saw_rejection = saw_rejection or placed < sum(
                j.num_chunks for j in jobs)
    assert saw_placement and saw_rejection


def test_ps_rollback_blocks_the_job():
    """The worker chunk fits but its PS cannot be placed: the repack rolls
    the worker back and blocks the job, as the reference does."""
    cluster = RefCluster(T=4, worker_caps=np.full((2, 5), 10.0),
                         ps_caps=np.full((1, 5), 1.0))
    job = RefJob(jid=0, arrival=0, epochs=1, num_chunks=3,
                 minibatches_per_chunk=5, tau=0.01, grad_size=0.1,
                 worker_bw=4.0, ps_bw=4.0, worker_res=np.full(5, 1.0),
                 ps_res=np.full(5, 2.0), utility=RefSigmoid(10.0, 0.1, 4.0))
    pc, (pj,) = _port(cluster, [job])
    for name in ("drf", "dorm"):
        port = BASELINES[name](pc)
        ref = [ref_baselines.BASELINES[name](cluster) for _ in range(2)]
        port.on_arrival(pj, 0)
        for s in ref:
            s.on_arrival(job, 0)
        out = [port.step(0), ref[0].step_kernel(0), ref[1].step_reference(0)]
        _same_steps(out, name)
        assert out[0] == {}


def test_dirty_flag_contract():
    """FIFO: a completion with nothing waiting leaves ``dirty`` unset; RRH:
    a rejected arrival leaves it unset; DRF: any completion with live jobs
    sets it."""
    cluster = workload.make_cluster(T=40, H=20, K=20)
    jobs = workload.make_jobs(6, T=20, seed=1, small=True)
    f = FIFO(cluster)
    for j in jobs:
        f.on_arrival(j, 0)
    assert f.dirty
    f.step(0)
    f.dirty = False
    running = [j for j in jobs if j.jid in f.alloc]
    assert running
    f.on_completion(running[0].jid, 1)
    assert not f.dirty
    r = RRH(cluster, threshold=float("inf"))
    r.dirty = False
    assert r.on_arrival(jobs[0], 0) is False
    assert not r.dirty
    d = DRF(cluster)
    for j in jobs:
        d.on_arrival(j, 0)
    d.step(0)
    d.dirty = False
    d.on_completion(jobs[0].jid, 1)
    assert d.dirty


def _counting(name, calls):
    base = BASELINES[name]

    class Counting(base):
        def step(self, t):
            calls.append(t)
            return super().step(t)

    return Counting


@pytest.mark.parametrize("name", ["fifo", "rrh"])
def test_noop_completion_skips_repack(name, monkeypatch):
    """With ample capacity nothing waits under FIFO/RRH: the engine repacks
    at arrival slots only."""
    calls = []
    monkeypatch.setitem(BASELINES, name, _counting(name, calls))
    cluster = workload.make_cluster(T=80, H=40, K=40)
    jobs = workload.make_jobs(8, T=40, seed=5, small=True)
    r = engine.run(cluster, jobs, scheduler=name, check=True, device="cpu")
    assert r.completed == r.accepted > 0
    arrival_slots = {j.arrival for j in jobs if j.arrival < cluster.T}
    assert set(calls) <= arrival_slots
    assert len(calls) == len(r.decision_seconds) <= len(arrival_slots)


def test_waiting_queue_completion_still_repacks(monkeypatch):
    """With jobs queued, a completion sets ``dirty`` and the engine
    repacks there (else the waiting jobs would never start)."""
    calls = []
    monkeypatch.setitem(BASELINES, "fifo", _counting("fifo", calls))
    cluster = workload.make_cluster(T=100, H=2, K=2)
    jobs = workload.make_jobs(12, T=30, seed=7, small=True)
    r = engine.run(cluster, jobs, scheduler="fifo", check=True, device="cpu")
    assert set(calls) - {j.arrival for j in jobs}
    assert r.completed > 0


def test_repack_and_baselines_create_no_tensor():
    """The reactive modules are numpy only: they do not even import torch."""
    import repro_torch.core.repack as rp
    import repro_torch.runtime.straggler as st
    for mod in (baselines, rp, st):
        assert not hasattr(mod, "torch"), mod.__name__
    assert scenarios.REACTIVE == tuple(REACTIVE)

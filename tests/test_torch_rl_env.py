"""The port's rl env and the engine's decision points against the JAX
package.

* replaying the expert action through the env equals ``engine.run`` for
  every scheduler, on the port and on the reference (``impl="fast"`` for
  OASiS), field by field and bit for bit: OASiS on both routes, FIFO,
  DRF, RRH, Dorm, and ``"learned"`` replaying FIFO's counts, on the
  paper instances (seeds 0..4, ``small=True``);
* the same under a churn trace (victims re-admitted at
  ``preempted=True`` decision points; the tiled route's replay equals
  the port's tiled run, which ``test_torch_fleet.py`` holds to the
  reference's tiled engine), and through ``stream_decisions`` at
  ``SERVING_DIMS_QUICK``;
* every observation of an OASiS and of a FIFO episode equals the
  reference's ``observe`` bit for bit;
* the reference's own env checks (``tests/test_rl_env.py``): rewards sum
  to the total utility, random actions stay feasible under
  ``check=True``, ``engine_action``'s clamp, the empty trace, and
  ``policy=`` equal to the env's replay.
"""
import numpy as np
import pytest

from repro.rl import env as ref_env
from repro.sim import engine as ref_engine
from repro.sim import fleet as ref_fleet
from repro.sim import make_cluster, make_jobs
from repro.sim import stream_jobs as ref_stream_jobs
from repro.sim.scenarios import SERVING_DIMS_QUICK
from repro_torch import compat
from repro_torch.rl.env import (OBS_DIM, ClusterSchedulingEnv, ReplayPolicy,
                                engine_action, expert_env_action, observe,
                                paper_instance, run_episode)
from repro_torch.sim import engine, workload

from _torch_parity import one_torch_thread  # noqa: F401

_FIELDS = ("n_jobs", "accepted", "completed", "completion", "total_utility",
           "utilization", "canceled", "preempted", "preempt_dropped",
           "live_frac", "arrivals")
# (scheduler the env drives, scheduler of the runs it replays, route)
CASES = [("oasis", "oasis", "whole"), ("oasis", "oasis", "tiled"),
         ("fifo", "fifo", "whole"), ("drf", "drf", "whole"),
         ("rrh", "rrh", "whole"), ("dorm", "dorm", "whole"),
         ("learned", "fifo", "whole")]
_IDS = [f"{a}-{c}" if a == "oasis" else a for a, _, c in CASES]


def _same(got, want, fields=_FIELDS):
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f


def _kw(name):
    return {"quantum": 0} if name == "oasis" else {}


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("drive,base,core", CASES, ids=_IDS)
def test_env_replay_equals_both_engines(drive, base, core, seed):
    cluster, jobs = paper_instance(seed, small=True)
    env = ClusterSchedulingEnv(instance_fn=lambda s: (cluster, jobs),
                               scheduler=drive, check=True, device="cpu",
                               core=core, **_kw(drive))
    got = run_episode(env, ReplayPolicy())
    port = engine.run(cluster, jobs, scheduler=base, check=True,
                      device="cpu", core=core, **_kw(base))
    rc, rj = ref_env.paper_instance(seed, small=True)
    ref = ref_engine.run(rc, rj, scheduler=base, check=True, **_kw(base))
    _same(got, port)
    if core == "whole":
        _same(got, ref)
    else:
        # the tiled route's servers add up in another order
        _same(got, ref, tuple(f for f in _FIELDS if f != "utilization"))
        assert got.utilization == pytest.approx(ref.utilization, rel=1e-12)


@pytest.mark.parametrize("drive,base,core", CASES, ids=_IDS)
def test_replay_under_churn(drive, base, core):
    """Churn victims are decision points too (``preempted=True``); the
    replay equals the run with the same fleet trace."""
    rc, rj = make_cluster(T=60, H=12, K=12), make_jobs(40, T=60, seed=9)
    trace = ref_fleet.churn_trace(rc, frac=0.25, seed=2)
    pc = workload.make_cluster(T=60, H=12, K=12)
    pj = workload.make_jobs(40, T=60, seed=9)
    fleet = compat.fleet_trace(trace)
    seen = []

    def replay(dp):
        seen.append(dp.preempted)
        return dp.expert

    got = engine.run(pc, pj, scheduler=drive, fleet=fleet, device="cpu",
                     core=core, policy=replay, **_kw(drive))
    port = engine.run(pc, pj, scheduler=base, fleet=fleet, device="cpu",
                      core=core, **_kw(base))
    _same(got, port)
    assert got.preempted > 0
    # OASiS re-admits its victims through decision points; a reactive
    # scheduler keeps them enrolled
    assert sum(seen) == (got.preempted if base == "oasis" else 0)
    if core == "whole":
        _same(got, ref_engine.run(rc, rj, scheduler=base, fleet=trace,
                                  **_kw(base)))


@pytest.mark.parametrize("drive,base,core", CASES, ids=_IDS)
def test_stream_decisions_replay(drive, base, core):
    q = SERVING_DIMS_QUICK
    W = q["window"]

    def trace(fn):
        return fn(rate=q["rate"], seed=0, max_slots=q["slots"], small=True)

    pc = workload.make_cluster(T=W, H=q["H"], K=q["K"])
    gen = engine.stream_decisions(pc, trace(workload.stream_jobs),
                                  scheduler=drive, window=W, device="cpu",
                                  core=core, **_kw(drive))
    n = 0
    try:
        dp = next(gen)
        while True:
            assert dp.free_frac_workers.shape == (8, 5)
            n += 1
            dp = gen.send(dp.expert)
    except StopIteration as stop:
        got = stop.value
    fields = _FIELDS + ("window_bytes",)
    _same(got, engine.run_stream(pc, trace(workload.stream_jobs),
                                 scheduler=base, window=W, device="cpu",
                                 core=core, **_kw(base)), fields)
    assert n == got.n_jobs > 0
    ref = ref_engine.run_stream(
        make_cluster(T=W, H=q["H"], K=q["K"]), trace(ref_stream_jobs),
        scheduler=base, window=W, **_kw(base))
    _same(got, ref, fields)


@pytest.mark.parametrize("name", ["oasis", "fifo"])
def test_observations_equal_reference(name):
    """Every observation of a replayed episode is the reference's, bit for
    bit (the engines run in lockstep on the same trace)."""
    cluster, jobs = paper_instance(0, small=True)
    rc, rj = ref_env.paper_instance(0, small=True)
    env = ClusterSchedulingEnv(instance_fn=lambda s: (cluster, jobs),
                               scheduler=name, device="cpu", **_kw(name))
    ref = ref_env.ClusterSchedulingEnv(instance_fn=lambda s: (rc, rj),
                                       scheduler=name, **_kw(name))
    (obs, info), (robs, rinfo) = env.reset(), ref.reset()
    n, done = 0, False
    while not done:
        assert obs.dtype == np.float32 and obs.shape == (OBS_DIM,)
        assert np.array_equal(obs, robs), n
        assert np.array_equal(observe(env._dp, cluster), obs)
        assert info["jid"] == rinfo["jid"] and info["t"] == rinfo["t"]
        assert np.array_equal(info["expert_action"], rinfo["expert_action"])
        obs, rew, done, _, info = env.step(info["expert_action"])
        robs, rrew, rdone, _, rinfo = ref.step(rinfo["expert_action"])
        assert rew == rrew and done == rdone
        n += 1
    assert n == 200
    assert info["summary"] == rinfo["summary"]


def test_rewards_sum_to_total_utility():
    cluster, jobs = paper_instance(3, small=True)
    env = ClusterSchedulingEnv(instance_fn=lambda s: (cluster, jobs),
                               scheduler="learned", device="cpu")
    obs, info = env.reset()
    total, done = 0.0, False
    rng = np.random.default_rng(0)
    while not done:
        a = np.array([rng.integers(0, 33), rng.integers(0, 4)])
        obs, rew, done, _, info = env.step(a)
        total += rew
    assert total == pytest.approx(env.result.total_utility, abs=1e-6)
    assert info["summary"]["total_utility"] == pytest.approx(total, abs=1e-6)


def test_random_actions_stay_feasible():
    """``check=True`` checks capacity at every repack; arbitrary (even
    absurd) actions never trip it."""
    cluster = workload.make_cluster(T=40, H=6, K=6)
    jobs = workload.make_jobs(60, T=40, seed=4, small=False)
    env = ClusterSchedulingEnv(instance_fn=lambda s: (cluster, jobs),
                               scheduler="learned", check=True, device="cpu")
    obs, info = env.reset()
    rng = np.random.default_rng(1)
    done = info.get("empty_trace", False)
    n = 0
    while not done:
        a = np.array([rng.integers(0, 500), rng.integers(0, 50)])
        sent = engine_action(env._dp, a)
        if sent is not None:
            assert 1 <= sent[0] <= env._dp.job.num_chunks
            assert sent[1] >= env._dp.job.ps_for(sent[0])
        obs, _, done, _, info = env.step(a)
        n += 1
    assert n == len(jobs) and env.result.accepted <= len(jobs)


def test_engine_action_clamps_to_feasibility_envelope():
    cluster, jobs = paper_instance(0, small=True)
    env = ClusterSchedulingEnv(instance_fn=lambda s: (cluster, jobs),
                               scheduler="learned", device="cpu")
    env.reset()
    dp = env._dp
    job = dp.job
    assert engine_action(dp, 0) is None
    assert engine_action(dp, (0, 3)) is None
    w, p = engine_action(dp, (10 ** 6, 0))
    assert w == job.num_chunks
    assert p == job.ps_for(w)
    w, p = engine_action(dp, (1, 2))
    assert w == 1 and p == job.ps_for(1) + 2
    exp = expert_env_action(dp)
    assert exp.shape == (2,) and exp[0] >= 0


def test_empty_trace_episode():
    cluster = workload.make_cluster(T=20, H=4, K=4)
    env = ClusterSchedulingEnv(instance_fn=lambda s: (cluster, []),
                               scheduler="learned", device="cpu")
    obs, info = env.reset()
    assert info.get("empty_trace")
    obs, rew, done, _, info = env.step(np.array([3, 0]))
    assert done and rew == 0.0
    assert info["summary"]["n_jobs"] == 0
    assert info["summary"]["mean_latency"] is None


@pytest.mark.parametrize("name", ["fifo", "drf", "oasis"])
def test_policy_kwarg_matches_env_replay(name):
    """``engine.run(policy=...)`` and the env are one decision stream, and
    the reactive run records the policy's times as its decisions'."""
    cluster, jobs = paper_instance(2, small=True)
    via_engine = engine.run(cluster, jobs, scheduler=name, check=True,
                            device="cpu", policy=lambda dp: dp.expert,
                            **_kw(name))
    env = ClusterSchedulingEnv(instance_fn=lambda s: (cluster, jobs),
                               scheduler=name, check=True, device="cpu",
                               **_kw(name))
    _same(via_engine, run_episode(env, ReplayPolicy()))
    assert len(via_engine.decision_seconds) == len(jobs)


def test_reset_draws_fresh_instances():
    env = ClusterSchedulingEnv(scheduler="fifo", device="cpu",
                               instance_kwargs={"T": 20, "H": 3, "K": 3,
                                                "n_jobs": 5, "small": True})
    env.reset(seed=7)
    first = [j.arrival for j in env.jobs]
    env.reset()                                # the next seed
    assert env._instance_seed == 9
    env.reset(options={"instance": 7})
    assert [j.arrival for j in env.jobs] == first
    rc, rj = ref_env.paper_instance(7, T=20, H=3, K=3, n_jobs=5, small=True)
    assert [j.arrival for j in rj] == first
    assert env.action_space == (33, 4) and env.observation_space == (OBS_DIM,)


def test_decisions_resolve_the_device_at_the_call(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cluster, jobs = paper_instance(0, small=True)
    for name in ("oasis", "learned"):
        with pytest.raises(RuntimeError, match="CUDA"):
            engine.decisions(cluster, jobs, scheduler=name)
        with pytest.raises(RuntimeError, match="CUDA"):
            engine.stream_decisions(cluster, iter(jobs), scheduler=name)
    env = ClusterSchedulingEnv(instance_fn=lambda s: (cluster, jobs))
    with pytest.raises(RuntimeError, match="CUDA"):
        env.reset()

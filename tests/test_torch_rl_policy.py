"""The port's policy network against the JAX package's.

* ``policy_logits``, ``action_log_prob`` and the entropy on the
  reference's ``policy_init`` parameters, carried across
  (``params_from_numpy``), within rel 1e-5 of the reference on the
  observations of a real episode, one at a time and batched;
* the learned scheduler with the reference's ``default_policy``
  parameters equals the reference's run (accepted, completions, utility)
  on the paper seeds 0..2, with every greedy decision's top-two logit
  margin above 1e-4 in both packages, so that equal trajectories are a
  fair test and not luck;
* sampling from an explicit generator, the level mapping, the decider
  on the engine, checkpoints of the policy, and the ``"learned"``
  scenario rows with a policy checkpoint written by the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl import env as ref_env
from repro.rl import policy as ref_pol
from repro.sim import engine as ref_engine
from repro.sim import scenarios as ref_scenarios
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import tree_leaves
from repro_torch.rl import policy as pol
from repro_torch.rl.env import (OBS_DIM, ClusterSchedulingEnv, ReplayPolicy,
                                paper_instance)
from repro_torch.sim import engine, scenarios, workload

from _torch_parity import one_torch_thread  # noqa: F401


def _tensors(tree):
    return tree_leaves(tree, lambda x: isinstance(x, torch.Tensor))


def _converted(cfg, seed=0):
    ref = ref_pol.policy_init(jax.random.PRNGKey(seed), ref_pol.PolicyConfig(
        d_model=cfg.d_model, max_workers=cfg.max_workers))
    return ref, params_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                                  device="cpu")


def _episode_obs(name="fifo", seed=0):
    cluster, jobs = paper_instance(seed, small=False)
    env = ClusterSchedulingEnv(instance_fn=lambda s: (cluster, jobs),
                               scheduler=name, device="cpu",
                               **({"quantum": 0} if name == "oasis" else {}))
    obs, info = env.reset()
    rows, done = [], False
    while not done:
        rows.append(obs)
        obs, _, done, _, info = env.step(ReplayPolicy()(obs, info))
    return np.stack(rows)


@pytest.mark.parametrize("d_model", [64, 32])
def test_forward_pass_matches_reference(d_model):
    cfg = pol.PolicyConfig(d_model=d_model)
    rcfg = ref_pol.PolicyConfig(d_model=d_model)
    rp, pp = _converted(cfg)
    obs = _episode_obs()
    assert obs.shape == (200, OBS_DIM)
    lw, ls = pol.policy_logits(pp, torch.from_numpy(obs), cfg)
    acts = np.stack([np.arange(200) % cfg.n_worker_actions,
                     np.arange(200) % cfg.ps_slack_levels], 1)
    logp, ent = pol.action_log_prob(pp, torch.from_numpy(obs),
                                    torch.from_numpy(acts), cfg)
    for i in range(0, 200, 7):
        o = jnp.asarray(obs[i])
        rlw, rls = ref_pol.policy_logits(rp, o, rcfg)
        np.testing.assert_allclose(lw[i].numpy(), np.asarray(rlw), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(ls[i].numpy(), np.asarray(rls), rtol=1e-5,
                                   atol=1e-7)
        rlogp, rent = ref_pol.action_log_prob(rp, o, jnp.asarray(acts[i]),
                                              rcfg)
        assert float(logp[i]) == pytest.approx(float(rlogp), rel=1e-5)
        assert float(ent[i]) == pytest.approx(float(rent), rel=1e-5)
        # one observation at a time: the batch's own rows
        one = pol.policy_logits(pp, torch.from_numpy(obs[i]), cfg)
        np.testing.assert_allclose(one[0].numpy(), lw[i].numpy(), rtol=1e-6,
                                   atol=1e-7)
        g = pol.greedy_action(pp, torch.from_numpy(obs[i]), cfg)
        assert g.tolist() == [int(x) for x in ref_pol.greedy_action(
            rp, o, rcfg)]


class _Margins:
    """Wraps the reference's decider: records the smallest top-two logit
    margin over both heads of each decision."""

    def __init__(self, decider, logits_fn, cluster):
        self.decider, self.logits_fn = decider, logits_fn
        self.cluster = cluster
        self.margins = []

    def __call__(self, dp):
        lw, ls = (np.sort(np.asarray(x))[::-1] for x in
                  self.logits_fn(ref_env.observe(dp, self.cluster)))
        self.margins.append(min(lw[0] - lw[1], ls[0] - ls[1]))
        return self.decider(dp)


@pytest.mark.parametrize("seed", range(3))
def test_learned_run_equals_reference(seed):
    cfg = pol.PolicyConfig()
    rcfg = ref_pol.PolicyConfig()
    rp, pp = _converted(cfg)
    rc, rj = ref_env.paper_instance(seed, small=True)
    pc, pj = paper_instance(seed, small=True)
    rdec = _Margins(ref_pol.default_policy(rc),
                    lambda o: ref_pol.policy_logits(rp, jnp.asarray(o), rcfg),
                    rc)
    want = ref_engine.run(rc, rj, scheduler="learned", policy=rdec)
    dec = pol.LearnedDecider(pp, cfg, pc, device="cpu", track_margins=True)
    got = engine.run(pc, pj, scheduler="learned", policy=dec, device="cpu")
    assert got.accepted == want.accepted
    assert got.completion == want.completion
    assert got.total_utility == want.total_utility
    assert len(got.decision_seconds) == len(dec.margins) == 200
    assert min(dec.margins) > 1e-4 and min(rdec.margins) > 1e-4
    np.testing.assert_allclose(dec.margins, rdec.margins, rtol=1e-3,
                               atol=1e-6)


def test_sampling_is_the_generators():
    cfg = pol.PolicyConfig(d_model=32)
    params = pol.policy_init(torch.Generator().manual_seed(0), cfg)
    obs = torch.from_numpy(_episode_obs()[:16])
    a1, lp1 = pol.sample_action(params, obs, torch.Generator().manual_seed(3),
                                cfg)
    a2, lp2 = pol.sample_action(params, obs, torch.Generator().manual_seed(3),
                                cfg)
    assert torch.equal(a1, a2) and torch.equal(lp1, lp2)
    assert a1.shape == (16, 2) and bool((lp1 <= 0).all())
    logp, ent = pol.action_log_prob(params, obs, a1, cfg)
    torch.testing.assert_close(logp, lp1)
    assert bool((ent >= 0).all())
    one, _ = pol.sample_action(params, obs[0], torch.Generator(), cfg)
    assert one.shape == (2,)
    # the draws follow the policy: a sharp head is (almost) always picked
    sharp = {k: {kk: v.clone() for kk, v in d.items()}
             for k, d in params.items()}
    sharp["head_w"]["b"][:] = torch.tensor([0.0, 0.0, 30.0, 0.0, 0.0])
    a, _ = pol.sample_action(sharp, obs, torch.Generator().manual_seed(1),
                             cfg)
    assert bool((a[:, 0] == 2).all())


def test_level_to_workers_mapping():
    cfg = pol.PolicyConfig()
    assert cfg.worker_levels[cfg.expert_level] == 1.0
    assert cfg.level_to_workers(0, 8) == 0
    assert cfg.level_to_workers(cfg.expert_level, 8) == 8
    hi = len(cfg.worker_levels) - 1
    assert cfg.level_to_workers(hi, 8) == int(cfg.worker_levels[hi] * 8)
    assert cfg.level_to_workers(hi, 1000) == cfg.max_workers
    assert cfg.level_to_workers(1, 1) == 1
    assert cfg.level_to_workers(2, 0) == 0
    rcfg = ref_pol.PolicyConfig()
    for level in range(cfg.n_worker_actions):
        for w in (0, 1, 3, 8, 40):
            assert cfg.level_to_workers(level, w) == \
                rcfg.level_to_workers(level, w)
    assert cfg.n_scalars == rcfg.n_scalars and cfg.obs_dim == rcfg.obs_dim


def test_decider_drives_engine_deterministically():
    cfg = pol.PolicyConfig(d_model=32)
    params = pol.policy_init(torch.Generator().manual_seed(0), cfg)
    cluster = workload.make_cluster(T=30, H=6, K=6)
    jobs = workload.make_jobs(20, T=30, seed=0, small=False)
    runs = [engine.run(cluster, jobs, scheduler="learned", check=True,
                       device="cpu",
                       policy=pol.LearnedDecider(params, cfg, cluster,
                                                 device="cpu"))
            for _ in range(2)]
    assert runs[0].completion == runs[1].completion
    assert runs[0].total_utility == runs[1].total_utility
    assert len(runs[0].decision_seconds) == 20
    # sampling deciders: one seed, one trajectory
    samp = [engine.run(cluster, jobs, scheduler="learned", device="cpu",
                       policy=pol.LearnedDecider(params, cfg, cluster,
                                                 greedy=False, seed=5,
                                                 device="cpu"))
            for _ in range(2)]
    assert samp[0].completion == samp[1].completion


def test_default_policy_is_drawn_on_the_cpu(monkeypatch):
    cluster = workload.make_cluster(T=10, H=2, K=2)
    a = pol.default_policy(cluster, seed=1, device="cpu")
    b = pol.policy_init(torch.Generator().manual_seed(1), pol.PolicyConfig())
    assert all(torch.equal(x, y) for x, y in zip(_tensors(a.params),
                                                 _tensors(b)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pol.default_policy(cluster)


def test_policy_checkpoint_round_trip(tmp_path):
    cfg = pol.PolicyConfig(d_model=32)
    params = pol.policy_init(torch.Generator().manual_seed(0), cfg)
    pol.save_policy(str(tmp_path), params, cfg, step=7,
                    extra={"note": "test"})
    re_params, re_cfg, extra = pol.load_policy(str(tmp_path), device="cpu")
    assert re_cfg == cfg and extra["note"] == "test"
    for a, b in zip(_tensors(params), _tensors(re_params)):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        pol.load_policy(str(tmp_path / "nope"), device="cpu")


def test_learned_scenario_rows_with_a_reference_checkpoint(tmp_path):
    """``run_scale``/``run_serving``'s ``"learned"`` rows on a policy
    checkpoint the reference wrote equal the reference's rows."""
    rcfg = ref_pol.PolicyConfig()
    ref_pol.save_policy(str(tmp_path), ref_pol.policy_init(
        jax.random.PRNGKey(0), rcfg), rcfg)
    kw = dict(T=30, H=4, K=4, n=12, schedulers=("fifo", "learned"),
              policy_ckpt=str(tmp_path))
    got = scenarios.run_scale(device="cpu", **kw)
    want = ref_scenarios.run_scale(**kw)
    for g, w in zip(got, want):
        for f in ("scheduler", "variant", "utility", "accepted", "completed",
                  "utilization"):
            assert getattr(g, f) == getattr(w, f), (g.scheduler, f)
    # the reference's run_serving holds a learned row's window bytes to
    # OASiS's and so raises on it; its row is rebuilt from run_stream
    row = scenarios.run_serving(device="cpu", quick=True, slots=200,
                                schedulers=("learned",),
                                policy_ckpt=str(tmp_path))[0]
    q = ref_scenarios.SERVING_DIMS_QUICK
    rc = ref_scenarios.make_cluster(T=q["window"], H=q["H"], K=q["K"])
    params, rcfg, _ = ref_pol.load_policy(str(tmp_path))
    want = ref_engine.run_stream(
        rc, ref_scenarios.stream_jobs(rate=q["rate"], seed=0, max_slots=200,
                                      small=True),
        scheduler="learned", window=q["window"],
        policy=ref_pol.LearnedDecider(params, rcfg, rc))
    assert (row.utility, row.accepted, row.completed, row.completion,
            row.n_jobs, row.window_bytes) == (
        want.total_utility, want.accepted, want.completed, want.completion,
        want.n_jobs, 0)
    default = scenarios.run_scale(device="cpu", T=30, H=4, K=4, n=12,
                                  schedulers=("learned",))
    assert default[0].accepted <= 12

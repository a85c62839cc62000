"""The port's REINFORCE + behaviour-cloning training against the JAX
package's (``repro/rl/train.py``, optax).

* the REINFORCE loss (advantage-weighted log-likelihood, entropy bonus,
  expert anchor) and the behaviour-cloning loss, and their gradients, on
  a fixed padded batch within rel 1e-4 of ``jax.grad``; one Adam step of
  the update within rel 1e-5 of the reference's ``make_update_fn`` with
  ``optax.adam``.  A leaf's elements are held to rel ``r`` with an
  absolute floor of ``r`` times the leaf's largest magnitude: gradient
  entries near 0 come out of cancelling float32 sums (~1e-11 apart);
* ``rollout_batch`` driven by one deterministic sampler in both packages:
  every buffer bit-equal (obs, actions, credit, mask, experts,
  utilities); ``_advantages`` equal;
* the reference's own checks (``tests/test_rl_train.py``): a two-iteration
  train smoke, ``_expert_level``'s threshold, ``batch >= 2``; and the CLI
  smoke with its checkpoint round trip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from repro.rl import env as ref_env
from repro.rl import policy as ref_pol
from repro.rl import train as ref_train
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import tree_leaves
from repro_torch.rl import policy as pol
from repro_torch.rl import train as tr
from repro_torch.rl.env import F_BEST_UTILITY, OBS_DIM

from _torch_parity import one_torch_thread  # noqa: F401


def _tensors(tree):
    return tree_leaves(tree, lambda x: isinstance(x, torch.Tensor))


def _flat(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _levels(obs):
    """A deterministic sampler's actions, a function of the observations'
    bits alone."""
    o = np.asarray(obs)
    w = (np.floor(o[:, F_BEST_UTILITY] * 997) + np.floor(o[:, 0] * 89)) % 5
    s = np.floor(o[:, 1] * 701) % 4
    return np.stack([w, s], 1).astype(np.int64)


def _fixed_batch():
    """A padded (B=3, L=24) batch from lockstep rollouts of the smoke
    instance, with random advantages and a ragged mask."""
    cfg, pcfg = tr.smoke_config()
    cfg = tr.TrainConfig(**{**cfg.__dict__, "batch": 3})
    envs = [tr._make_env(cfg, "cpu") for _ in range(3)]
    obs, act, credit, mask, expert, _ = tr.rollout_batch(
        None, pcfg, cfg, envs, (100, 101, 102), None,
        lambda p, o, g: _levels(o), "cpu")
    rng = np.random.default_rng(0)
    adv = (rng.standard_normal(mask.shape) * mask).astype(np.float32)
    mask[2, 17:] = 0.0
    return cfg, pcfg, obs, act, adv, mask, expert


def _ref_loss(rcfg, cfg):
    logp_fn = jax.vmap(jax.vmap(
        lambda p, o, a: ref_pol.action_log_prob(p, o, a, rcfg),
        in_axes=(None, 0, 0)), in_axes=(None, 0, 0))

    def loss_fn(params, obs, act, adv, mask, expert, ent_coef):
        logp, ent = logp_fn(params, obs, act)
        logp_exp, _ = logp_fn(params, obs, expert)
        denom = jnp.maximum(mask.sum(), 1.0)
        pol_ = -(logp * adv * mask).sum() / denom
        entropy = (ent * mask).sum() / denom
        anchor = -(logp_exp * mask).sum() / denom
        return pol_ - ent_coef * entropy + cfg.anchor_coef * anchor

    return loss_fn


def _assert_close(got_tree, want_tree, rtol):
    for g, w in zip(_tensors(got_tree), _flat(want_tree)):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()))


def test_reinforce_loss_gradients_and_adam_step():
    cfg, pcfg, obs, act, adv, mask, expert = _fixed_batch()
    rcfg = ref_pol.PolicyConfig(max_workers=16)
    rp = ref_pol.policy_init(jax.random.PRNGKey(1), rcfg)
    pp = tr._trainable(params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                rp),
                                         device="cpu"))
    batch = tuple(jnp.asarray(a) for a in (obs, act, adv, mask, expert))
    ent_coef = 0.01
    want_loss, want_grads = jax.value_and_grad(_ref_loss(rcfg, cfg))(
        rp, *batch, jnp.float32(ent_coef))
    loss, pol_term, ent = tr.reinforce_loss(
        pp, pcfg, cfg, *tr._batch("cpu", obs, act, adv, mask, expert),
        ent_coef)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-4)
    for g, w in zip(_tensors(pp), _flat(want_grads)):
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))
    # one update: the reference's make_update_fn with optax.adam
    opt = optax.adam(cfg.lr)
    update = ref_train.make_update_fn(rcfg, cfg, opt)
    new_rp, _, rloss, rpol, rent = update(rp, opt.init(rp), *batch,
                                          jnp.float32(ent_coef))
    pp2 = tr._trainable(pp)
    step = tr.make_update_fn(pcfg, cfg, tr.adam(pp2, cfg.lr))
    l2, p2, e2 = step(pp2, *tr._batch("cpu", obs, act, adv, mask, expert),
                      ent_coef)
    assert (float(l2), float(p2), float(e2)) == pytest.approx(
        (float(rloss), float(rpol), float(rent)), rel=1e-4)
    _assert_close(pp2, new_rp, 1e-5)


def test_behavior_cloning_loss_and_gradients():
    _, pcfg, obs, _, _, mask, expert = _fixed_batch()
    keep = mask.astype(bool)
    obs_b, act_b = obs[keep], expert[keep]
    rcfg = ref_pol.PolicyConfig(max_workers=16)
    rp = ref_pol.policy_init(jax.random.PRNGKey(2), rcfg)
    logp_fn = jax.vmap(
        lambda p, o, a: ref_pol.action_log_prob(p, o, a, rcfg)[0],
        in_axes=(None, 0, 0))
    want, grads = jax.value_and_grad(
        lambda p: -logp_fn(p, jnp.asarray(obs_b), jnp.asarray(act_b)).mean()
    )(rp)
    pp = tr._trainable(params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                rp),
                                         device="cpu"))
    loss = tr.bc_loss(pp, pcfg, torch.from_numpy(obs_b),
                      torch.from_numpy(act_b))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-4)
    for g, w in zip(_tensors(pp), _flat(grads)):
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


def test_rollout_buffers_equal_reference():
    cfg, pcfg = tr.smoke_config()
    rcfg_t, rpcfg = ref_train.smoke_config()
    seeds = (100, 101, 103)
    got = tr.rollout_batch(
        None, pcfg, cfg, [tr._make_env(cfg, "cpu") for _ in seeds], seeds,
        None, lambda p, o, g: _levels(o.numpy()), "cpu")
    want = ref_train.rollout_batch(
        None, rpcfg, rcfg_t, [ref_train._make_env(rcfg_t) for _ in seeds],
        seeds, jax.random.PRNGKey(0), lambda p, o, k: _levels(o))
    names = ("obs", "actions", "credit", "mask", "experts", "utilities")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert got[3].sum() > 0 and got[0].shape == (3, 24, OBS_DIM)


def test_advantages_equal_reference():
    rng = np.random.default_rng(3)
    credit = rng.random((4, 50)).astype(np.float32) * 30
    mask = (rng.random((4, 50)) < 0.8).astype(np.float32)
    for window in (0, 8, 32, 64):
        assert np.array_equal(tr._advantages(credit, mask, window),
                              ref_train._advantages(credit, mask, window))


def test_train_two_iterations_smoke():
    cfg = tr.TrainConfig(iterations=2, batch=3, T=32, H=8, K=8, n_jobs=24,
                         train_seeds=(100, 101), val_every=0,
                         bc_episodes=2, bc_steps=5)
    pcfg = pol.PolicyConfig(d_model=32, max_workers=16)
    params, history = tr.train(cfg, pcfg, log=None, device="cpu")
    assert len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)
    assert all(np.isfinite(h["mean_utility"]) for h in history)
    assert all(h["decisions"] > 0 for h in history)
    ev = tr.evaluate(params, pcfg, seeds=(9,), cfg=cfg,
                     schedulers=("learned", "fifo"), device="cpu")
    assert set(ev) == {"learned", "fifo"}
    for stats in ev.values():
        assert np.isfinite(stats["mean_utility"])
    rcfg = ref_train.TrainConfig(**{**cfg.__dict__})
    want = ref_train.evaluate(None, ref_pol.PolicyConfig(), seeds=(9,),
                              cfg=rcfg, schedulers=("fifo",))
    assert ev["fifo"] == want["fifo"]
    assert not any(x.requires_grad for x in tree_leaves(
        params, lambda x: isinstance(x, torch.Tensor)))


def test_train_validates_and_keeps_the_best_iterate():
    cfg = tr.TrainConfig(iterations=2, batch=2, T=24, H=4, K=4, n_jobs=10,
                         train_seeds=(100,), val_seeds=(200,), val_every=1,
                         bc_episodes=1, bc_steps=2)
    pcfg = pol.PolicyConfig(d_model=16, max_workers=8)
    lines = []
    params, history = tr.train(cfg, pcfg, log=lines.append, device="cpu")
    assert len(history) == 2
    assert sum("validation utility" in x for x in lines) == 3
    assert len(_tensors(params)) == 15


def test_expert_level_threshold():
    cfg = tr.TrainConfig(admit_threshold=10.0)
    pcfg = pol.PolicyConfig()
    obs = np.zeros(OBS_DIM, np.float32)
    obs[F_BEST_UTILITY] = 0.02
    assert tr._expert_level(obs, 8, pcfg, cfg) == 0
    obs[F_BEST_UTILITY] = 0.5
    assert tr._expert_level(obs, 8, pcfg, cfg) == pcfg.expert_level
    assert tr._expert_level(obs, 0, pcfg, cfg) == 0
    assert F_BEST_UTILITY == ref_env.F_BEST_UTILITY


def test_batch_of_one_is_refused():
    with pytest.raises(ValueError, match="batch"):
        tr.train(tr.TrainConfig(batch=1), device="cpu")


def test_cli_smoke(capsys):
    assert tr.main(["--smoke", "--device", "cpu"]) == 0
    assert "rl_smoke PASS" in capsys.readouterr().out

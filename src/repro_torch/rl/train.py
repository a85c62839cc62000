"""REINFORCE-with-baseline training of the learned scheduler, on PyTorch,
as the reference's ``repro/rl/train.py``.

One iteration rolls out a batch of episodes in lockstep (every env is
finished or paused at a decision point, so each decision round is ONE
batched policy call over the batch, and one copy of its actions to the
host), then takes one Adam step on the advantage-weighted
log-likelihood::

    loss = -E[logp(a|obs) * A] - entropy_coef * H(pi)
           + anchor_coef * (-E[logp(expert|obs)])

with ``A`` the windowed return-to-go over per-job credit, the
cross-rollout mean subtracted and the result whitened.  The undiscounted
return is the episode's total job utility, the objective OASiS
maximizes.  A behaviour-cloning warm start first fits the policy to an
admission-filtered FIFO expert.

Gradients come from autograd on the parameters' device, the optimizer is
``torch.optim.Adam`` with optax's defaults (beta 0.9/0.999, eps 1e-8
outside the square root).  Buffers are padded to (batch, n_jobs).
Checkpoints go through ``ckpt/checkpoint.py`` and load into
``engine.run(scheduler="learned", policy=...)`` through
``policy.load_policy``.

CLI::

    PYTHONPATH=src python -m repro_torch.rl.train --iterations 40 \\
        --ckpt-dir runs/learned                       # on the card
    PYTHONPATH=src python -m repro_torch.rl.train --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..models.layers import tree_leaves, tree_map
from ..sim import engine
from . import env as env_mod
from . import policy as policy_mod
from .policy import LearnedDecider, PolicyConfig

Device = Optional[Union[str, torch.device]]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    iterations: int = 40
    batch: int = 8                  # episodes per iteration
    lr: float = 2e-3
    entropy_coef: float = 0.001
    # sampling-time epsilon-uniform exploration: after behaviour cloning
    # the policy is near-deterministic and its entropy gradient vanishes;
    # uniform actions with probability epsilon keep every level tried
    explore_eps: float = 0.1
    # greedy validation on instances disjoint from the train and held-out
    # seeds; the returned params are the best validated iterate
    val_seeds: Tuple[int, ...] = (200, 201, 202)
    val_every: int = 20
    # expert anchor: a small cross-entropy pull toward the heuristic's
    # action where the advantage signal is silent
    anchor_coef: float = 0.005
    # horizon, in decisions, of the return-to-go
    rtg_window: int = 32
    # behaviour-cloning warm start: FIFO's counts, rejecting jobs whose
    # best achievable utility is below ``admit_threshold``
    bc_episodes: int = 8
    bc_steps: int = 30
    bc_lr: float = 5e-3
    admit_threshold: float = 10.0
    seed: int = 0
    # the instance family (paper scale, congested full-size jobs)
    T: int = 100
    H: int = 50
    K: int = 50
    n_jobs: int = 200
    small: bool = False
    # disjoint from the held-out seeds (0-4 equivalence, 5-7 evaluation)
    train_seeds: Tuple[int, ...] = tuple(range(100, 132))
    budget_seconds: Optional[float] = None
    log_every: int = 5


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _leaves(params: Dict) -> List[torch.Tensor]:
    return tree_leaves(params, _is_tensor)


def _trainable(params: Dict) -> Dict:
    """Fresh leaf tensors of ``params`` that require grad."""
    return tree_map(lambda x: x.detach().clone().requires_grad_(True),
                    params, _is_tensor)


def _frozen(params: Dict) -> Dict:
    return tree_map(lambda x: x.detach(), params, _is_tensor)


def adam(params: Dict, lr: float) -> torch.optim.Adam:
    """Adam over the parameter tree's leaves with optax's defaults."""
    return torch.optim.Adam(_leaves(params), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def _make_env(cfg: TrainConfig, device: Device
              ) -> env_mod.ClusterSchedulingEnv:
    return env_mod.ClusterSchedulingEnv(
        scheduler="learned", check=False, device=device,
        instance_kwargs=dict(T=cfg.T, H=cfg.H, K=cfg.K,
                             n_jobs=cfg.n_jobs, small=cfg.small))


def _expert_level(obs: np.ndarray, expert_workers: int,
                  pcfg: PolicyConfig, cfg: TrainConfig) -> int:
    """The warm-start expert in level space: reject jobs below the value
    threshold (``admit_threshold``), else the heuristic's count."""
    if expert_workers <= 0:
        return 0
    best_utility = float(obs[env_mod.F_BEST_UTILITY]) * 100.0
    return 0 if best_utility < cfg.admit_threshold else pcfg.expert_level


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def rollout_batch(params: Dict, pcfg: PolicyConfig, cfg: TrainConfig,
                  envs: Sequence[env_mod.ClusterSchedulingEnv],
                  instance_seeds: Sequence[int],
                  generator: Optional[torch.Generator],
                  sampler: Callable, device: Device = None
                  ) -> Tuple[np.ndarray, ...]:
    """Run one lockstep batch of episodes: per decision round ONE call
    ``sampler(params, obs (B, D) on device, generator) -> (B, 2)`` level
    actions, copied to the host once.

    Returns padded ``(obs (B,L,D), actions (B,L,2), credit (B,L), mask
    (B,L), experts (B,L,2), utilities (B,))`` with ``L = cfg.n_jobs``
    (one decision per job in the horizon).  ``credit[b, k]`` is the
    realized utility of the job decided at step ``k`` (0 when rejected or
    never completed): it sums to the episode's utility like the env's
    stepwise reward but credits each job's outcome to its own decision.
    ``experts`` is the warm-start expert's level action per decision (the
    anchor's target)."""
    device = resolve_device(device)
    B, L, D = len(envs), cfg.n_jobs, pcfg.obs_dim
    obs_buf = np.zeros((B, L, D), np.float32)
    act_buf = np.zeros((B, L, 2), np.int32)
    exp_buf = np.zeros((B, L, 2), np.int32)
    credit = np.zeros((B, L), np.float32)
    jid_buf = np.full((B, L), -1, np.int64)
    mask = np.zeros((B, L), np.float32)
    cur = np.zeros((B, D), np.float32)
    done = np.zeros(B, bool)
    jids = np.full(B, -1, np.int64)
    experts = np.zeros((B, 2), np.int64)
    for i, e in enumerate(envs):
        o, info = e.reset(options={"instance": int(instance_seeds[i])})
        cur[i] = o
        done[i] = info.get("empty_trace", False)
        jids[i] = info.get("jid", -1)
        experts[i] = info.get("expert_action", (0, 0))
    steps = np.zeros(B, np.int64)
    r = 0
    while not done.all():
        actions = _host(sampler(params, torch.from_numpy(cur).to(device),
                                generator))
        for i, e in enumerate(envs):
            if done[i]:
                continue
            obs_buf[i, steps[i]] = cur[i]
            act_buf[i, steps[i]] = actions[i]          # level space
            exp_buf[i, steps[i]] = (
                _expert_level(cur[i], int(experts[i, 0]), pcfg, cfg), 0)
            jid_buf[i, steps[i]] = jids[i]
            mask[i, steps[i]] = 1.0
            env_act = (pcfg.level_to_workers(int(actions[i, 0]),
                                             int(experts[i, 0])),
                       int(actions[i, 1]))
            o, _, d, _, info = e.step(env_act)
            steps[i] += 1
            cur[i] = o
            done[i] = d
            jids[i] = info.get("jid", -1)
            experts[i] = info.get("expert_action", (0, 0))
        r += 1
        if r > L:
            raise AssertionError("more decisions than jobs in a trace")
    for i, e in enumerate(envs):
        res = e.result
        jmap = {j.jid: j for j in e.jobs}
        for k in range(int(steps[i])):
            jid = int(jid_buf[i, k])
            if jid in res.completion:
                credit[i, k] = jmap[jid].utility(
                    res.completion[jid] - res.arrivals[jid])
    utils = np.array([e.result.total_utility for e in envs], np.float32)
    return obs_buf, act_buf, credit, mask, exp_buf, utils


def _advantages(credit: np.ndarray, mask: np.ndarray,
                window: int) -> np.ndarray:
    """Whitened advantage over a windowed return-to-go (Decima-style
    input-driven baseline).

    The return of decision ``k`` is the decided job's own realized
    utility plus that of the next ``window`` decisions: the queue right
    behind an admission is where its externality lands.  All rollouts of
    a batch replay one instance, so decision ``k`` is the same job in
    every rollout; the baseline is the mean windowed return across
    rollouts at ``k``, the advantage what this rollout's actions changed,
    normalized by its std over the batch."""
    c = credit * mask
    returns = np.flip(np.cumsum(np.flip(c, axis=1), axis=1), axis=1)
    if window and window < c.shape[1]:
        tail = np.zeros_like(returns)
        tail[:, :-window] = returns[:, window:]
        returns = returns - tail
    denom = np.maximum(mask.sum(axis=0), 1.0)
    baseline = (returns * mask).sum(axis=0) / denom          # (L,)
    adv = (returns - baseline[None]) * mask
    sd = adv[mask.astype(bool)].std() if mask.any() else 1.0
    return (adv / (sd + 1e-8)).astype(np.float32)


def bc_loss(params: Dict, pcfg: PolicyConfig, obs: torch.Tensor,
            act: torch.Tensor) -> torch.Tensor:
    """The warm start's loss: the mean negative log-likelihood of the
    expert's actions."""
    return -policy_mod.action_log_prob(params, obs, act, pcfg)[0].mean()


def behavior_clone(params: Dict, pcfg: PolicyConfig, cfg: TrainConfig,
                   log=print, device: Device = None) -> Dict:
    """DL2-style supervised bootstrap: roll out the admission-filtered
    FIFO expert and maximize the policy's log-likelihood of its actions
    (``bc_steps`` full-batch Adam steps at ``bc_lr``), so that REINFORCE
    starts from the heuristic's behaviour."""
    if cfg.bc_episodes <= 0 or cfg.bc_steps <= 0:
        return params
    device = resolve_device(device)
    env = _make_env(cfg, device)
    obs_rows: List[np.ndarray] = []
    act_rows: List[np.ndarray] = []
    for e in range(cfg.bc_episodes):
        obs, info = env.reset(options={
            "instance": int(cfg.train_seeds[e % len(cfg.train_seeds)])})
        done = info.get("empty_trace", False)
        while not done:
            expert = info["expert_action"]
            level = _expert_level(obs, int(expert[0]), pcfg, cfg)
            obs_rows.append(obs)
            act_rows.append(np.array([level, 0], np.int32))
            # follow the filtered expert, so the cloned observations are
            # its own trajectory's
            obs, _, done, _, info = env.step(
                expert if level > 0 else (0, 0))
    if not obs_rows:
        return params
    obs_b = torch.from_numpy(np.stack(obs_rows)).to(device)
    act_b = torch.from_numpy(np.stack(act_rows)).to(device)
    params = _trainable(params)
    opt = adam(params, cfg.bc_lr)
    loss = None
    for _ in range(cfg.bc_steps):
        opt.zero_grad(set_to_none=True)
        loss = bc_loss(params, pcfg, obs_b, act_b)
        loss.backward()
        opt.step()
    if log:
        log(f"behavior cloning: {len(obs_rows)} expert decisions, "
            f"final NLL {float(loss.detach()):.3f}")
    return _frozen(params)


def reinforce_loss(params: Dict, pcfg: PolicyConfig, cfg: TrainConfig,
                   obs: torch.Tensor, act: torch.Tensor, adv: torch.Tensor,
                   mask: torch.Tensor, expert: torch.Tensor,
                   ent_coef: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, policy term, entropy) of a padded batch: the advantage-
    weighted log-likelihood, the entropy bonus and the expert anchor,
    each a mean over the unmasked decisions."""
    logp, ent = policy_mod.action_log_prob(params, obs, act, pcfg)
    logp_exp, _ = policy_mod.action_log_prob(params, obs, expert, pcfg)
    denom = torch.clamp_min(mask.sum(), 1.0)
    pol = -(logp * adv * mask).sum() / denom
    entropy = (ent * mask).sum() / denom
    anchor = -(logp_exp * mask).sum() / denom
    return (pol - ent_coef * entropy + cfg.anchor_coef * anchor,
            pol, entropy)


def make_update_fn(pcfg: PolicyConfig, cfg: TrainConfig,
                   optimizer: torch.optim.Optimizer) -> Callable:
    """``update(params, obs, act, adv, mask, expert, ent_coef) -> (loss,
    policy term, entropy)``: one Adam step of ``optimizer``, in place on
    ``params``' leaves (the ones the optimizer was built over)."""

    def update(params, obs, act, adv, mask, expert, ent_coef):
        optimizer.zero_grad(set_to_none=True)
        loss, pol, ent = reinforce_loss(params, pcfg, cfg, obs, act, adv,
                                        mask, expert, ent_coef)
        loss.backward()
        optimizer.step()
        return loss.detach(), pol.detach(), ent.detach()

    return update


def explore_sampler(pcfg: PolicyConfig, eps: float) -> Callable:
    """The rollouts' sampler: the policy's draw, replaced by a uniform
    action with probability ``eps`` per observation."""

    def sample(params, obs, generator):
        with torch.no_grad():
            a = policy_mod.sample_action(params, obs, generator, pcfg)[0]
            B = obs.shape[0]
            u = torch.stack([
                torch.randint(0, pcfg.n_worker_actions, (B,),
                              generator=generator, device=obs.device),
                torch.randint(0, pcfg.ps_slack_levels, (B,),
                              generator=generator, device=obs.device)], -1)
            mix = torch.rand(B, generator=generator,
                             device=obs.device) < eps
            return torch.where(mix[:, None], u, a)

    return sample


def _batch(device, *arrays) -> List[torch.Tensor]:
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def train(cfg: TrainConfig = TrainConfig(),
          pcfg: PolicyConfig = PolicyConfig(),
          params: Optional[Dict] = None, log=print,
          device: Device = None) -> Tuple[Dict, List[Dict]]:
    """Train a policy on ``device`` (None: the CUDA card); returns
    ``(params, history)``.  Fresh parameters are drawn on the CPU from
    ``cfg.seed`` and behaviour-cloned first.  ``cfg.budget_seconds``
    stops training after the first iteration past the budget.  Each
    history row: loss, policy term, entropy, mean utility, the
    iteration's wall and rollout seconds and its decisions."""
    if cfg.batch < 2:
        # with one rollout the cross-rollout baseline is the rollout's own
        # return: the advantages vanish and nothing would be learned
        raise ValueError("TrainConfig.batch must be >= 2 (the cross-"
                         "rollout baseline needs at least two rollouts)")
    device = resolve_device(device)
    if params is None:
        params = policy_mod.params_to(
            policy_mod.policy_init(torch.Generator().manual_seed(cfg.seed),
                                   pcfg), device)
        params = behavior_clone(params, pcfg, cfg, log=log, device=device)
    params = _trainable(params)
    update = make_update_fn(pcfg, cfg, adam(params, cfg.lr))
    sampler = explore_sampler(pcfg, cfg.explore_eps)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    envs = [_make_env(cfg, device) for _ in range(cfg.batch)]
    history: List[Dict] = []
    ent_coef = cfg.entropy_coef
    best_params, best_val = _frozen(params), -np.inf
    t0 = time.perf_counter()

    def _validate(it, elapsed):
        nonlocal best_params, best_val
        val = evaluate(_frozen(params), pcfg, cfg.val_seeds, cfg=cfg,
                       schedulers=("learned",),
                       device=device)["learned"]["mean_utility"]
        if val > best_val:
            best_params = tree_map(lambda x: x.detach().clone(), params,
                                   _is_tensor)
            best_val = val
        if log:
            log(f"iter {it:3d}  validation utility {val:8.1f} "
                f"(best {best_val:8.1f})  [{elapsed:6.1f}s]")

    if cfg.val_every:
        # score the warm start too: the best iterate is never worse than
        # where training began
        _validate(-1, time.perf_counter() - t0)
    for it in range(cfg.iterations):
        t_it = time.perf_counter()
        # every rollout of a batch replays the SAME instance (only the
        # action noise differs), as the cross-rollout baseline needs
        seeds = [cfg.train_seeds[it % len(cfg.train_seeds)]] * cfg.batch
        obs, act, rew, mask, expert, utils = rollout_batch(
            params, pcfg, cfg, envs, seeds, generator, sampler, device)
        t_roll = time.perf_counter() - t_it
        adv = _advantages(rew, mask, cfg.rtg_window)
        loss, pol, ent = update(params, *_batch(device, obs, act, adv, mask,
                                                expert), ent_coef)
        elapsed = time.perf_counter() - t0
        row = {"iteration": it, "loss": float(loss), "policy_loss": float(pol),
               "entropy": float(ent), "mean_utility": float(utils.mean()),
               "entropy_coef": ent_coef, "elapsed_seconds": elapsed,
               "iteration_seconds": time.perf_counter() - t_it,
               "rollout_seconds": t_roll, "decisions": int(mask.sum())}
        history.append(row)
        if log and (it % cfg.log_every == 0 or it == cfg.iterations - 1):
            log(f"iter {it:3d}  loss {row['loss']:+8.4f}  "
                f"entropy {row['entropy']:5.2f}  "
                f"mean utility {row['mean_utility']:8.1f}  "
                f"[{elapsed:6.1f}s]")
        if cfg.val_every and (it + 1) % cfg.val_every == 0:
            _validate(it, time.perf_counter() - t0)
        if cfg.budget_seconds and elapsed > cfg.budget_seconds:
            if log:
                log(f"stopping at iter {it}: budget "
                    f"{cfg.budget_seconds:.0f}s exceeded")
            break
    if cfg.val_every:
        if len(history) % cfg.val_every != 0:   # the last iterate
            _validate(len(history), time.perf_counter() - t0)
        return best_params, history
    return _frozen(params), history


def evaluate(params: Dict, pcfg: PolicyConfig, seeds: Sequence[int],
             cfg: TrainConfig = TrainConfig(),
             schedulers: Sequence[str] = ("learned", "fifo"),
             device: Device = None) -> Dict[str, Dict[str, float]]:
    """Greedy evaluation on held-out instances against the baselines, on
    ``device``: ``{scheduler: {"mean_utility": ..., "per_seed":
    {...}}}``."""
    out: Dict[str, Dict] = {}
    for name in schedulers:
        per = {}
        for s in seeds:
            cluster, jobs = env_mod.paper_instance(
                int(s), T=cfg.T, H=cfg.H, K=cfg.K, n_jobs=cfg.n_jobs,
                small=cfg.small)
            kw = {}
            if name == "learned":
                kw["policy"] = LearnedDecider(params, pcfg, cluster,
                                              device=device)
            elif name == "oasis":
                kw["quantum"] = 0
            r = engine.run(cluster, jobs, scheduler=name, check=False,
                           device=device, **kw)
            per[str(s)] = float(r.total_utility)
        vals = np.array(list(per.values()))
        out[name] = {"mean_utility": float(vals.mean()), "per_seed": per}
    return out


def smoke_config(seed: int = 0) -> Tuple[TrainConfig, PolicyConfig]:
    """The tiny smoke instance (T=32, 8+8 servers, 24 jobs, 2
    iterations), the reference's."""
    return (TrainConfig(iterations=2, batch=4, T=32, H=8, K=8, n_jobs=24,
                        small=False, train_seeds=(100, 101, 102, 103),
                        val_every=0, seed=seed),
            PolicyConfig(max_workers=16))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _smoke(args) -> int:
    """Two iterations on the tiny instance: losses finite, and a
    checkpoint round trip evaluates identically."""
    import tempfile
    cfg, pcfg = smoke_config(seed=args.seed)
    params, history = train(cfg, pcfg, device=args.device)
    if len(history) != 2 or not all(np.isfinite(h["loss"])
                                     for h in history):
        raise AssertionError(history)
    with tempfile.TemporaryDirectory() as d:
        policy_mod.save_policy(d, params, pcfg, step=len(history))
        re_params, re_cfg, _ = policy_mod.load_policy(d, device=args.device)
        if re_cfg != pcfg:
            raise AssertionError((re_cfg, pcfg))
        a = evaluate(params, pcfg, seeds=(9,), cfg=cfg,
                     schedulers=("learned",), device=args.device)
        b = evaluate(re_params, re_cfg, seeds=(9,), cfg=cfg,
                     schedulers=("learned",), device=args.device)
        if a["learned"]["per_seed"] != b["learned"]["per_seed"]:
            raise AssertionError((a, b))
    print("rl_smoke PASS: loss finite over 2 iterations, "
          "checkpoint round-trip evaluation identical "
          f"(utility {a['learned']['mean_utility']:.2f})")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    dflt = TrainConfig()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=dflt.iterations)
    ap.add_argument("--batch", type=int, default=dflt.batch)
    ap.add_argument("--lr", type=float, default=dflt.lr)
    ap.add_argument("--entropy", type=float, default=dflt.entropy_coef)
    ap.add_argument("--seed", type=int, default=dflt.seed)
    ap.add_argument("--T", type=int, default=dflt.T)
    ap.add_argument("--servers", type=int, default=dflt.H,
                    help="H and K (paper scale: 50+50)")
    ap.add_argument("--jobs", type=int, default=dflt.n_jobs)
    ap.add_argument("--small", action="store_true",
                    help="shrunk job internals (the equivalence family)")
    ap.add_argument("--budget-seconds", type=float, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--eval-seeds", default="5,6,7",
                    help="held-out instance seeds for the final evaluation")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--smoke", action="store_true",
                    help="2 iterations on a tiny instance and a checkpoint "
                         "round trip")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke(args)
    cfg = TrainConfig(iterations=args.iterations, batch=args.batch,
                      lr=args.lr, entropy_coef=args.entropy, seed=args.seed,
                      T=args.T, H=args.servers, K=args.servers,
                      n_jobs=args.jobs, small=args.small,
                      budget_seconds=args.budget_seconds)
    pcfg = PolicyConfig()
    params, history = train(cfg, pcfg, device=args.device)
    seeds = [int(s) for s in args.eval_seeds.split(",") if s]
    ev = evaluate(params, pcfg, seeds, cfg=cfg,
                  schedulers=("learned", "fifo"), device=args.device)
    for name, stats in ev.items():
        print(f"{name:8s} mean utility {stats['mean_utility']:8.1f}  "
              + "  ".join(f"s{s}={v:.1f}"
                          for s, v in stats["per_seed"].items()))
    if args.ckpt_dir:
        path = policy_mod.save_policy(
            args.ckpt_dir, params, pcfg, step=len(history),
            extra={"history_tail": history[-3:], "eval": ev})
        print(f"checkpoint -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

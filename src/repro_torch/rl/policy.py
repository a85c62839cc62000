"""The policy network of the learned scheduler, on PyTorch, as the
reference's ``repro/rl/policy.py``.

* the observation's two capacity windows (2W slot tokens of R free
  capacity fractions, tagged with the slot's offset and the pool) go
  through a **single-head attention read-out**: keys and values from the
  tokens, the query from the embedded job features;
* the job embedding and the attention context feed a silu MLP trunk
  with an rms-normed residual stream (``models/layers.py``);
* two categorical heads: the worker level (0 = reject, else a multiple
  of the expert's worker count) and the PS slack (parameter servers on
  top of the bandwidth-matched minimum).

Parameters are built from ``models/layers.P`` specs through
``init_params`` with an explicit ``torch.Generator``, so the policy
checkpoints through ``ckpt/checkpoint.py`` like any parameter tree, and
the reference's parameters carry across with
``models/convert.py::params_from_numpy``.  The products are
``torch.matmul``, as the reference's are plain ``jnp`` outside any
Pallas kernel.  Every function takes one observation ``(OBS_DIM,)`` or a
batch ``(..., OBS_DIM)``, on the device its tensors are on.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ckpt import checkpoint
from ..core.types import R
from ..models.layers import P, init_params, rmsnorm, tree_map
from ..sim.engine import DECISION_WINDOW, DecisionPoint
from . import env as env_mod

N_TOKENS = 2 * DECISION_WINDOW          # worker window + PS window
TOKEN_DIM = R + 2                       # free fractions + slot pos + pool id


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """The worker head picks a *multiplier on the expert's worker count*
    (0 = reject) rather than a count, so the heuristic prior ("x1") is one
    constant logit pattern and exploration ranks a few ``worker_levels``.
    ``level_to_workers`` maps a level back to the env's count action,
    capped at ``max_workers``."""

    obs_dim: int = env_mod.OBS_DIM
    d_model: int = 64
    worker_levels: Tuple[float, ...] = (0.0, 0.5, 1.0, 1.5, 2.0)
    max_workers: int = env_mod.MAX_WORKERS
    ps_slack_levels: int = env_mod.PS_SLACK_LEVELS

    @property
    def n_worker_actions(self) -> int:
        return len(self.worker_levels)

    @property
    def expert_level(self) -> int:
        return self.worker_levels.index(1.0)

    @property
    def n_scalars(self) -> int:
        return self.obs_dim - N_TOKENS * R

    def level_to_workers(self, level: int, expert_workers: int) -> int:
        """The env's worker-count action for one level."""
        mult = self.worker_levels[int(level)]
        if mult <= 0.0 or expert_workers <= 0:
            return 0
        return int(np.clip(round(mult * expert_workers), 1,
                           self.max_workers))


def policy_spec(cfg: PolicyConfig) -> Dict:
    d = cfg.d_model
    return {
        "job": {"w": P((cfg.n_scalars, d), (None, "embed")),
                "b": P((d,), (None,), "zeros")},
        "tok": {"w": P((TOKEN_DIM, d), (None, "embed"))},
        "attn": {"q": P((d, d), ("embed", "heads")),
                 "k": P((d, d), ("embed", "heads")),
                 "v": P((d, d), ("embed", "heads"))},
        "norm": {"w": P((2 * d,), (None,), "zeros")},
        "mlp": {"w1": P((2 * d, d), ("embed", "mlp")),
                "b1": P((d,), (None,), "zeros"),
                "w2": P((d, d), ("mlp", "embed")),
                "b2": P((d,), (None,), "zeros")},
        "head_w": {"w": P((d, cfg.n_worker_actions), ("embed", None),
                          scale=0.01),
                   "b": P((cfg.n_worker_actions,), (None,), "zeros")},
        "head_s": {"w": P((d, cfg.ps_slack_levels), ("embed", None),
                          scale=0.01),
                   "b": P((cfg.ps_slack_levels,), (None,), "zeros")},
    }


def policy_init(generator: torch.Generator, cfg: PolicyConfig) -> Dict:
    """Fresh float32 parameters drawn from ``generator``, on its device."""
    return init_params(generator, policy_spec(cfg), dtype=torch.float32)


def params_to(params: Dict, device: torch.device) -> Dict:
    return tree_map(lambda x: x.to(device), params,
                    lambda x: isinstance(x, torch.Tensor))


# static per-token tags: slot offset within the window, pool id
_TOKEN_TAGS = np.concatenate([
    np.stack([np.arange(DECISION_WINDOW) / DECISION_WINDOW,
              np.zeros(DECISION_WINDOW)], axis=1),
    np.stack([np.arange(DECISION_WINDOW) / DECISION_WINDOW,
              np.ones(DECISION_WINDOW)], axis=1),
]).astype(np.float32)                    # (2W, 2)
_TAGS: Dict[torch.device, torch.Tensor] = {}


def _tags(device: torch.device) -> torch.Tensor:
    t = _TAGS.get(device)
    if t is None:
        t = _TAGS[device] = torch.from_numpy(_TOKEN_TAGS).to(device)
    return t


def policy_logits(params: Dict, obs: torch.Tensor, cfg: PolicyConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(worker-head logits, slack-head logits) of ``obs`` (..., OBS_DIM)."""
    lead = obs.shape[:-1]
    scalars = obs[..., :cfg.n_scalars]
    tokens = obs[..., cfg.n_scalars:].reshape(*lead, N_TOKENS, R)
    tokens = torch.cat([tokens, _tags(obs.device).expand(*lead, N_TOKENS, 2)],
                       dim=-1)
    x = scalars @ params["job"]["w"] + params["job"]["b"]        # (..., d)
    tok = tokens @ params["tok"]["w"]                            # (..., 2W, d)
    q = x @ params["attn"]["q"]
    k = tok @ params["attn"]["k"]
    v = tok @ params["attn"]["v"]
    scores = (k @ q.unsqueeze(-1)).squeeze(-1) / math.sqrt(q.shape[-1])
    a = torch.softmax(scores, dim=-1)                            # (..., 2W)
    ctx = (a.unsqueeze(-2) @ v).squeeze(-2)                      # (..., d)
    h = rmsnorm(torch.cat([x, ctx], dim=-1), params["norm"]["w"])
    h = F.silu(h @ params["mlp"]["w1"] + params["mlp"]["b1"])
    h = h + F.silu(h @ params["mlp"]["w2"] + params["mlp"]["b2"])
    return (h @ params["head_w"]["w"] + params["head_w"]["b"],
            h @ params["head_s"]["w"] + params["head_s"]["b"])


def _categorical(logits: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """One draw per row of ``logits`` (Gumbel-max), from ``generator``."""
    u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype,
                   device=logits.device)
    u = u.clamp_min(torch.finfo(logits.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _pick(logp: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return logp.gather(-1, a.unsqueeze(-1)).squeeze(-1)


def sample_action(params: Dict, obs: torch.Tensor,
                  generator: torch.Generator, cfg: PolicyConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(action (..., 2), joint log-prob (...))`` drawn from
    ``generator`` (on ``obs``'s device)."""
    lw, ls = policy_logits(params, obs, cfg)
    aw = _categorical(lw, generator)
    asl = _categorical(ls, generator)
    logp = (_pick(torch.log_softmax(lw, dim=-1), aw)
            + _pick(torch.log_softmax(ls, dim=-1), asl))
    return torch.stack([aw, asl], dim=-1), logp


def greedy_action(params: Dict, obs: torch.Tensor,
                  cfg: PolicyConfig) -> torch.Tensor:
    lw, ls = policy_logits(params, obs, cfg)
    return torch.stack([torch.argmax(lw, dim=-1), torch.argmax(ls, dim=-1)],
                       dim=-1)


def action_log_prob(params: Dict, obs: torch.Tensor, action: torch.Tensor,
                    cfg: PolicyConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(joint log-prob of ``action`` (..., 2), summed head entropy): the
    REINFORCE loss terms of each (obs, action) pair."""
    lw, ls = policy_logits(params, obs, cfg)
    lpw = torch.log_softmax(lw, dim=-1)
    lps = torch.log_softmax(ls, dim=-1)
    ent = (-(torch.exp(lpw) * lpw).sum(-1)
           - (torch.exp(lps) * lps).sum(-1))
    action = action.long()
    return _pick(lpw, action[..., 0]) + _pick(lps, action[..., 1]), ent


def top2_margin(logits: torch.Tensor) -> torch.Tensor:
    """The gap between the largest and the second largest logit of each
    row: how far a greedy choice is from a tie."""
    top = torch.topk(logits, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


# ---------------------------------------------------------------------------
# checkpointing (ckpt/checkpoint.py: manifest + crc32'd npz, atomic publish)
# ---------------------------------------------------------------------------

def save_policy(ckpt_dir: str, params: Dict, cfg: PolicyConfig,
                step: int = 0, extra: Optional[Dict] = None) -> Path:
    meta = {"policy_cfg": dataclasses.asdict(cfg), **(extra or {})}
    return checkpoint.save(ckpt_dir, step, params, extra=meta)


def load_policy(ckpt_dir: str, step: Optional[int] = None,
                device: Optional[Union[str, torch.device]] = None
                ) -> Tuple[Dict, PolicyConfig, Dict]:
    """``(params, cfg, extra)`` of the latest (or the given) step, the
    parameters on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    if step is None:
        step = checkpoint.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
    manifest = json.loads(
        (Path(ckpt_dir) / f"ckpt_{step}" / "manifest.json").read_text())
    raw = dict(manifest["extra"]["policy_cfg"])
    raw["worker_levels"] = tuple(raw["worker_levels"])   # json list -> tuple
    cfg = PolicyConfig(**raw)
    target = params_to(policy_init(torch.Generator().manual_seed(0), cfg),
                       device)
    params, extra = checkpoint.restore(ckpt_dir, step, target)
    return params, cfg, extra


# ---------------------------------------------------------------------------
# engine adapter
# ---------------------------------------------------------------------------

class LearnedDecider:
    """An ``engine.run(..., policy=...)`` callable around a policy, on
    ``device`` (None: the CUDA card; the parameters are moved there).

    Greedy by default; ``greedy=False`` samples from a generator seeded
    with ``seed``.  The observation needs the cluster, which the engine
    does not pass: it is bound here.  A decision on the card is the
    forward pass's launches and one copy of the action to the host.
    ``track_margins=True`` records each decision's smallest top-two logit
    gap over both heads in ``margins`` (one more copy per decision).
    """

    def __init__(self, params: Dict, cfg: PolicyConfig, cluster,
                 greedy: bool = True, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 track_margins: bool = False):
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.cfg = cfg
        self.cluster = cluster
        self.greedy = greedy
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.margins: Optional[List[float]] = [] if track_margins else None
        # one pass now, so the first decision's time holds no one-off
        # set-up (the card's library handles); greedy draws nothing
        with torch.no_grad():
            greedy_action(self.params, torch.zeros(cfg.obs_dim,
                                                   device=self.device), cfg)

    def act(self, obs: np.ndarray) -> np.ndarray:
        """The (level, slack) action of one observation, on the host."""
        with torch.no_grad():
            o = torch.from_numpy(obs).to(self.device)
            if self.margins is not None:
                lw, ls = policy_logits(self.params, o, self.cfg)
                self.margins.append(float(torch.minimum(
                    top2_margin(lw), top2_margin(ls))))
            if self.greedy:
                a = greedy_action(self.params, o, self.cfg)
            else:
                a = sample_action(self.params, o, self.generator,
                                  self.cfg)[0]
            return a.cpu().numpy()

    def __call__(self, dp: DecisionPoint):
        level, slack = self.act(env_mod.observe(dp, self.cluster))
        w = self.cfg.level_to_workers(int(level), int(dp.expert[0]))
        return env_mod.engine_action(dp, (w, int(slack)))


def default_policy(cluster, seed: int = 0,
                   cfg: Optional[PolicyConfig] = None,
                   device: Optional[Union[str, torch.device]] = None,
                   track_margins: bool = False) -> LearnedDecider:
    """A seed-initialized (untrained) greedy decider: the smoke runs'
    stand-in when no checkpoint is given.  Its parameters are drawn on
    the CPU, so every device runs the same ones."""
    cfg = cfg or PolicyConfig()
    return LearnedDecider(policy_init(torch.Generator().manual_seed(seed),
                                      cfg), cfg, cluster, greedy=True,
                          device=device, track_margins=track_margins)

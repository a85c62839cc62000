"""The learned scheduler (Decima / DL2 direction), as the reference's
``repro/rl``.

``env``    — ``ClusterSchedulingEnv``: the port's event engine as a
             stepwise per-arrival decision process; replaying the expert
             action equals ``sim.engine.run`` for OASiS (both routes) and
             every reactive scheduler.
``policy`` — the policy network (an MLP and a single-head attention
             read-out over the capacity window, built from
             ``models/layers.py`` specs) and ``LearnedDecider``, which
             plugs it into ``engine.run(scheduler="learned", policy=...)``.
``train``  — REINFORCE with a baseline and a behaviour-cloning warm
             start (autograd, Adam, lockstep batched rollouts,
             checkpoints through ``ckpt/checkpoint.py``).
"""
from . import env, policy

__all__ = ["env", "policy"]

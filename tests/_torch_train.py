"""Shared pieces of the training parity tests (test_torch_train_dense.py:
StarCoder2, OLMoE, DeepSeek-V3; test_torch_train_ssm.py: Mamba2,
Whisper): the smoke configs' parameters drawn by the JAX package and
carried across, the seeded batches, and the two checks, in float32.

* ``check_forward``: ``forward_train``'s logits and MTP logits at
  relative max-abs 1e-4 against the JAX value (the prefill parity
  tests' bound: the same float32 math in another order), ``moe_aux`` at
  relative 1e-5 (exactly 0 without experts);
* ``check_grads``: ``loss_fn``'s metrics at relative 1e-5 and every
  gradient leaf at relative max-abs 1e-4 against
  ``jax.value_and_grad(loss_fn, has_aux=True)``, a leaf whose JAX
  gradient is all zero exactly zero.

``remat`` (the reference's ``jax.checkpoint``, the port's
``torch.utils.checkpoint``) is on in every smoke config and changes no
value; one case runs without it."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_dense as dense
from repro.configs import get_smoke as jax_get_smoke
from repro.models import init_model as jax_init_model
from repro.models.model import forward_train as jax_forward_train
from repro.train.steps import TrainHyper as JaxHyper
from repro.train.steps import loss_fn as jax_loss_fn
from repro_torch.configs import get_smoke
from repro_torch.models import convert
from repro_torch.models.layers import tree_leaves
from repro_torch.models.model import forward_train
from repro_torch.train.steps import TrainHyper, value_and_grad

B = 2


def batches(cfg, S, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
         "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    b["labels"][0, :3] = -1                  # ignored positions
    if cfg.family == "encdec":
        b["frames"] = (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
                       * 0.1).astype(np.float32)
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
          for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    return jb, tb


def make_smoke(arch, **changes):
    """(JAX config, port config, JAX params, port params) in float32, as
    ``_torch_dense.make_smoke`` makes them, the JAX parameters drawn under
    ``jax.jit`` (seconds faster than eagerly at these trees)."""
    kw = dict(dtype="float32", param_dtype="float32", **changes)
    jcfg = jax_get_smoke(arch).scaled(**kw)
    cfg = get_smoke(arch).scaled(**kw)
    jparams = jax.jit(jax_init_model, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def rel(got, want):
    return dense.rel(got.detach(), np.asarray(want))


def _jax_reference(jparams, jcfg, jb):
    """forward_train's outputs and value_and_grad(loss_fn)'s, one
    compilation for both."""
    fwd = jax_forward_train(jparams, jcfg, jb)
    return fwd, jax.value_and_grad(jax_loss_fn, has_aux=True)(
        jparams, jcfg, jb, JaxHyper())


def make_case(arch, S, changes):
    """(port config, port params, port batch, the JAX reference's
    outputs) for one case."""
    jcfg, cfg, jparams, params = make_smoke(arch, **changes)
    jb, tb = batches(cfg, S, seed=S)
    want = jax.jit(_jax_reference, static_argnums=1)(jparams, jcfg, jb)
    return cfg, params, tb, want


def case_id(arch, S, changes):
    return f"{arch}-S{S}" + ("-noremat" if changes else "")


def check_forward(case):
    cfg, params, tb, ((want_logits, want_aux), _) = case
    with torch.no_grad():
        logits, aux = forward_train(params, cfg, tb)
    assert logits.dtype == torch.float32
    assert rel(logits, want_logits) < 1e-4
    assert sorted(aux) == sorted(want_aux)
    want_moe = float(want_aux["moe_aux"])
    if cfg.n_experts:
        assert want_moe > 0
        assert abs(float(aux["moe_aux"]) - want_moe) <= 1e-5 * want_moe
    else:
        assert float(aux["moe_aux"]) == want_moe == 0.0
    if cfg.mtp_depth:
        assert rel(aux["mtp_logits"], want_aux["mtp_logits"]) < 1e-4


def check_grads(case):
    cfg, params, tb, (_, ((want_loss, want_m), want_g)) = case
    metrics, grads = value_and_grad(params, cfg, tb, TrainHyper())
    assert sorted(metrics) == sorted(want_m)
    for k in want_m:
        w = float(want_m[k])
        assert abs(float(metrics[k]) - w) <= 1e-5 * abs(w), k
    want = jax.tree_util.tree_leaves(want_g)
    assert len(grads) == len(want) == len(
        tree_leaves(params, lambda x: isinstance(x, torch.Tensor)))
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape, i
        w = np.asarray(w)
        if not np.any(w):
            assert not torch.any(g), i
            continue
        assert rel(g, w) < 1e-4, i
    # the caller's parameters are left as they were: no grad flags set
    assert not any(x.requires_grad for x in
                   tree_leaves(params, lambda x: isinstance(x, torch.Tensor)))

"""The port's MoE family against the JAX package's, on the CPU, at smoke
size and in float32: the expert ranking, ``moe_block`` under both
routers (OLMoE's softmax; DeepSeek-V3's sigmoid with its shared expert),
qk-norm attention, and OLMoE's prefill, decode and serving route.  The
prefill, decode and serve checks and their tolerances are
``_torch_dense.py``'s.

The capacity is ``ceil(T * k / E * capacity_factor)`` over the T tokens
of one call, so a prefill and one-token decode steps drop different
assignments.  Prefill and decode are therefore each held to the
reference's own prefill and decode at the default capacity, drops and
all; only the serving route, which the reference's launcher
teacher-forces through decode, is compared at a capacity that drops
nothing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dense as dense
from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import get_smoke as jax_get_smoke
from repro.models import moe as jax_moe
from repro.models.attention import attention as jax_attention
from repro.models.attention import attn_specs as jax_attn_specs
from repro.models.layers import init_params as jax_init_params
from repro_torch.configs import get_smoke
from repro_torch.models import convert, moe
from repro_torch.models.attention import attention

ROUTERS = ["olmoe_1b_7b", "deepseek_v3_671b"]


def _carry(tree):
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _cfgs(arch, **changes):
    kw = dict(dtype="float32", param_dtype="float32", **changes)
    return jax_get_smoke(arch).scaled(**kw), get_smoke(arch).scaled(**kw)


def _moe_params(jcfg):
    jp = jax_init_params(jax.random.PRNGKey(5), jax_moe.moe_specs(jcfg))
    return jp, _carry(jp)


@pytest.mark.parametrize("case", ["random", "one_expert", "empty_expert"])
def test_rank_in_expert_matches_oracle_and_jax(case):
    E = 8
    rng = np.random.default_rng(3)
    ids = rng.integers(0, E, 301)
    if case == "one_expert":
        ids[:] = 5
    elif case == "empty_expert":
        ids[ids == 2] = 6
    got = moe._rank_in_expert(torch.from_numpy(ids), E)
    oracle = moe._rank_in_expert_ref(torch.from_numpy(ids), E)
    want = jax_moe._rank_in_expert(jnp.asarray(ids, jnp.int32), E)
    assert np.array_equal(got.numpy(), oracle.numpy())
    assert np.array_equal(got.numpy(), np.asarray(want))
    if case == "one_expert":
        assert np.array_equal(got.numpy(), np.arange(301))


@pytest.mark.parametrize("no_drop", [False, True])
@pytest.mark.parametrize("arch", ROUTERS)
def test_moe_block_matches_jax(arch, no_drop):
    """``out`` at relative 1e-5, ``aux`` at 1e-6 of its value, and the same
    experts chosen and the same assignments kept: at the default capacity
    some are dropped, at ``capacity_factor = n_experts`` none."""
    jcfg, cfg = _cfgs(arch)
    if no_drop:
        jcfg, cfg = _cfgs(arch, capacity_factor=float(cfg.n_experts))
    jp, p = _moe_params(jcfg)
    x = (np.random.default_rng(7).standard_normal((2, 45, cfg.d_model))
         * 2.0).astype(np.float32)
    want, want_aux = jax_moe.moe_block(jp, jcfg, jnp.asarray(x))
    got, aux = moe.moe_block(p, cfg, torch.from_numpy(x))
    assert dense.rel(got, want) < 1e-5
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    assert (cfg.router_type == "sigmoid") == (arch == "deepseek_v3_671b")
    assert ("shared" in p) == (arch == "deepseek_v3_671b")

    xt = x.reshape(-1, cfg.d_model)
    T = xt.shape[0]
    jids, _ = jax_moe._router_probs(
        jcfg, jnp.asarray(xt) @ jp["router"])
    ids, _ = moe._router_probs(cfg, torch.from_numpy(xt) @ p["router"])
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    cap = moe.capacity(cfg, T)
    keep = moe._rank_in_expert(ids.reshape(-1), cfg.n_experts) < cap
    jkeep = jax_moe._rank_in_expert(jids.reshape(-1), jcfg.n_experts) < cap
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    assert bool(keep.all()) == no_drop


@pytest.mark.parametrize("S", [64, 300])
def test_qk_norm_attention_matches_jax(S):
    """Both branches (S * S <= 256 * 256: naive; above: chunked), with
    non-zero norm weights."""
    jcfg, cfg = _cfgs("olmoe_1b_7b")
    assert cfg.qk_norm
    jp = jax_init_params(jax.random.PRNGKey(9), jax_attn_specs(jcfg))
    rng = np.random.default_rng(S)
    jp = dict(jp, qn=jnp.asarray(rng.standard_normal(cfg.head_dim) * 0.3,
                                 jnp.float32),
              kn=jnp.asarray(rng.standard_normal(cfg.head_dim) * 0.3,
                             jnp.float32))
    p = _carry(jp)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S)
    want, _ = jax_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got, _ = attention(p, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert dense.rel(got, want) < 1e-5
    # the norm is taken: without it the output moves
    bare = {k: v for k, v in p.items() if k not in ("qn", "kn")}
    other, _ = attention(bare, cfg, torch.from_numpy(x),
                         torch.from_numpy(pos))
    assert dense.rel(other, want) > 1e-3


@pytest.fixture(scope="module")
def olmoe():
    return dense.make_smoke("olmoe_1b_7b")


@pytest.mark.parametrize("S", [64, 300])
def test_olmoe_prefill_matches_jax(olmoe, S):
    dense.check_prefill(olmoe, S, seed=S)


def test_olmoe_decode_from_prefill_into_cache_matches_jax(olmoe):
    """At the default capacity: each decode step routes B = 2 tokens at a
    capacity of 1, so assignments are dropped on both sides alike."""
    _, cfg, _, _ = olmoe
    assert moe.capacity(cfg, dense.B) == 1
    dense.check_decode(olmoe, 300, seed=11)


def test_olmoe_serve_route_matches_jax_teacher_forced():
    """The serving route (prefill, then greedy decode) against the JAX
    launcher's route (the prompt one token at a time through
    ``decode_step``), at ``capacity_factor = n_experts`` and with a
    float32 cache on the JAX side: at the default capacity the two routes
    drop different assignments (a prefill routes all B * S prompt tokens
    in one call, a decode step B), and a bfloat16 cache moves the router
    logits by bf16 rounding, enough to flip a near-tied top-k choice.
    Either is a difference of route or rounding, not a fault."""
    smoke = dense.make_smoke("olmoe_1b_7b", capacity_factor=8.0)
    assert smoke[1].n_experts == 8
    dense.check_serve(smoke, cache_dtype=jnp.float32)

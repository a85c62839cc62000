"""The port's MLA (DeepSeek-V3) against the JAX package's, on the CPU, at
smoke size and in float32: ``mla_attention``'s dense branch, its chunked
branch (``_mla_flash``, reached by patching both packages'
``FLASH_THRESHOLD``) and its absorbed decode; DeepSeek-V3's smoke
prefill (logits and the latent ``ckv``/``kr`` caches) through both
branches, 8 decode steps and the serving route (checks and tolerances of
``_torch_dense.py``); and the bfloat16 parameter tree carried across bit
for bit, the multi-token-prediction subtree with it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dense as dense
from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import get_smoke as jax_get_smoke
from repro.models import init_model as jax_init_model
from repro.models import mla as jax_mla
from repro.models.layers import init_params as jax_init_params
from repro_torch.configs import get_smoke
from repro_torch.models import convert, mla
from repro_torch.models.layers import param_count

ARCH = "deepseek_v3_671b"


@pytest.fixture(scope="module")
def layer():
    """(JAX config, port config, JAX MLA params, port MLA params) of the
    DeepSeek-V3 smoke config, float32."""
    kw = dict(dtype="float32", param_dtype="float32")
    jcfg, cfg = jax_get_smoke(ARCH).scaled(**kw), get_smoke(ARCH).scaled(**kw)
    jp = jax_init_params(jax.random.PRNGKey(3), jax_mla.mla_specs(jcfg))
    p = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    return jcfg, cfg, jp, p


def _x(cfg, S, seed=0, batch=2):
    return (np.random.default_rng(seed).standard_normal(
        (batch, S, cfg.d_model)) * 0.3).astype(np.float32)


def _both(jp, jcfg, p, cfg, x):
    S = x.shape[1]
    want, _ = jax_mla.mla_attention(jp, jcfg, jnp.asarray(x), jnp.arange(S))
    with torch.inference_mode():
        got, _ = mla.mla_attention(p, cfg, torch.from_numpy(x),
                                   torch.arange(S))
    return got, want


@pytest.mark.parametrize("S", [48, 300])
def test_mla_dense_and_chunked_branches_match_jax(layer, S, monkeypatch):
    jcfg, cfg, jp, p = layer
    x = _x(cfg, S, seed=S)
    got_dense, want = _both(jp, jcfg, p, cfg, x)
    assert dense.rel(got_dense, want) < 1e-5
    monkeypatch.setattr(jax_mla, "FLASH_THRESHOLD", 8)
    monkeypatch.setattr(mla, "FLASH_THRESHOLD", 8)
    got, want_flash = _both(jp, jcfg, p, cfg, x)
    assert dense.rel(got, want_flash) < 1e-5
    # the reference's own bound between its branches
    assert dense.rel(got, got_dense) < 2e-5


def test_mla_flash_over_several_chunks_matches_jax(layer):
    """``_mla_flash`` at a chunk of 64 keys over 300 positions (5 chunks,
    the last ragged) against the reference's at the same chunk."""
    jcfg, cfg, jp, p = layer
    S = 300
    x = _x(cfg, S, seed=1)
    pos = np.arange(S)
    scale = 1.0 / np.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    lr, H = cfg.kv_lora_rank, cfg.n_heads
    nope = cfg.qk_nope_dim
    jq = jax_mla._project_q(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    jkv = jax_mla._latent_kv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    jw = jp["wkv_b"].reshape(lr, H, -1)
    want = jax_mla._mla_flash(jcfg, *jq, *jkv, jw[..., :nope], jw[..., nope:],
                              jnp.asarray(pos), scale, chunk=64)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    q_nope, q_rope = mla._project_q(p, cfg, tx, tpos)
    ckv, kr = mla._latent_kv(p, cfg, tx, tpos)
    w = p["wkv_b"].reshape(lr, H, -1)
    got = mla._mla_flash(q_nope, q_rope, ckv, kr, w[..., :nope],
                         w[..., nope:], tpos, scale, chunk=64)
    assert dense.rel(got, want) < 1e-5


def test_mla_absorbed_decode_matches_jax(layer):
    """One position at a time through the absorbed form from a latent
    cache, written in place: against the reference's decode, step by
    step, and against the expanded prefill."""
    jcfg, cfg, jp, p = layer
    B, S = 2, 12
    x = _x(cfg, S, seed=2)
    full, _ = _both(jp, jcfg, p, cfg, x)
    jcache = {"ckv": jnp.zeros((B, S, cfg.kv_lora_rank)),
              "kr": jnp.zeros((B, S, cfg.qk_rope_dim))}
    cache = {"ckv": torch.zeros((B, S, cfg.kv_lora_rank)),
             "kr": torch.zeros((B, S, cfg.qk_rope_dim))}
    outs = []
    for i in range(S):
        want, jcache = jax_mla.mla_attention(
            jp, jcfg, jnp.asarray(x[:, i:i + 1]), jnp.arange(i, i + 1),
            cache=jcache, cache_len=jnp.int32(i))
        with torch.inference_mode():
            got, new = mla.mla_attention(
                p, cfg, torch.from_numpy(x[:, i:i + 1]),
                torch.arange(i, i + 1), cache=cache, cache_len=i)
        assert new["ckv"] is cache["ckv"]           # written in place
        assert dense.rel(got, want) < 1e-5, i
        outs.append(got)
    for key in ("ckv", "kr"):
        assert dense.rel(cache[key], jcache[key]) < 1e-5, key
    assert dense.rel(torch.cat(outs, 1), full) < 2e-5


@pytest.fixture(scope="module")
def deepseek():
    return dense.make_smoke(ARCH)


@pytest.mark.parametrize("threshold", [4096, 8])
@pytest.mark.parametrize("S", [64, 300])
def test_deepseek_prefill_matches_jax(deepseek, S, threshold, monkeypatch):
    """Logits and the ``ckv``/``kr`` leaves of both MLA groups (1 dense
    layer, 3 MoE layers), through the dense branch and, with both
    thresholds at 8, the chunked one."""
    monkeypatch.setattr(jax_mla, "FLASH_THRESHOLD", threshold)
    monkeypatch.setattr(mla, "FLASH_THRESHOLD", threshold)
    cache = dense.check_prefill(deepseek, S, seed=S + threshold)
    assert sorted(cache) == ["dense", "moe"]
    assert sorted(cache["moe"]) == ["ckv", "kr"]


def test_deepseek_decode_from_prefill_into_cache_matches_jax(deepseek):
    """At the default capacity (capacity factor 1: each decode step routes
    B = 2 tokens to one slot per expert)."""
    pcache = dense.check_decode(deepseek, 300, seed=11)
    assert pcache["moe"]["ckv"].shape[2] == 300 + dense.STEPS


def test_deepseek_serve_route_matches_jax_teacher_forced():
    """As ``test_torch_moe.py``'s OLMoE case, at ``capacity_factor =
    n_experts`` and with a float32 cache on the JAX side: at the default
    capacity a prefill and one-token steps drop different assignments,
    and bfloat16 rounding of the latent cache can flip a near-tied top-k
    choice of the sigmoid router."""
    smoke = dense.make_smoke(ARCH, capacity_factor=8.0)
    dense.check_serve(smoke, cache_dtype=jnp.float32)


def test_bfloat16_tree_carried_across_bit_for_bit():
    """DeepSeek-V3's smoke tree in its own parameter dtype (bfloat16),
    the multi-token-prediction subtree included."""
    jcfg = jax_get_smoke(ARCH)
    assert jcfg.param_dtype == "bfloat16" and jcfg.mtp_depth == 1
    jparams = jax_init_model(jax.random.PRNGKey(2), jcfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    assert sorted(params["mtp"]) == ["layer", "norm_e", "norm_h", "proj"]
    n = 0
    for path, got, want in dense.pairs(params, jparams):
        want = np.asarray(want)
        assert got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                              want.view(np.uint16)), path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(jparams))
    assert param_count(params) == sum(
        x.size for x in jax.tree_util.tree_leaves(jparams))

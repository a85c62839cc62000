"""Shared pieces of the dense and MoE families' parity tests
(test_torch_dense.py: granite, starcoder2, pixtral; test_torch_gemma2.py:
both gemma2 configs and the rolling local cache; test_torch_moe.py and
test_torch_mla.py: OLMoE and DeepSeek-V3).

The JAX package's own initialised parameters are carried across as numpy
arrays (``models/convert.py::params_from_numpy``) and the same seeded
numpy tokens go through both, everything in float32:

* ``prefill``: the last logits and every cache leaf at relative max-abs
  1e-4, at S = 300 (S * S > 256 * 256: the chunked attention branch) and
  at S = 64 (the naive branch);
* 8 ``decode_step``s from ``serve/steps.py::prefill_into_cache`` against
  the JAX decode from the JAX prefill's cache moved into a decode cache
  by this module's own glue (a local cache shorter than the prompt keeps
  the last L positions, position p at slot p % L), at 1e-4;
* the port's serving route (prefill, then greedy decode) against the JAX
  launcher's teacher-forced route (the prompt one token at a time
  through ``decode_step`` into its default bfloat16 cache), at relative
  2e-2 (the JAX package's bound for decode against a full forward,
  ``tests/test_models.py::test_decode_matches_train_forward``) and with
  the same greedy tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models.model import prefill as jax_prefill
from repro_torch.configs import get_smoke
from repro_torch.models import convert
from repro_torch.models.model import decode_step, prefill
from repro_torch.serve import steps

B, STEPS = 2, 8


def rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) / (
        float(np.max(np.abs(want))) + 1e-9)


def pairs(port, ref, path=""):
    """(path, port leaf, reference leaf) over two trees of one nesting."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), (path, sorted(port), sorted(ref))
        for k in ref:
            yield from pairs(port[k], ref[k], f"{path}/{k}")
    else:
        yield path, port, ref


def make_smoke(arch, **changes):
    """(JAX config, port config, JAX params, port params), float32."""
    jcfg = jax_get_smoke(arch).scaled(dtype="float32", param_dtype="float32",
                                      **changes)
    cfg = get_smoke(arch).scaled(dtype="float32", param_dtype="float32",
                                 **changes)
    jparams = jax_init_model(jax.random.PRNGKey(1), jcfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


def tokens(cfg, n, seed, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (batch, n))


def patch_embeds(cfg, seed, batch=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, cfg.n_patches, cfg.d_model))
            * 0.1).astype(np.float32)


def n_cache_leaves(cfg):
    """K and V per layer group: one for plain layers, local and global
    for gemma2's pairs; ckv and kr for each of DeepSeek-V3's MLA groups
    (dense, moe)."""
    if cfg.use_mla:
        return 4 if cfg.n_dense_layers else 2
    return 4 if cfg.local_global else 2


def jax_decode_cache(jcfg, pcache, max_len, batch=B):
    """The JAX prefill's cache in ``init_cache(..., float32)``: K/V at
    positions [0, S), or, for a leaf of L < S slots, the last L positions
    at slot p % L (the state the JAX decode reaches feeding the prompt one
    token at a time)."""
    cache = jax_init_cache(jcfg, batch, max_len, dtype=jnp.float32)

    def put(dst, src):
        if isinstance(dst, dict):
            return {k: put(dst[k], src[k]) for k in dst}
        S, L = src.shape[2], dst.shape[2]
        if S <= L:
            return dst.at[:, :, :S].set(src)
        slots = np.arange(S - L, S) % L
        return dst.at[:, :, slots].set(src[:, :, S - L:])
    return put(cache, pcache)


def check_prefill(smoke, S, seed, with_patches=False):
    """Prefill logits and every cache leaf at relative 1e-4."""
    jcfg, cfg, jparams, params = smoke
    toks = tokens(cfg, S, seed)
    jbatch = {"tokens": jnp.asarray(toks)}
    batch = {"tokens": torch.from_numpy(toks)}
    if with_patches:
        pe = patch_embeds(cfg, seed)
        jbatch["patch_embeds"] = jnp.asarray(pe)
        batch["patch_embeds"] = torch.from_numpy(pe)
    want_logits, want_cache = jax_prefill(jparams, jcfg, jbatch, S)
    with torch.inference_mode():
        logits, cache = prefill(params, cfg, batch, S)
    assert logits.shape == want_logits.shape
    assert rel(logits, want_logits) < 1e-4
    leaves = list(pairs(cache, want_cache))
    assert len(leaves) == n_cache_leaves(cfg)
    for path, p, r in leaves:
        assert p.shape[2] == S, path
        assert rel(p, r) < 1e-4, path
    return want_cache


def check_decode(smoke, S, seed, with_patches=False):
    """8 decode steps from ``prefill_into_cache`` against the JAX decode
    from the glued JAX cache: logits each step, every cache leaf after
    the last, relative 1e-4.  Returns the port's decode cache."""
    jcfg, cfg, jparams, params = smoke
    toks = tokens(cfg, S + STEPS, seed)
    jbatch = {"tokens": jnp.asarray(toks[:, :S])}
    pe = None
    if with_patches:
        pe = patch_embeds(cfg, seed)
        jbatch["patch_embeds"] = jnp.asarray(pe)
        pe = torch.from_numpy(pe)
    max_len = S + STEPS
    want_logits, want_cache = jax_prefill(jparams, jcfg, jbatch, S)
    jcache = jax_decode_cache(jcfg, want_cache, max_len)
    logits, pcache = steps.prefill_into_cache(
        params, cfg, torch.from_numpy(toks[:, :S]), max_len, patch_embeds=pe)
    assert rel(logits, want_logits) < 1e-4
    for path, p, r in pairs(pcache, jcache):
        assert rel(p, r) < 1e-4, path
    jstep = jax.jit(lambda p, t, c, n: jax_decode_step(p, jcfg, t, c, n))
    for i in range(STEPS):
        tok = toks[:, S + i:S + i + 1]
        want, jcache = jstep(jparams, jnp.asarray(tok), jcache,
                             jnp.int32(S + i))
        with torch.inference_mode():
            got, pcache = decode_step(params, cfg, torch.from_numpy(tok),
                                      pcache, S + i)
        assert rel(got, want) < 1e-4, i
    for path, p, r in pairs(pcache, jcache):
        assert rel(p, r) < 1e-4, path
    return pcache


def check_serve(smoke, prompt=40, gen=6, seed=12, cache_dtype=jnp.bfloat16):
    """The port's serving route against the JAX launcher's teacher-forced
    route (its cache in ``cache_dtype``, the launcher's bfloat16 by
    default): the same greedy tokens, logits at relative 2e-2."""
    jcfg, cfg, jparams, params = smoke
    toks = tokens(cfg, prompt, seed)
    jstep = jax.jit(lambda p, t, c, n: jax_decode_step(p, jcfg, t, c, n))
    jcache = jax_init_cache(jcfg, B, prompt + gen, dtype=cache_dtype)
    for i in range(prompt):
        lg, jcache = jstep(jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
                           jnp.int32(i))
    want_logits = [lg]
    want_toks = [jnp.argmax(lg[:, :, :jcfg.vocab_size], -1)]
    for i in range(gen - 1):
        lg, jcache = jstep(jparams, want_toks[-1], jcache,
                           jnp.int32(prompt + i))
        want_logits.append(lg)
        want_toks.append(jnp.argmax(lg[:, :, :jcfg.vocab_size], -1))
    out, logits = steps.generate(params, cfg, torch.from_numpy(toks), gen)
    assert np.array_equal(out.numpy(), np.concatenate(
        [np.asarray(t) for t in want_toks], 1))
    assert rel(logits, jnp.concatenate(want_logits, 1)) < 2e-2

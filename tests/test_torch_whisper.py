"""The port's enc-dec family (Whisper-large-v3) against the JAX package's,
on the CPU, at smoke size (2 encoder and 4 decoder layers, d 64, 4 heads,
2 KV heads, head dim 16, ``encoder_seq`` 16), float32.

The JAX package's initialised parameters are carried across
(``models/convert.py``), and the same seeded numpy tokens and frame
embeddings go through both:

* the sinusoidal position table bit for bit;
* one encoder layer and one decoder layer (prefill, with its cache) at
  relative 1e-5, and ``encdec_prepare`` (encoder states, cross K/V) at
  1e-5;
* prefill logits and the whole cache (``self`` and ``cross``) at 1e-4;
* 8 ``decode_step``s from ``prefill_into_cache`` against the JAX decode
  from the JAX prefill's cache at 1e-4;
* the port's launcher route (prefill, then greedy decode) against the
  JAX launcher's teacher-forced route (``encdec_prepare``, then the
  prompt one token at a time through ``decode_step`` into its bfloat16
  cache): the same greedy tokens, logits at relative 2e-2;
* a second case with ``encoder_seq`` 320 and a prompt of 260, where the
  encoder (320 x 320), the cross-attention (260 x 320) and the decoder's
  self-attention (260 x 260) each pass 256 x 256 and take the chunked
  branch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dense as dense
from _torch_parity import one_torch_thread  # noqa: F401
from repro.models import blocks as jax_blocks
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models.layers import sinusoidal_positions as jax_sinusoidal
from repro.models.model import encdec_prepare as jax_encdec_prepare
from repro.models.model import prefill as jax_prefill
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.models.model import decode_step, encdec_prepare, prefill
from repro_torch.serve import steps

ARCH = "whisper_large_v3"
B, STEPS = 2, 8
rel = dense.rel


@pytest.fixture(scope="module")
def smoke():
    return dense.make_smoke(ARCH)


@pytest.fixture(scope="module")
def long_smoke():
    """Smoke width with 320 frames: every attention takes the chunked
    branch at a prompt of 260."""
    return dense.make_smoke(ARCH, encoder_seq=320)


def _frames(cfg, seed, batch=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model))
            * 0.1).astype(np.float32)


def _layer(tree, i=0):
    return jax.tree_util.tree_map(lambda x: x[i], tree)


def _torch_layer(tree, i=0):
    if isinstance(tree, dict):
        return {k: _torch_layer(v, i) for k, v in tree.items()}
    return tree[i]


@pytest.mark.parametrize("length,dim", [(16, 64), (320, 64), (256, 1280),
                                        (1500, 1280), (7, 10)])
def test_sinusoidal_positions_bit_for_bit(length, dim):
    got = sinusoidal_positions(length, dim, "cpu")
    want = np.asarray(jax_sinusoidal(length, dim))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_enc_layer_matches_jax(smoke):
    jcfg, cfg, jparams, params = smoke
    x = _frames(cfg, 1)
    pos = np.arange(cfg.encoder_seq)
    want, _, _ = jax_blocks.enc_layer(
        _layer(jparams["groups"]["encoder"], 1), jcfg, jnp.asarray(x),
        {"enc_positions": jnp.asarray(pos)})
    with torch.inference_mode():
        got, cache = blocks.enc_layer(
            _torch_layer(params["groups"]["encoder"], 1), cfg,
            torch.from_numpy(x), {"enc_positions": torch.from_numpy(pos)})
    assert cache is None
    assert rel(got, want) < 1e-5


def test_dec_layer_matches_jax(smoke):
    """Prefill mode: the output and its self and cross K/V."""
    jcfg, cfg, jparams, params = smoke
    rng = np.random.default_rng(2)
    S = 12
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    enc = _frames(cfg, 3) * 10
    pos, epos = np.arange(S), np.arange(cfg.encoder_seq)
    want, wcache, _ = jax_blocks.dec_layer(
        _layer(jparams["groups"]["decoder"], 2), jcfg, jnp.asarray(h),
        {"positions": jnp.asarray(pos), "enc": jnp.asarray(enc),
         "enc_positions": jnp.asarray(epos), "return_cache": True}, None)
    with torch.inference_mode():
        got, cache = blocks.dec_layer(
            _torch_layer(params["groups"]["decoder"], 2), cfg,
            torch.from_numpy(h),
            {"positions": torch.from_numpy(pos),
             "enc": torch.from_numpy(enc),
             "enc_positions": torch.from_numpy(epos),
             "return_cache": True}, None)
    assert rel(got, want) < 1e-5
    leaves = list(dense.pairs(cache, wcache))
    assert len(leaves) == 4
    for path, p, r in leaves:
        assert rel(p, r) < 1e-5, path


def test_encdec_prepare_matches_jax(smoke):
    jcfg, cfg, jparams, params = smoke
    frames = _frames(cfg, 4)
    want_enc, want_cross = jax_encdec_prepare(jparams, jcfg,
                                              jnp.asarray(frames))
    with torch.inference_mode():
        enc, cross = encdec_prepare(params, cfg, torch.from_numpy(frames))
    assert rel(enc, want_enc) < 1e-5
    for path, p, r in dense.pairs(cross, want_cross):
        assert p.shape == (cfg.n_layers, B, cfg.encoder_seq, cfg.n_kv_heads,
                           cfg.head_dim), path
        assert rel(p, r) < 1e-5, path


def _check_prefill(smoke, S, seed):
    jcfg, cfg, jparams, params = smoke
    toks, frames = dense.tokens(cfg, S, seed), _frames(cfg, seed)
    want_logits, want_cache = jax_prefill(
        jparams, jcfg, {"tokens": jnp.asarray(toks),
                        "frames": jnp.asarray(frames)}, S)
    with torch.inference_mode():
        logits, cache = prefill(params, cfg, {
            "tokens": torch.from_numpy(toks),
            "frames": torch.from_numpy(frames)}, S)
    assert rel(logits, want_logits) < 1e-4
    leaves = list(dense.pairs(cache, want_cache))
    assert [p for p, _, _ in leaves] == ["/decoder/cross/k",
                                         "/decoder/cross/v",
                                         "/decoder/self/k", "/decoder/self/v"]
    for path, p, r in leaves:
        assert p.shape[2] == (cfg.encoder_seq if "cross" in path else S)
        assert rel(p, r) < 1e-4, path


def _check_decode(smoke, S, seed):
    """8 decode steps from ``prefill_into_cache`` against the JAX decode
    from the JAX prefill's cache: logits each step, every cache leaf
    after the last (the cross K/V unchanged), relative 1e-4."""
    jcfg, cfg, jparams, params = smoke
    toks, frames = dense.tokens(cfg, S + STEPS, seed), _frames(cfg, seed)
    max_len = S + STEPS
    want_logits, want_cache = jax_prefill(
        jparams, jcfg, {"tokens": jnp.asarray(toks[:, :S]),
                        "frames": jnp.asarray(frames)}, S)
    jcache = dense.jax_decode_cache(jcfg, want_cache, max_len)
    logits, pcache = steps.prefill_into_cache(
        params, cfg, torch.from_numpy(toks[:, :S]), max_len,
        frames=torch.from_numpy(frames))
    assert rel(logits, want_logits) < 1e-4
    for path, p, r in dense.pairs(pcache, jcache):
        assert rel(p, r) < 1e-4, path
    cross = {k: v.clone() for k, v in pcache["decoder"]["cross"].items()}
    jstep = jax.jit(lambda p, t, c, n: jax_decode_step(p, jcfg, t, c, n))
    for i in range(STEPS):
        tok = toks[:, S + i:S + i + 1]
        want, jcache = jstep(jparams, jnp.asarray(tok), jcache,
                             jnp.int32(S + i))
        with torch.inference_mode():
            got, pcache = decode_step(params, cfg, torch.from_numpy(tok),
                                      pcache, S + i)
        assert rel(got, want) < 1e-4, i
    for path, p, r in dense.pairs(pcache, jcache):
        assert rel(p, r) < 1e-4, path
    for k in cross:
        assert torch.equal(pcache["decoder"]["cross"][k], cross[k])


@pytest.mark.parametrize("S", [12, 64])
def test_prefill_and_cache_match_jax(smoke, S):
    _check_prefill(smoke, S, seed=S)


def test_decode_from_prefill_into_cache_matches_jax(smoke):
    _check_decode(smoke, 40, seed=11)


def test_launcher_route_matches_jax_teacher_forced(smoke):
    """The port's serving route against ``repro/launch/serve.py``'s:
    ``encdec_prepare``, its cross K/V into a bfloat16 cache, the prompt
    one token at a time through ``decode_step``, then greedy decode."""
    jcfg, cfg, jparams, params = smoke
    prompt, gen = 20, 6
    toks, frames = dense.tokens(cfg, prompt, 12), _frames(cfg, 12)
    jcache = jax_init_cache(jcfg, B, prompt + gen)
    enc, cross = jax_encdec_prepare(jparams, jcfg, jnp.asarray(frames))
    jcache["decoder"]["cross"] = cross
    extras = {"enc": enc}
    jstep = jax.jit(lambda p, t, c, n: jax_decode_step(p, jcfg, t, c, n,
                                                       extras))
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
    out, logits = steps.generate(params, cfg, torch.from_numpy(toks), gen,
                                 frames=torch.from_numpy(frames))
    assert np.array_equal(out.numpy(), np.concatenate(
        [np.asarray(t) for t in want_toks], 1))
    assert rel(logits, jnp.concatenate(want_logits, 1)) < 2e-2


@pytest.fixture
def chunked_calls(monkeypatch):
    """Counts the port's chunked-branch calls by their (Sq, Sk, causal)."""
    seen = []
    inner = attn_mod._sdpa_chunked

    def spy(q, k, v, qpos, kpos, causal, *args):
        seen.append((q.shape[1], k.shape[1], causal))
        return inner(q, k, v, qpos, kpos, causal, *args)

    monkeypatch.setattr(attn_mod, "_sdpa_chunked", spy)
    return seen


def test_every_attention_takes_the_chunked_branch(long_smoke, chunked_calls):
    """encoder_seq 320 and a prompt of 260: the encoder's self-attention,
    the cross-attention and the decoder's self-attention each take the
    chunked branch (2 + 4 + 4 calls), held to the JAX package's prefill
    and decode."""
    _, cfg, _, _ = long_smoke
    _check_prefill(long_smoke, 260, seed=5)
    assert sorted(set(chunked_calls)) == [(260, 260, True),
                                          (260, 320, False),
                                          (320, 320, False)]
    assert len(chunked_calls) == cfg.n_encoder_layers + 2 * cfg.n_layers
    _check_decode(long_smoke, 260, seed=6)

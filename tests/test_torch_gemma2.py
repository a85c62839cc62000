"""The port's gemma2 (alternating local/global layers, attention and
final soft-caps, post-norms, the sqrt(d) embedding scale) against the
JAX package's, on the CPU, at smoke size (window 32), with the checks and
tolerances of ``_torch_dense.py``: at S = 300 the local layers' window
bites in prefill and the local decode cache (32 slots) has rolled.  The
rolling cache on its own: window 8, a 20-token prompt, 4 steps, as
``tests/test_models.py::test_rolling_window_cache_matches_full``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dense as dense
from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models.model import _embed as jax_embed
from repro.models.model import forward_train as jax_forward_train
from repro_torch.configs import get_config, get_smoke
from repro_torch.models.model import _embed, decode_step, init_cache
from repro_torch.serve import steps

ARCHS = ["gemma2_9b", "gemma2_27b"]


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    return dense.make_smoke(request.param)


@pytest.mark.parametrize("S", [64, 300])
def test_prefill_matches_jax(smoke, S):
    dense.check_prefill(smoke, S, seed=S)


def test_decode_from_rolled_cache_matches_jax(smoke):
    cfg = smoke[1]
    cache = dense.check_decode(smoke, 300, seed=11)
    assert cache["pairs"]["local"]["k"].shape[2] == cfg.sliding_window < 300
    assert cache["pairs"]["global"]["k"].shape[2] == 300 + dense.STEPS


def test_serve_route_matches_jax_teacher_forced(smoke):
    """A 40-token prompt and 6 new tokens: the local cache of 32 slots
    rolls in the JAX launcher's decode and in the port's prefill copy."""
    dense.check_serve(smoke)


def test_init_cache_local_length():
    cfg = get_smoke("gemma2_9b")
    for max_len, local in ((20, 20), (32, 32), (100, 32)):
        cache = init_cache(cfg, 1, max_len, device="cpu")
        assert cache["pairs"]["local"]["k"].shape[2] == local
        assert cache["pairs"]["global"]["v"].shape[2] == max_len


@pytest.fixture(scope="module")
def window8():
    return dense.make_smoke("gemma2_9b", sliding_window=8)


def test_rolling_window_cache_matches_full(window8):
    """Window 8, a 20-token prompt into a 24-slot decode cache (local: 8
    slots, rolled), then 4 decode steps: the rolled prefill copy equals
    the JAX decode's cache after the prompt fed one token at a time, and
    the 4 steps' logits equal the JAX full forward's at those positions,
    both at relative 1e-4."""
    jcfg, cfg, jparams, params = window8
    P, n = 20, 4
    toks = dense.tokens(cfg, P + n, seed=7, batch=1)
    want, _ = jax_forward_train(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    jstep = jax.jit(lambda p, t, c, i: jax_decode_step(p, jcfg, t, c, i))
    jcache = jax_init_cache(jcfg, 1, P + n, dtype=jnp.float32)
    for i in range(P):
        _, jcache = jstep(jparams, jnp.asarray(toks[:, i:i + 1]), jcache,
                          jnp.int32(i))
    logits, cache = steps.prefill_into_cache(
        params, cfg, torch.from_numpy(toks[:, :P]), P + n)
    assert cache["pairs"]["local"]["k"].shape[2] == 8
    for path, p, r in dense.pairs(cache, jcache):
        assert dense.rel(p, r) < 1e-4, path
    got = [logits[:, 0]]
    with torch.inference_mode():
        for i in range(P, P + n - 1):
            lg, cache = decode_step(params, cfg,
                                    torch.from_numpy(toks[:, i:i + 1]),
                                    cache, i)
            got.append(lg[:, 0])
    assert dense.rel(torch.stack(got, 1), want[:, P - 1:P + n - 1]) < 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_embed_scale_rounds_as_jax(arch):
    """At the full d_model in bfloat16 the sqrt(d) scale is rounded to the
    compute dtype before it multiplies (59.75 for 3584, not 59.866...):
    the port's embeddings equal the JAX package's bit for bit."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    rng = np.random.default_rng(3)
    table = rng.standard_normal((64, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, 64, (2, 5))
    want = jax_embed({"embed": jnp.asarray(table)}, jcfg, jnp.asarray(toks))
    got = _embed({"embed": torch.from_numpy(table)}, cfg,
                 torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert np.array_equal(got.float().numpy(), want)
    unrounded = (torch.from_numpy(table)[torch.from_numpy(toks)]
                 .to(torch.bfloat16) * cfg.d_model ** 0.5)
    assert not np.array_equal(unrounded.float().numpy(), want)

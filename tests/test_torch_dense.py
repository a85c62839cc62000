"""The port's dense family against the JAX package's, on the CPU, at
smoke size: granite (MQA, non-gated GELU MLP), starcoder2 (LayerNorm,
GELU, KV = 2) and pixtral's backbone (untied ``lm_head``, stubbed patch
embeddings).  The checks and tolerances are ``_torch_dense.py``'s;
LayerNorm and the tanh GELU are also held to their JAX functions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dense as dense
from _torch_parity import one_torch_thread  # noqa: F401
from repro.models.layers import layernorm as jax_layernorm
from repro_torch.models.layers import activation, layernorm

ARCHS = ["granite_34b", "starcoder2_3b", "pixtral_12b"]


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    return dense.make_smoke(request.param)


@pytest.mark.parametrize("S", [64, 300])
def test_prefill_matches_jax(smoke, S):
    dense.check_prefill(smoke, S, seed=S)


def test_decode_from_prefill_into_cache_matches_jax(smoke):
    dense.check_decode(smoke, 300, seed=11)


def test_serve_route_matches_jax_teacher_forced(smoke):
    dense.check_serve(smoke)


@pytest.fixture(scope="module")
def pixtral():
    return dense.make_smoke("pixtral_12b")


@pytest.mark.parametrize("S", [64, 300])
def test_pixtral_prefill_with_patch_embeds_matches_jax(pixtral, S):
    dense.check_prefill(pixtral, S, seed=S + 1, with_patches=True)


def test_pixtral_decode_after_patch_embeds_matches_jax(pixtral):
    """The patch embeddings reach the cache in prefill; decode reads them
    from there."""
    dense.check_decode(pixtral, 300, seed=13, with_patches=True)


def test_layernorm_and_tanh_gelu_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    got = layernorm(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), 1e-6)
    want = jax_layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-6)
    assert dense.rel(got, want) < 1e-6
    got = activation("gelu")(torch.from_numpy(x))
    want = jax.nn.gelu(jnp.asarray(x))
    assert dense.rel(got, want) < 1e-6
    # the exact (erf) form is another function at this tolerance
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    assert dense.rel(erf, want) > 1e-5

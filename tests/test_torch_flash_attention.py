"""The port's flash attention against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages: the port's
``attention_ref`` (the plain route of ``attention_op`` for a CPU tensor)
and its ``_sdpa_chunked`` (the model's chunked branch on the CPU) against
JAX ``attention_ref`` and the Pallas ``flash_attention`` in interpret
mode, over ``tests/test_kernels.py``'s sweep (every causal, window and
soft-cap case, GQA, a ragged 130) plus Zamba2-7B's head dim 112.
Tolerances are the JAX kernel test's: 2e-5 in float32, 2e-2 in bfloat16.
The CUDA kernels themselves (the tensor-core one for bfloat16, the
CUDA-core one for float32) are held to these plain versions on the card
(``tests/test_torch_model_cuda.py``); here their launch plans and the
wrappers' refusals are checked.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import attention_op
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.attention import _sdpa_chunked

# (B, Sq, Sk, H, KV, D): tests/test_kernels.py's sweep, then D = 112
SHAPES = [(1, 64, 64, 2, 2, 64), (2, 128, 128, 4, 2, 64),
          (1, 130, 130, 4, 1, 128), (2, 96, 96, 8, 4, 256),
          (1, 150, 150, 4, 2, 112)]
MASKS = [(True, 0, 0.0), (True, 32, 0.0), (True, 0, 50.0), (False, 0, 0.0)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, Sq, Sk, H, KV, D, jdt, tdt):
    rng = np.random.default_rng(B * Sq + 3 * H + KV + D)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D))]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window,cap", MASKS)
def test_flash_attention_matches_jax(shape, dtype, causal, window, cap):
    B, Sq, Sk, H, KV, D = shape
    jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (q, k, v) = _inputs(*shape, jdt, tdt)
    kw = dict(causal=causal, window=window, softcap=cap)
    want_ref = _np(jax_ref(jq, jk, jv, **kw))
    want_fa = _np(flash_attention(jq, jk, jv, interpret=True, **kw))

    got = attention_ref(q, k, v, **kw)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(_np(got), want_ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(attention_op(q, k, v, **kw)), want_fa,
                               atol=tol, rtol=tol)

    # the model's chunked branch: (B,Sq,KV,G,D) float32 out, chunk 64 so
    # the recurrence runs over several key chunks and a ragged last one
    pos = torch.arange(Sq)
    chunked = _sdpa_chunked(q.reshape(B, Sq, KV, H // KV, D), k, v, pos,
                            torch.arange(Sk), causal, window, cap, None, 64)
    chunked = chunked.reshape(B, Sq, H, D).to(tdt)
    np.testing.assert_allclose(_np(chunked), want_fa, atol=tol, rtol=tol)


@pytest.mark.parametrize("D", [16, 64, 112, 128, 256])
def test_flash_launch_plan_takes_every_head_dim(D):
    """Every head dim the tests and chip_smoke.py run (the smoke configs'
    16, the kernel tests' 64/128/256, Zamba2's 112) gets a tile that fits,
    two blocks per SM up to D = 256; each forced tile the card's test
    runs fits too."""
    plan = fa_kernel.flash_plan(D)
    assert plan.smem_bytes == fa_kernel.flash_smem_bytes(D, plan.bq, plan.bk)
    assert plan.smem_bytes <= fa_kernel.SMEM_TWO_PER_SM
    for bq, bk in fa_kernel.TILES:
        if fa_kernel.flash_smem_bytes(D, bq, bk) <= fa_kernel.SMEM_LIMIT:
            assert fa_kernel.flash_plan(D, bq=bq, bk=bk).bq == bq
    with pytest.raises(ValueError, match="shared memory"):
        fa_kernel.flash_plan(D, bq=512, bk=512)


def test_flash_kernel_wrapper_refuses_cpu_tensors():
    (_, (q, k, v)) = _inputs(1, 8, 8, 2, 1, 16, jnp.float32, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_cuda(q, k, v)


@pytest.mark.parametrize("D", [16, 64, 112, 128, 256])
def test_wgmma_plan_takes_every_head_dim(D):
    """Every head dim the tests and configs use gets the tensor-core
    plan: 128 query rows, keys per tile 128 up to D = 128 and 64 above,
    two stages, in the 227 KB a block may use.  That its bytes are the
    kernel's own layout, the launcher checks at every launch on the card
    (``tests/test_torch_model_cuda.py`` launches every D)."""
    plan = fa_kernel.wgmma_plan(D)
    assert plan[:3] == (128, 128 if D <= 128 else 64, 2)
    assert 0 < plan.smem_bytes <= fa_kernel.SMEM_LIMIT


@pytest.mark.parametrize("D", [8, 32, 96, 100, 192, 512])
def test_wgmma_plan_refuses_other_head_dims(D):
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.wgmma_plan(D)


def test_wgmma_wrapper_refuses_cpu_float32_and_other_head_dims():
    """Checked before any launch: the dtype (TypeError), the head dim and
    the device (ValueError)."""
    (_, (q, k, v)) = _inputs(1, 8, 8, 2, 1, 16, jnp.float32, torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        fa_kernel.flash_attention_wgmma(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_wgmma(*(t.bfloat16() for t in (q, k, v)))
    (_, wide) = _inputs(1, 8, 8, 2, 1, 96, jnp.float32, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.flash_attention_wgmma(*wide)
    assert fa_kernel.flash_attention_wgmma.launches == 0

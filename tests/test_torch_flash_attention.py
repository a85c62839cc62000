"""The port's flash attention against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages: the port's
``attention_ref`` (the plain route of ``attention_op`` for a CPU tensor)
and its ``_sdpa_chunked`` (the model's chunked branch on the CPU) against
JAX ``attention_ref`` and the Pallas ``flash_attention`` in interpret
mode, over ``tests/test_kernels.py``'s sweep (every causal, window and
soft-cap case, GQA, a ragged 130) plus Zamba2-7B's head dim 112.
Tolerances are the JAX kernel test's: 2e-5 in float32, 2e-2 in bfloat16.
The CUDA kernels themselves (both on the tensor cores: wgmma for
bfloat16, TF32 mma.sync in three passes for float32) are held to these
plain versions on the card (``tests/test_torch_model_cuda.py``); here
their launch plans, the wrappers' refusals and the precision arguments of
the float32 kernel's three TF32 passes and of its P V partials (the
tensor cores round each sum toward zero) are checked.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import mm_one_pass, mm_three_pass, tf32
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


@pytest.mark.parametrize("D", fa_kernel.WGMMA_HEAD_DIMS)
def test_flash_launch_plan_takes_every_head_dim(D):
    """Every head dim the tests and chip_smoke.py run (the smoke configs'
    16, the kernel tests' 64/128/256, Zamba2's 112) gets a float32 plan
    for the grid it launches: up to D = 128, 8 warps of 32 query rows
    (two 16-row tiles) where there are at least 1.5x the card's SMs of
    those 256-row blocks (Zamba2-7B's prefill, B 4 x 32 heads x 8
    blocks) and 8 warps of 16 rows below that (the float32 consistency
    prefill, 32 heads x 2 blocks, or a card of more SMs); 4 warps of 16
    at D = 256 either way.  Keys per tile a multiple of the 8 keys one
    product step takes, and the source's layout (Q and the K/V ring, rows
    of D + 4 floats) in the 227 KB a block may use.  That its bytes are
    the kernel's own, the launcher checks at every launch on the card
    (``tests/test_torch_model_cuda.py``)."""
    full = fa_kernel.mma_plan(D, 4 * 32, 2048)
    short = fa_kernel.mma_plan(D, 32, 320)
    assert fa_kernel.mma_plan(D, 4 * 32, 2048, sms=1025) == short
    # 99 heads x 2 blocks are 1.5x the 132 SMs, 98 x 2 are not
    assert fa_kernel.mma_plan(D, 99, 320) == full
    assert fa_kernel.mma_plan(D, 98, 320) == short
    assert (full.warps, full.tiles) == ((8, 2) if D <= 128 else (4, 1))
    assert (short.warps, short.tiles) == ((8, 1) if D <= 128 else (4, 1))
    for plan in (full, short):
        assert plan.bq == 16 * plan.tiles * plan.warps
        assert plan.bk % 8 == 0 and plan.stages >= 2
        assert plan.smem_bytes == 4 * (D + 4) * (plan.bq + 2 * plan.stages
                                                 * plan.bk)
        assert plan.smem_bytes <= fa_kernel.SMEM_LIMIT


@pytest.mark.parametrize("D", [8, 32, 96, 100, 192, 512])
def test_flash_kernel_wrapper_refuses_other_head_dims(D):
    """The float32 wrapper refuses a head dim its source is not built for
    before any launch, as the bfloat16 one does."""
    (_, (q, k, v)) = _inputs(1, 8, 8, 2, 1, D, jnp.float32, torch.float32)
    before = fa_kernel.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.mma_plan(D, 2, 8)
    assert fa_kernel.flash_attention_cuda.launches == before


def _attention_emulated(q, k, v, mm):
    """One causal head, q/k/v (S, D) float32, with both products taken by
    ``mm`` and the rest as the float32 kernel does it: p = exp(s - row
    max), out = (p v) / rowsum p."""
    s = mm(q, k.T) * (1.0 / q.shape[1] ** 0.5)
    causal = torch.ones(len(q), len(k), dtype=torch.bool).tril()
    s = s.masked_fill(~causal, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return mm(p, v) / p.sum(-1, keepdim=True)


def test_tf32_three_pass_split_keeps_float32_tolerance():
    """The precision argument of the float32 kernel's tensor-core
    products, on one causal Zamba2-7B head (D 112, S 1024, N(0, 1) q, k,
    v): both products taken as three TF32 passes stay within the float32
    tolerance (2e-5) of a float64 oracle, well inside it (< 0.2 of it);
    one TF32 pass does not stay within it.  The errors are printed
    (pytest -s)."""
    rng = np.random.default_rng(20)
    q, k, v = (torch.from_numpy(rng.standard_normal((1024, 112)).astype(
        np.float32)) for _ in range(3))
    want = _attention_emulated(q.double(), k.double(), v.double(),
                               torch.matmul)
    err = {name: float((_attention_emulated(q, k, v, mm).double() - want)
                       .abs().max())
           for name, mm in (("float32", torch.matmul),
                            ("three_pass", mm_three_pass),
                            ("one_pass", mm_one_pass))}
    print(f"TF32 max abs error against float64 (tolerance 2e-5): "
          f"float32={err['float32']:.3g} three_pass={err['three_pass']:.3g} "
          f"one_pass={err['one_pass']:.3g}")
    assert err["three_pass"] < 0.2 * 2e-5
    assert err["one_pass"] > 2e-5


def _round_to_zero(a: torch.Tensor) -> torch.Tensor:
    """float64 -> the float32 next toward zero, as the tensor cores round
    each sum they write."""
    f = a.float()
    over = f.double().abs() > a.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)),
                       f).double()


def _pv_tensor_cores(p, v, partial):
    """P V as the float32 kernel's mma.sync takes it: 8 keys a step, three
    TF32 passes a step, each sum rounded toward zero; ``partial``: each
    step's passes into a zeroed partial added to O in round to nearest
    (the kernel), else straight into O (its form before)."""
    ph, vh = tf32(p), tf32(v)
    pl, vl = tf32(p - ph).double(), tf32(v - vh).double()
    ph, vh = ph.double(), vh.double()
    acc = torch.zeros(p.shape[0], v.shape[1], dtype=torch.float64)
    for k0 in range(0, p.shape[1], 8):
        s = slice(k0, k0 + 8)
        part = torch.zeros_like(acc) if partial else acc
        for a, b in ((pl, vh), (ph, vl), (ph, vh)):
            part = _round_to_zero(part + a[:, s] @ b[s])
        acc = (acc + part).float().double() if partial else part
    return acc


def test_tf32_accumulation_per_key_step_keeps_float32_tolerance():
    """The float32 kernel's P V over a long row whose V is coherent along
    the keys (mean 2, as a Whisper encoder layer's values run): the
    tensor cores round each sum toward zero, so taken straight into O
    the bias grows with the row (563 truncations over 1500 keys); each 8
    keys' passes into a zeroed partial keep it under a tenth of the
    float32 tolerance (2e-5 abs + 2e-5 rel), at least ten times below
    the straight form.  The errors are printed (pytest -s)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1500, 64)).astype(np.float32))
    v = torch.from_numpy((2.0 + 0.5 * rng.standard_normal((1500, 64)))
                         .astype(np.float32))
    s = (q @ k.T) / 8.0
    p = torch.exp(s - s.amax(-1, keepdim=True))
    rowsum = p.double().sum(-1, keepdim=True)
    want = (p.double() @ v.double()) / rowsum
    tol = 2e-5 + 2e-5 * want.abs()
    err = {name: float(((_pv_tensor_cores(p, v, partial) / rowsum - want)
                        .abs() / tol).max())
           for name, partial in (("partial", True), ("straight", False))}
    print(f"P V error over the float32 tolerance: per-step partial "
          f"{err['partial']:.3g}, straight into O {err['straight']:.3g}")
    assert err["partial"] < 0.1
    assert err["straight"] > 10 * err["partial"]


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

"""The flash-attention backward: the wrappers' refusals and launch plans,
``attention_op``'s and ``FlashAttention``'s routes, and the
``refuse_grad`` guards of the forward and SSD kernels on the CPU; on the
card (marker ``cuda``) both backward kernels, both on the tensor cores
(float32 as TF32 ``mma.sync`` in three passes, ``flash_attention_bwd_cuda``;
bfloat16 on wgmma, ``flash_attention_bwd_wgmma``) against the plain version's autograd
gradients in every mask case and head dim, two launches bitwise equal,
the model's chunked branch through ``FlashAttention`` and
``ssd_chunked``'s refusal.  No JAX here, so the card's cases run on a
machine that has the card but no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_bwd.py

Tolerances, on the relative norm of each gradient's whole error against
the plain version's float32 autograd gradient (``ref.py::attention_ref``
on the inputs upcast to float32, dO too): float32 1e-5 (the kernel sums
TF32 x 3 in another order, and its O is the TF32 x 3 forward's;
``test_tf32_accumulation_per_tile_keeps_dv_within_float32_tolerance``
emulates its longest sums);
bfloat16 5e-3 (the inputs are bfloat16 on both sides; the kernel takes
delta from dP in float32, rounds P and dS to bfloat16 as the products'
operands and its gradients to bfloat16)."""
import numpy as np
import pytest
import torch

from _torch_parity import round_to_zero, tf32
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ops import attention_op
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd import kernel as ssd
from repro_torch.models.attention import _sdpa_chunked

REL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
# (causal, window, softcap, (B, Sq, Sk, H, KV)): causal, window, soft-cap,
# GQA 24/2, non-causal Sq != Sk (Whisper's cross shape, cut), ragged S
CASES = [(True, 0, 0.0, (2, 128, 128, 4, 2)),
         (True, 48, 0.0, (1, 200, 200, 4, 2)),
         (True, 0, 50.0, (1, 130, 130, 4, 4)),
         (True, 0, 0.0, (1, 160, 160, 24, 2)),
         (False, 0, 0.0, (2, 56, 150, 4, 4)),
         (True, 0, 0.0, (1, 77, 77, 2, 1))]
HEAD_DIMS = list(fa.WGMMA_HEAD_DIMS)
# the card's cases add GQA 24/2 over 1024 keys: the bfloat16 kernel's
# dkdv launch splits each group's 12 heads over 12 blocks of 8 key tiles
CARD_CASES = CASES + [(True, 0, 0.0, (1, 1024, 1024, 24, 2))]
DTYPES = [torch.float32, torch.bfloat16]


def inputs(B, Sq, Sk, H, KV, D, dtype, device, seed=0):
    rng = np.random.default_rng(seed + Sq * H + D)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32
                            ).to(device=device, dtype=dtype)
    return (t(B, Sq, H, D), t(B, Sk, KV, D), t(B, Sk, KV, D),
            t(B, Sq, H, D))


def plain_grads(q, k, v, do, causal, window, cap):
    """The plain version's gradients in float32 by autograd."""
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    o = attention_ref(qf, kf, vf, causal=causal, window=window,
                      softcap=cap)
    return torch.autograd.grad(o, (qf, kf, vf), do.float())


def rel_norm(got, want):
    return float((got.float() - want).norm() / want.norm())


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "kind,D", [pytest.param("cuda", D, id=str(D)) for D in HEAD_DIMS]
    + [pytest.param("wgmma", D, id=f"wgmma-{D}") for D in HEAD_DIMS])
def test_bwd_plan_fits_a_block(kind, D):
    """Each backward's plan fits one block's 227 KB and equals its
    source's layout: ``flash_attention_bwd_mma.cu``'s ``Rows<D>`` (prep:
    Q and the K ring; dq: Q, dO and the K and V ring) and ``Cols<D>``
    (K, V, the Q and dO ring and the ring's lse and delta), every row
    D + 4 floats; ``flash_attention_bwd_wgmma.cu``'s ``QLayout<D>`` and
    ``KLayout<D>`` (1024 alignment bytes, 128-byte rows of 64-column
    chunks, the mbarriers, and the dkdv ring's lse and delta).  The
    accumulators a thread holds through a walk stay within 128 floats:
    the float32 kernel's dQ of 16 rows, or dK and dV of 16 keys over a
    warp's share of D; the bfloat16 kernel's dK and dV of 64 keys."""
    if kind == "cuda":
        plan = fa.bwd_plan(D)
        small = D <= 128
        assert (plan.bq, plan.bk, plan.bkv, plan.bqd, plan.stages,
                plan.d_split) == ((128, 32, 128, 32, 2, 1) if small
                                  else (64, 16, 64, 16, 2, 2))
        row = 4 * (D + 4)
        assert plan.smem_prep == row * (plan.bq + 2 * plan.bk)
        assert plan.smem_dq == row * 2 * (plan.bq + 2 * plan.bk)
        assert plan.smem_kv == (row * 2 * (plan.bkv + 2 * plan.bqd)
                                + 4 * 2 * 2 * plan.bqd)
        assert max(plan.smem_prep, plan.smem_dq,
                   plan.smem_kv) <= fa.SMEM_LIMIT
        # 16 rows x D of dQ; 16 keys x D / d_split of dK and of dV, over
        # a warp's 32 threads
        assert 16 * D // 32 <= 128
        assert 2 * 16 * (D // plan.d_split) // 32 <= 128
        return
    plan = fa.bwd_wgmma_plan(D)
    tile = 64 if D <= 128 else 32
    assert (plan.bq, plan.bk, plan.bkv, plan.bqd, plan.stages,
            plan.d_split) == (128, tile, 128, tile, 2, 1 + (D > 128))
    rows = 128 * ((D + 63) // 64)          # bytes of one row of chunks
    bars = 8 * (1 + 2 * 2)
    assert plan.smem_q == 1024 + 2 * 128 * rows + 2 * 2 * tile * rows + bars
    assert plan.smem_k == (1024 + 2 * 128 * rows
                           + 2 * (2 * tile * rows + 2 * tile * 4) + bars)
    assert max(plan.smem_q, plan.smem_k) <= fa.SMEM_LIMIT
    # dK and dV of 64 keys: at most 128 floats a thread
    assert 2 * (D // plan.d_split) // 2 <= 128


def test_bwd_wgmma_split_fills_the_card():
    """The dkdv launch splits a group's heads over the fewest blocks (a
    divisor of G) that give 1.5 blocks an SM: StarCoder2-3B's training
    shape (B 2, KV 2, 16 key tiles, G 12) takes 4 (256 blocks); no GQA,
    or a grid that fills the card already, takes 1; a small grid all of
    G."""
    assert fa.bwd_wgmma_split(2, 2, 12, 2048, 128) == 4
    assert fa.bwd_wgmma_split(4, 32, 1, 2048, 112) == 1
    assert fa.bwd_wgmma_split(2, 8, 2, 6144, 256) == 1
    assert fa.bwd_wgmma_split(1, 2, 12, 1024, 64) == 12
    assert fa.bwd_wgmma_split(2, 2, 2, 128, 64) == 2
    assert fa.bwd_wgmma_split(2, 2, 12, 2048, 128, sms=16) == 1
    # the launches' blocks at that shape: prep 16 x 48, dkdv 16 x 4 x 4,
    # dq prep's and 171 that sum 2 x 2 x 2048 x 2 x 128 / 4 groups
    assert fa.bwd_wgmma_grids(2, 2048, 2048, 24, 2, 128) == (4, 768, 256,
                                                             939)
    assert fa.bwd_wgmma_grids(2, 6144, 6144, 16, 8, 256) == (1, 1536, 1536,
                                                             1536)


def test_bwd_split_fills_the_card():
    """The float32 dkdv launch splits a group's heads by the bfloat16
    kernel's rule over its own key blocks (128 keys up to D = 128, 64 at
    D = 256): StarCoder2-3B's training shape (B 2, KV 2, 16 key blocks,
    G 12) takes 4 (256 blocks); no GQA, or a grid that fills the card
    already (Zamba2-7B, Gemma2-9B's local layer), takes 1; a small grid
    all of G."""
    assert fa.bwd_split(2, 2, 12, 2048, 128) == 4
    assert fa.bwd_split(4, 32, 1, 2048, 112) == 1
    assert fa.bwd_split(2, 8, 2, 6144, 256) == 1
    assert fa.bwd_split(1, 2, 12, 1024, 64) == 12
    assert fa.bwd_split(2, 2, 12, 2048, 128, sms=16) == 1
    # the launches' blocks there: prep 16 x 48 (128 rows), dkdv 16 x 4 x
    # 4, dq prep's and 256 that sum 2 x 2 x 2048 x 2 x 128 / 4 groups of
    # four, 8 a thread of 256
    assert fa.bwd_grids(2, 2048, 2048, 24, 2, 128) == (4, 768, 256, 1024)
    # Gemma2-9B local, D 256: 64-row and 64-key blocks, no split
    assert fa.bwd_grids(2, 6144, 6144, 16, 8, 256) == (1, 3072, 1536, 3072)
    assert fa.bwd_grids(8, 224, 1500, 20, 20, 64) == (1, 320, 1920, 320)


def _dv_tensor_cores(pt, do, rows):
    """dV = P^T dO as the float32 backward's mma.sync takes it: 8 query
    rows a step, three TF32 passes a step, each sum rounded toward zero;
    ``rows``: each tile of that many rows into a zeroed partial (8: each
    step's, the forward's form), the partials added to dV in round to
    nearest in row order; None: every step straight into dV."""
    ph, dh = tf32(pt), tf32(do)
    pl, dl = tf32(pt - ph).double(), tf32(do - dh).double()
    ph, dh = ph.double(), dh.double()
    passes = ((pl, dh), (ph, dl), (ph, dh))
    acc = torch.zeros(pt.shape[0], do.shape[1], dtype=torch.float64)
    if rows is None:
        for r0 in range(0, pt.shape[1], 8):
            s = slice(r0, r0 + 8)
            for a, b in passes:
                acc = round_to_zero(acc + a[:, s] @ b[s])
        return acc
    # every tile's partial at once: (tiles, keys, rows) @ (tiles, rows, D)
    n = pt.shape[1] // rows
    tiles = [(a.reshape(a.shape[0], n, rows).transpose(0, 1),
              b.reshape(n, rows, b.shape[1])) for a, b in passes]
    part = torch.zeros(n, pt.shape[0], do.shape[1], dtype=torch.float64)
    for r0 in range(0, rows, 8):
        s = slice(r0, r0 + 8)
        for a, b in tiles:
            part = round_to_zero(part + a[:, :, s] @ b[:, s])
    for t in range(n):
        acc = (acc + part[t]).float().double()
    return acc


def test_tf32_accumulation_per_tile_keeps_dv_within_float32_tolerance():
    """The float32 backward's longest sum: dV of one warp's 16 keys over
    a KV head's G 12 x 2048 query rows (StarCoder2-3B's training shape),
    P^T >= 0 and dO coherent along the rows (mean 2).  The tensor cores
    round each sum toward zero, so taken straight into dV (9,216
    truncations) the result drifts low; each 32-row tile's passes into a
    zeroed partial (the kernel's dkdv tile; dQ's 32-key tiles alike) keep
    the relative norm error under a tenth of the float32 tolerance
    (1e-5), as low as per 8-row partials, and the straight form is at
    least ten times worse.  The errors are printed (pytest -s)."""
    rng = np.random.default_rng(5)
    rows = 12 * 2048
    pt = torch.from_numpy(np.exp(rng.standard_normal((16, rows)) - 3.0)
                          .astype(np.float32))
    do = torch.from_numpy((2.0 + 0.5 * rng.standard_normal((rows, 64)))
                          .astype(np.float32))
    want = pt.double() @ do.double()
    err = {name: float((_dv_tensor_cores(pt, do, n) - want).norm()
                       / want.norm())
           for name, n in (("tile", 32), ("step", 8), ("straight", None))}
    print(f"dV relative norm error: per 32-row tile {err['tile']:.3g}, per "
          f"8-row step {err['step']:.3g}, straight {err['straight']:.3g}")
    assert err["tile"] < 0.1 * 1e-5
    assert err["tile"] < 2 * err["step"]
    assert err["straight"] > 10 * err["tile"]


def test_bwd_refuses_what_the_kernel_does_not_take():
    q, k, v, do = inputs(1, 8, 8, 2, 1, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, k, v, q, do)
    with pytest.raises(ValueError, match="head dim"):
        fa.bwd_plan(32)
    with pytest.raises(TypeError, match="must all be float32"):
        fa.flash_attention_bwd_cuda(q, k, v, q.double(), do)
    with pytest.raises(TypeError, match="must all be float32"):
        fa.flash_attention_bwd_cuda(q.half(), k.half(), v.half(), q.half(),
                                    do.half())
    with pytest.raises(ValueError, match="multiple"):
        q3, k3, v3, do3 = inputs(1, 8, 8, 3, 2, 16, torch.float32, "cpu")
        fa.flash_attention_bwd_cuda(q3, k3, v3, q3, do3)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_bwd_cuda(q, k, v, q[:, :4], do)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_bwd_cuda(q, k, v, q, do, window=-1)
    # o is the float32 forward's output, never None; bfloat16 goes to the
    # tensor-core kernel
    with pytest.raises(TypeError, match="must all be float32"):
        fa.flash_attention_bwd_cuda(q, k, v, None, do)
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    with pytest.raises(TypeError, match="flash_attention_bwd_wgmma"):
        fa.flash_attention_bwd_cuda(qb, kb, vb, qb, dob)
    assert fa.flash_attention_bwd_cuda.launches == 0


def test_bwd_wgmma_refuses_what_the_kernel_does_not_take():
    """The bfloat16 wrapper refuses float32 (and any other dtype), CPU
    tensors, a bad shape, a head dim not built and a negative window,
    launching nothing."""
    q, k, v, do = inputs(1, 8, 8, 2, 1, 16, torch.bfloat16, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_wgmma(q, k, v, do)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention_bwd_wgmma(q.float(), k.float(), v.float(),
                                     do.float())
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention_bwd_wgmma(q, k, v, do.half())
    with pytest.raises(ValueError, match="head dim"):
        q32, k32, v32, do32 = inputs(1, 8, 8, 2, 1, 32, torch.bfloat16,
                                     "cpu")
        fa.flash_attention_bwd_wgmma(q32, k32, v32, do32)
    with pytest.raises(ValueError, match="head dim"):
        fa.bwd_wgmma_plan(48)
    with pytest.raises(ValueError, match="4-D"):
        fa.flash_attention_bwd_wgmma(q[0], k, v, do)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_bwd_wgmma(q, k, v, do[:, :4])
    with pytest.raises(ValueError, match="multiple"):
        q3, k3, v3, do3 = inputs(1, 8, 8, 3, 2, 16, torch.bfloat16, "cpu")
        fa.flash_attention_bwd_wgmma(q3, k3, v3, do3)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_bwd_wgmma(q, k, v, do, window=-1)
    assert fa.flash_attention_bwd_wgmma.launches == 0


def test_backward_kernel_routes_each_dtype():
    assert fa.backward_kernel(torch.bfloat16) is fa.flash_attention_bwd_wgmma
    assert fa.backward_kernel(torch.float32) is fa.flash_attention_bwd_cuda
    # any other dtype goes to the float32 kernel, which refuses it
    assert fa.backward_kernel(torch.float16) is fa.flash_attention_bwd_cuda


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_flash_attention_calls_the_backward_of_its_dtype(monkeypatch, dtype):
    """``FlashAttention`` with the kernels replaced by CPU stand-ins: the
    bfloat16 backward gets (q, k, v, do) and the mask, the float32 one
    (q, k, v, o, do) with the forward's o; the gradients are the
    stand-in's."""
    calls = []

    def forward(q, k, v, **kw):
        return attention_ref(q, k, v, **kw)

    def backward(*args, **kw):
        calls.append((len(args), kw))
        return tuple(torch.full_like(t, i + 1.0)
                     for i, t in enumerate(args[:3]))

    monkeypatch.setattr(fa, "flash_attention_wgmma", forward)
    monkeypatch.setattr(fa, "flash_attention_cuda", forward)
    monkeypatch.setattr(fa, "flash_attention_bwd_wgmma", backward)
    monkeypatch.setattr(fa, "flash_attention_bwd_cuda", backward)
    q, k, v, do = inputs(1, 8, 8, 2, 1, 16, dtype, "cpu")
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = fa.FlashAttention.apply(*leaves, True, 4, 30.0)
    got = torch.autograd.grad(o, leaves, do)
    n_args = 4 if dtype == torch.bfloat16 else 5
    assert calls == [(n_args, {"causal": True, "window": 4,
                               "softcap": 30.0})]
    for i, g in enumerate(got):
        assert torch.equal(g, torch.full_like(g, i + 1.0))


def test_forward_kernels_refuse_inputs_that_need_a_gradient():
    """A direct forward-kernel call under grad mode with an input that
    requires a gradient raises before any device check: its output would
    have no autograd graph."""
    q, k, v, _ = inputs(1, 8, 8, 2, 1, 16, torch.float32, "cpu")
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="attention_op"):
        fa.refuse_grad("flash_attention_cuda", q, k, v)
    with torch.no_grad():
        fa.refuse_grad("flash_attention_cuda", q, k, v)
    fa.refuse_grad("flash_attention_cuda", q.detach(), k, v)


def test_ssd_refuses_inputs_that_need_a_gradient():
    x = torch.zeros(1, 4, 2, 3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="next slice"):
        ssd.refuse_grad(x, torch.zeros(3))
    with torch.inference_mode():
        ssd.refuse_grad(x)
    ssd.refuse_grad(x.detach())


@pytest.mark.parametrize("causal,window,cap,dims", CASES)
def test_cpu_route_differentiates_the_plain_version(causal, window, cap,
                                                    dims):
    """On the CPU ``attention_op`` is the plain oracle and the model's
    chunked branch ``_sdpa_chunked``; autograd differentiates both and
    they give the same gradients (float32, 1e-5 relative norm)."""
    B, Sq, Sk, H, KV = dims
    D = 16
    q, k, v, do = inputs(B, Sq, Sk, H, KV, D, torch.float32, "cpu")
    want = plain_grads(q, k, v, do, causal, window, cap)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = attention_op(*leaves, causal=causal, window=window, softcap=cap)
    got = torch.autograd.grad(o, leaves, do)
    leaves2 = [x.clone().requires_grad_() for x in (q, k, v)]
    o2 = _sdpa_chunked(leaves2[0].reshape(B, Sq, KV, H // KV, D),
                       leaves2[1], leaves2[2], torch.arange(Sq),
                       torch.arange(Sk), causal, window, cap, None, 64)
    got2 = torch.autograd.grad(o2.reshape(B, Sq, H, D), leaves2, do)
    for g, g2, w in zip(got, got2, want):
        assert rel_norm(g, w) < 1e-5
        assert rel_norm(g2, w) < 1e-5


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _launch_bwd(q, k, v, do, causal, window, cap):
    """One launch of the backward kernel of q's dtype; the float32 one
    reads the float32 forward kernel's o, as ``FlashAttention`` saves
    it."""
    kernel = fa.backward_kernel(q.dtype)
    if q.dtype == torch.bfloat16:
        return kernel(q, k, v, do, causal=causal, window=window,
                      softcap=cap)
    o = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=cap)
    return kernel(q, k, v, o, do, causal=causal, window=window, softcap=cap)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("causal,window,cap,dims", CARD_CASES)
def test_bwd_kernel_matches_plain_autograd(card, causal, window, cap, dims,
                                           D, dtype):
    B, Sq, Sk, H, KV = dims
    q, k, v, do = inputs(B, Sq, Sk, H, KV, D, dtype, "cuda")
    kernel = fa.backward_kernel(dtype)
    n = kernel.launches
    got = _launch_bwd(q, k, v, do, causal, window, cap)
    torch.cuda.synchronize()
    assert kernel.launches == n + 1
    want = plain_grads(q, k, v, do, causal, window, cap)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.isfinite(g).all()
        assert rel_norm(g, w) <= REL[dtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,window,cap,dims",
                         [CASES[3], CASES[4], CARD_CASES[-1]])
def test_bwd_kernel_is_deterministic(card, causal, window, cap, dims,
                                     dtype):
    """Two launches on the same inputs give the same bits: every sum in
    a fixed order, no atomics (GQA 24/2 at 160 and 1024 keys, where the
    bfloat16 kernel sums split partials; the non-causal Sq != Sk case)."""
    B, Sq, Sk, H, KV = dims
    q, k, v, do = inputs(B, Sq, Sk, H, KV, 128, dtype, "cuda")
    first = _launch_bwd(q, k, v, do, causal, window, cap)
    second = _launch_bwd(q, k, v, do, causal, window, cap)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_attention_op_routes_a_gradient_through_the_kernels(card, dtype):
    """Grad mode on and inputs that require a gradient: one forward and
    one backward launch through ``FlashAttention``, each the kernel of
    the dtype; under inference mode the forward kernel alone, as the
    serve steps run it."""
    q, k, v, do = inputs(2, 300, 300, 4, 2, 64, dtype, "cuda")
    fwd, bwd = fa.forward_kernel(dtype), fa.backward_kernel(dtype)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    n_f, n_b = fwd.launches, bwd.launches
    o = attention_op(*leaves, causal=True)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert (fwd.launches - n_f, bwd.launches - n_b) == (1, 1)
    for g, w in zip(got, plain_grads(q, k, v, do, True, 0, 0.0)):
        assert rel_norm(g, w) <= REL[dtype]
    with torch.inference_mode():
        o2 = attention_op(q, k, v, causal=True)
    assert bwd.launches - n_b == 1
    assert torch.equal(o2, o.detach())


@pytest.mark.cuda
def test_chunked_branch_under_checkpoint_matches_cpu(card):
    """The model's attention on the card in float32 under
    ``torch.utils.checkpoint``: the forward runs twice (the recompute),
    the backward once, and the gradients of the projections equal the
    CPU's autograd through ``_sdpa_chunked`` (1e-5 relative norm)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import init_params, tree_map
    cfg = get_smoke("starcoder2_3b").scaled(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = init_params(gen, attn.attn_specs(cfg), dtype=torch.float32)
    x = torch.randn(2, 300, cfg.d_model, generator=gen)
    w = torch.randn(2, 300, cfg.d_model, generator=gen)
    pos = torch.arange(300)

    def run(device):
        p = tree_map(lambda a: a.to(device).requires_grad_(), params,
                     lambda a: isinstance(a, torch.Tensor))
        xx = x.to(device)
        out = torch.utils.checkpoint.checkpoint(
            lambda h: attn.attention(p, cfg, h, pos.to(device))[0], xx,
            use_reentrant=False)
        leaves = [p[n] for n in sorted(p)]
        return torch.autograd.grad((out * w.to(device)).sum(), leaves)

    n_f = fa.flash_attention_cuda.launches
    n_b = fa.flash_attention_bwd_cuda.launches
    got = run("cuda")
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches - n_f == 2
    assert fa.flash_attention_bwd_cuda.launches - n_b == 1
    for g, w in zip(got, run("cpu")):
        assert rel_norm(g.cpu(), w) < 1e-5


@pytest.mark.cuda
def test_ssd_chunked_refuses_a_gradient_on_the_card(card):
    from repro_torch.models.mamba2 import ssd_chunked
    b, L, H, P, G, N = 1, 64, 2, 16, 1, 16
    x = torch.randn(b, L, H, P, device="cuda", requires_grad=True)
    dt = torch.rand(b, L, H, device="cuda")
    A = -torch.rand(H, device="cuda")
    B = torch.randn(b, L, G, N, device="cuda")
    C = torch.randn(b, L, G, N, device="cuda")
    n = ssd.ssd_cuda.launches
    with pytest.raises(NotImplementedError, match="next slice"):
        ssd_chunked(x, dt, A, B, C, 16)
    assert ssd.ssd_cuda.launches == n
    with torch.no_grad():
        y, _ = ssd_chunked(x, dt, A, B, C, 16)
    assert ssd.ssd_cuda.launches == n + 1 and y.shape == (b, L, H, P)


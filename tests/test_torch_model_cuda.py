"""The port's SSD and flash-attention CUDA kernels on the card, against
their plain versions in every launch plan (Whisper's non-causal encoder
and cross-attention shapes too), and the Zamba2, Mamba2, gemma2,
StarCoder2, OLMoE, DeepSeek-V3 and Whisper smoke serves on the card
against the CPU.

Needs a CUDA device (marker ``cuda``) and nothing of JAX, so it also runs
on a machine that has the card but no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_model_cuda.py

Tolerances: the SSD kernel takes its products on the tensor cores in
TF32, each float32 operand split in two TF32 parts and multiplied in
three passes (bfloat16 inputs are exact in TF32 and skip the passes over
their zero lo parts), which keeps about float32's accuracy, and sums in
another order: 1e-3, the JAX kernel test's float32 bound
(``tests/test_torch_ssd.py`` shows on the CPU that the split stays
inside it where one TF32 pass would not).  Flash attention has two
kernels, both on the tensor cores.  The float32 one takes both products
as TF32 in the same three passes and sums in another order: 2e-5 (the
JAX kernel test's float32 bound; ``tests/test_torch_flash_attention.py``
shows the split inside it on the CPU where one pass would not), at
every head dim's plan, also held at Zamba2-7B's prompt length, 2048.
The bfloat16 one rounds P to bfloat16 before P V, as the tensor cores
take it, and sums in another order: 2e-2 (the JAX kernel
test's bfloat16 bound) against the float32 plain version, at every test
shape and head dim and at Zamba2-7B's prompt length and head dim, and
5e-3 on the relative norm of the whole error (``WGMMA_REL_NORM``).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels.build import launch
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ops import attention_op
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd import kernel as ssd
from repro_torch.kernels.ssd.ops import ssd_op
from repro_torch.launch import serve as serve_launch
from repro_torch.models import mla
from repro_torch.models.layers import tree_map
from repro_torch.models.mamba2 import ssd_chunked_plain
from repro_torch.models.model import init_model
from repro_torch.serve import steps

pytestmark = pytest.mark.cuda

# (b, L, H, P, G, N, chunk): tests/test_kernels.py's four SSD shapes,
# Zamba2-7B's per-head shape at a short ragged L, its prefill shape, and
# one ragged chunk (G > 1); the plans take clusters of 1, 2, 4 and 8
SSD_SHAPES = [(1, 32, 2, 16, 1, 16, 16), (2, 64, 4, 32, 2, 32, 32),
              (1, 100, 4, 64, 1, 64, 64), (2, 256, 8, 64, 4, 128, 128),
              (1, 300, 4, 64, 1, 64, 128), (4, 2048, 112, 64, 1, 64, 128),
              (2, 40, 4, 64, 2, 64, 128)]
# rows of several cluster segments: 65 kernel chunks of 64 (G > 1), and
# 40 chunks of 16 at a ragged L with P, N neither multiples of the tiles
# nor of 4 (the float32 inputs then go through registers, not cp.async,
# and the scan moves the state one element at a time)
SSD_SEGMENT_SHAPES = [(2, 4133, 8, 64, 2, 64, 128),
                      (1, 630, 4, 22, 1, 18, 16)]
# (B, Sq, Sk, H, KV, D): tests/test_kernels.py's sweep, then D = 112
FLASH_SHAPES = [(1, 64, 64, 2, 2, 64), (2, 128, 128, 4, 2, 64),
                (1, 130, 130, 4, 1, 128), (2, 96, 96, 8, 4, 256),
                (2, 200, 200, 4, 2, 112)]
FLASH_MASKS = [(True, 0, 0.0), (True, 32, 0.0), (True, 0, 50.0),
               (False, 0, 0.0)]
# float32 only: the smoke configs' D = 16 on a small grid (one row tile
# a warp, as every shape above), then grids of 1.5x an H100's 132 SMs or
# more of 256-row blocks (B * H * ceil(Sq / 256) >= 198), where the plan
# takes two: every D up to 128, ragged Sq, GQA and H = KV
FLASH_TWO_TILE = [(2, 300, 300, 64, 16, 16), (2, 530, 530, 40, 8, 64),
                  (1, 700, 700, 80, 16, 112), (3, 260, 260, 40, 40, 128)]
FLASH_F32_SHAPES = [(2, 100, 100, 4, 2, 16)] + FLASH_TWO_TILE
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def ssd_inputs(b, L, H, P, G, N, dtype, seed=0):
    """Seeded SSD inputs on the card in the model's layout (x, B, C in
    ``dtype``; dt, A float32), as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed + b * L + H * P + N)
    x = rng.standard_normal((b, L, H, P)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, L, H))))
    A = -np.exp(rng.standard_normal(H) * 0.3)
    B = rng.standard_normal((b, L, G, N)) * 0.3
    C = rng.standard_normal((b, L, G, N)) * 0.3

    def dev(a, dt_=torch.float32):
        return torch.tensor(a, dtype=torch.float32).to(dt_).cuda()
    return dev(x, dtype), dev(dt), dev(A), dev(B, dtype), dev(C, dtype)


def ssd_plain(x, dt, A, B, C):
    """The sequential oracle on float32 copies of the inputs, and the
    state after the last step, ``sum_t (prod_{s > t} exp(dt_s A)) dt_t
    x_t B_t^T``."""
    H = x.shape[2]
    decay = torch.exp(dt * A)                             # (b, L, H)
    tail = torch.flip(torch.cumprod(torch.flip(decay, [1]), 1), [1])
    w = torch.cat([tail[:, 1:], torch.ones_like(tail[:, :1])], 1) * dt
    Bh = B.float().repeat_interleave(H // B.shape[2], 2)
    state = torch.einsum("blh,blhp,blhn->bhpn", w, x.float(), Bh)
    return ssd_op(x.float(), dt, A, B.float(), C.float()), state


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ssd_kernel_matches_plain_every_plan(card, shape, dtype):
    """Every cluster size the plan takes (the shapes' L reach 1, 2, 4
    and 8 blocks), against the sequential oracle."""
    b, L, H, P, G, N, Q = shape
    x, dt, A, B, C = ssd_inputs(b, L, H, P, G, N, dtype)
    want_y, want_s = ssd_plain(x, dt, A, B, C)
    plan = ssd.ssd_plan(L, P, N, Q)
    before = ssd.ssd_cuda.launches
    y, s = ssd.ssd_cuda(x, dt, A, B, C, chunk=Q)
    torch.cuda.synchronize()
    assert ssd.ssd_cuda.launches == before + 1
    assert y.dtype == torch.float32 and y.shape == (b, L, H, P)
    torch.testing.assert_close(y, want_y, atol=1e-3, rtol=1e-3,
                               msg=lambda m: f"{plan}: {m}")
    torch.testing.assert_close(s, want_s, atol=1e-3, rtol=1e-3,
                               msg=lambda m: f"{plan}: {m}")


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SSD_SEGMENT_SHAPES, ids=str)
def test_ssd_kernel_segments_carry_init_state(card, shape, dtype):
    """Rows of more chunks than one cluster holds (65 and 40 chunks: nine
    and five segments of 8), from a given initial state, against the
    chunked plain version."""
    b, L, H, P, G, N, Q = shape
    x, dt, A, B, C = ssd_inputs(b, L, H, P, G, N, dtype, seed=11)
    init = torch.tensor(np.random.default_rng(L).standard_normal(
        (b, H, P, N)) * 0.2, dtype=torch.float32).cuda()
    want_y, want_s = ssd_chunked_plain(x, dt, A, B, C, Q, init)
    plan = ssd.ssd_plan(L, P, N, Q)
    assert plan.segments > 1
    y, s = ssd.ssd_cuda(x, dt, A, B, C, chunk=Q, init_state=init)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want_y, atol=1e-3, rtol=1e-3,
                               msg=lambda m: f"{plan}: {m}")
    torch.testing.assert_close(s, want_s, atol=1e-3, rtol=1e-3,
                               msg=lambda m: f"{plan}: {m}")


def test_ssd_kernel_init_state_carries(card):
    """Two launches over the halves of a sequence, the second started
    from the first's final state, equal one launch over the whole."""
    b, L, H, P, G, N, Q = 2, 256, 4, 64, 1, 64, 128
    x, dt, A, B, C = ssd_inputs(b, L, H, P, G, N, torch.float32, seed=3)
    y, s = ssd.ssd_cuda(x, dt, A, B, C, chunk=Q)
    h = 100                                     # not a chunk multiple
    cut = lambda t, sl: t[:, sl].contiguous()   # noqa: E731
    y1, s1 = ssd.ssd_cuda(*(cut(t, slice(0, h)) for t in (x, dt)), A,
                          *(cut(t, slice(0, h)) for t in (B, C)), chunk=Q)
    y2, s2 = ssd.ssd_cuda(*(cut(t, slice(h, L)) for t in (x, dt)), A,
                          *(cut(t, slice(h, L)) for t in (B, C)), chunk=Q,
                          init_state=s1)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=1e-3,
                               rtol=1e-3)
    torch.testing.assert_close(s2, s, atol=1e-3, rtol=1e-3)


def test_ssd_kernel_refuses_what_it_cannot_launch(card):
    x, dt, A, B, C = ssd_inputs(1, 32, 2, 16, 1, 16, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_cuda(x.cpu(), dt, A, B, C, chunk=16)
    with pytest.raises(TypeError):
        ssd.ssd_cuda(x, dt.double(), A, B, C, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_cuda(x.transpose(1, 2), dt, A, B, C, chunk=16)
    # a state too wide for a block's shared memory
    wide = torch.zeros((1, 32, 1, 2048), device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        ssd.ssd_cuda(x, dt, A, wide, wide, chunk=16)
    # a plan for another shape disagrees with the kernel's layout, and a
    # cluster that is no power of two up to 8: the launch is refused,
    # nothing runs
    y = torch.empty_like(x)
    fin = torch.empty((1, 2, 16, 16), device="cuda")
    good = ssd.ssd_plan(32, 16, 16, 16)
    other = ssd.ssd_plan(32, 16, 64, 16)
    for cluster, smem in ((good.cluster, other.smem_bytes),
                          (3, good.smem_bytes), (16, good.smem_bytes)):
        with pytest.raises(RuntimeError, match="launch failed"):
            launch(ssd.load_library(), "ssd_mma_f32", ssd._ERROR, x.device,
                   x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                   C.data_ptr(), None, y.data_ptr(), fin.data_ptr(), 2, 32,
                   2, 16, 1, 16, good.steps, cluster, smem)


def flash_inputs(B, Sq, Sk, H, KV, D, dtype):
    rng = np.random.default_rng(B * Sq + H * D + KV)

    def dev(shape):
        return torch.tensor(rng.standard_normal(shape),
                            dtype=torch.float32).to(dtype).cuda()
    return dev((B, Sq, H, D)), dev((B, Sk, KV, D)), dev((B, Sk, KV, D))


@pytest.mark.parametrize("shape", FLASH_SHAPES + FLASH_F32_SHAPES, ids=str)
@pytest.mark.parametrize("causal,window,cap", FLASH_MASKS)
def test_flash_kernel_matches_plain_every_plan(card, shape, causal, window,
                                               cap):
    """The float32 kernel (TF32 in three passes; bfloat16 is the wgmma
    kernel's, below) in every launch plan: the shapes reach one and two
    row tiles a warp at every D up to 128 and the one plan of D = 256."""
    B, Sq, _, H, _, D = shape
    q, k, v = flash_inputs(*shape, torch.float32)
    want = attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
    plan = fa.mma_plan(D, B * H, Sq, fa._sms(q.device))
    assert plan.tiles == (2 if shape in FLASH_TWO_TILE else 1)
    before = fa.flash_attention_cuda.launches
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                  softcap=cap)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5,
                               msg=lambda m: f"{plan}: {m}")


@pytest.mark.parametrize("causal,window,cap", FLASH_MASKS)
def test_flash_kernel_long_sequence_float32(card, causal, window, cap):
    """Zamba2-7B's prompt length and head dim (S 2048, D 112; GQA here) in
    float32 at 2e-5, with 4 heads (16 query blocks of 128 rows) and 32
    (8 of 256, two row tiles a warp): a fault that shows only over many
    key tiles (tile skipping, the last key tile) is not hidden by the
    bfloat16 tolerance."""
    for shape in [(1, 2048, 2048, 4, 2, 112), (1, 2048, 2048, 32, 8, 112)]:
        q, k, v = flash_inputs(*shape, torch.float32)
        want = attention_ref(q, k, v, causal=causal, window=window,
                             softcap=cap)
        got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      softcap=cap)
        torch.cuda.synchronize()
        plan = fa.mma_plan(112, shape[3], 2048, fa._sms(q.device))
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5,
                                   msg=lambda m: f"{plan}: {m}")


def test_flash_kernel_refuses_what_it_cannot_launch(card):
    q, k, v = flash_inputs(1, 64, 64, 2, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q.cpu(), k, v)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_cuda(q[:, :, :1].contiguous(),
                                torch.cat([k, k, k], 2), torch.cat([v] * 3, 2))
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(*flash_inputs(1, 64, 64, 2, 2, 96,
                                              torch.float32))
    shifted = torch.empty(q.numel() + 1, device=q.device)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_cuda(shifted, k, v)


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS)
def test_flash_mma_launcher_refuses_another_layout(card, D):
    """The float32 launcher takes each plan's shared-memory bytes (which
    every launch above passes) and refuses any other count, any head dim
    it is not built for and any row tiles a warp but 1 and 2 (1 at
    D = 256)."""
    q, k, v = flash_inputs(1, 64, 64, 2, 2, D, torch.float32)
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, 64,
            64, 2, 2)
    tail = (1.0 / D ** 0.5, 1, 0, 0.0)
    plans = {fa.mma_plan(D, bh, 320) for bh in (1, 1024)}
    assert len(plans) == (2 if D <= 128 else 1)
    for plan in plans:
        with pytest.raises(RuntimeError, match="layout"):
            launch(fa.load_library(), "flash_attention_mma_f32", fa._ERROR,
                   q.device, *args, D, plan.tiles, *tail,
                   plan.smem_bytes + 16)
        with pytest.raises(RuntimeError, match="not built"):
            launch(fa.load_library(), "flash_attention_mma_f32", fa._ERROR,
                   q.device, *args, D + 8, plan.tiles, *tail,
                   plan.smem_bytes)
    for tiles in (0, 3, 2 if D == 256 else 4):
        with pytest.raises(RuntimeError, match="not built"):
            launch(fa.load_library(), "flash_attention_mma_f32", fa._ERROR,
                   q.device, *args, D, tiles, *tail,
                   fa.mma_plan(D, 1, 64).smem_bytes)


# Zamba2-7B's prompt length and head dim, with GQA and with H = KV: 16
# query blocks, up to 16 key tiles each, the skipped and the masked tiles
FLASH_LONG = [(1, 2048, 2048, 4, 2, 112), (1, 2048, 2048, 4, 4, 112)]
# ||got - want|| / ||want|| of the tensor-core kernel: rounding the output
# to bfloat16 alone gives ~1.6e-3 (an ulp of 2^-8..2^-7 relative, over
# sqrt 12) and rounding P adds less; one key tile of 16 dropped or read
# from the wrong stage moves a row by ~1e-1 of its norm at S = 2048,
# where each element's error can stay under 2e-2
WGMMA_REL_NORM = 5e-3


def rel_norm(got, want):
    return float((got.float() - want).norm() / want.norm())


@pytest.mark.parametrize("shape", FLASH_SHAPES + FLASH_LONG, ids=str)
@pytest.mark.parametrize("causal,window,cap", FLASH_MASKS)
def test_flash_wgmma_matches_plain(card, shape, causal, window, cap):
    """The tensor-core kernel at every test shape (GQA, ragged 130 and
    200, D = 64/112/128/256, S = 2048) and mask, one launch counted per
    call: each element within 2e-2 and the whole within WGMMA_REL_NORM."""
    q, k, v = flash_inputs(*shape, torch.bfloat16)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=window, softcap=cap)
    before = fa.flash_attention_wgmma.launches
    got = fa.flash_attention_wgmma(q, k, v, causal=causal, window=window,
                                   softcap=cap)
    torch.cuda.synchronize()
    assert fa.flash_attention_wgmma.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)
    assert rel_norm(got, want) <= WGMMA_REL_NORM


def test_attention_op_routes_by_dtype(card):
    """bfloat16 goes to the wgmma kernel, float32 to the TF32 mma.sync
    kernel, each one launch."""
    for dtype, kernel, other in (
            (torch.bfloat16, fa.flash_attention_wgmma,
             fa.flash_attention_cuda),
            (torch.float32, fa.flash_attention_cuda,
             fa.flash_attention_wgmma)):
        q, k, v = flash_inputs(2, 200, 200, 4, 2, 112, dtype)
        before = kernel.launches, other.launches
        got = attention_op(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert (kernel.launches, other.launches) == (before[0] + 1,
                                                     before[1])
        assert got.dtype == dtype


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS)
def test_flash_wgmma_launcher_refuses_another_layout(card, D):
    """The launcher takes the plan's shared-memory bytes (which every
    launch above passes) and refuses any other count: the plan and the
    kernel's layout cannot drift apart unseen."""
    q, k, v = flash_inputs(1, 64, 64, 2, 2, D, torch.bfloat16)
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, 64,
            64, 2, 2, D, 1.0 / D ** 0.5, 1, 0, 0.0)
    with pytest.raises(RuntimeError, match="layout"):
        launch(fa.load_wgmma_library(), "flash_attention_wgmma_bf16",
               fa._WGMMA_ERROR, q.device, *args,
               fa.wgmma_plan(D).smem_bytes + 8)


def test_flash_wgmma_refuses_what_it_cannot_launch(card):
    q, k, v = flash_inputs(1, 64, 64, 2, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_wgmma(q.cpu(), k, v)
    with pytest.raises(TypeError):
        fa.flash_attention_wgmma(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_wgmma(q.transpose(1, 2).contiguous().transpose(
            1, 2), k, v)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_wgmma(*flash_inputs(1, 64, 64, 2, 2, 96,
                                               torch.bfloat16))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_wgmma(q[:, :, :1].contiguous(),
                                 torch.cat([k] * 3, 2), torch.cat([v] * 3, 2))


def _rel(got, want):
    return float((got.float().cpu() - want.float()).abs().max()) / (
        float(want.float().abs().max()) + 1e-9)


@pytest.mark.parametrize("arch", ["zamba2_7b", "mamba2_370m"])
def test_smoke_serve_on_card_matches_cpu(card, arch):
    """The smoke model (float32) served on the card, through the kernels,
    against the same parameters served on the CPU through the plain
    versions: the same greedy tokens, logits within relative 1e-4, and
    every prefill's SSD and flash launches counted (none in decode).  The
    prompt of 300 tokens takes the chunked attention branch."""
    cfg = get_smoke(arch).scaled(dtype="float32", param_dtype="float32")
    cpu = init_model(cfg, seed=5, device="cpu")
    gpu = tree_map(lambda t: t.cuda(), cpu, lambda t: isinstance(t,
                                                               torch.Tensor))
    g = torch.Generator()
    g.manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (2, 300), generator=g)
    before = (ssd.ssd_cuda.launches, fa.flash_attention_cuda.launches)
    out_g, lg_g = steps.generate(gpu, cfg, toks.cuda(), 6)
    torch.cuda.synchronize()
    n_ssd = ssd.ssd_cuda.launches - before[0]
    n_fa = fa.flash_attention_cuda.launches - before[1]
    out_c, lg_c = steps.generate(cpu, cfg, toks, 6)
    assert torch.equal(out_g.cpu(), out_c)
    assert _rel(lg_g, lg_c) < 1e-4
    assert n_ssd == cfg.n_layers
    assert n_fa == (cfg.n_layers // cfg.hybrid_period
                    if cfg.family == "hybrid" else 0)


@pytest.mark.parametrize("arch", ["gemma2_9b", "starcoder2_3b"])
def test_dense_smoke_serve_on_card_matches_cpu(card, arch):
    """The dense smoke models (float32) served on the card against the
    CPU: the same greedy tokens, logits within relative 1e-4, one flash
    launch per layer in prefill and none in decode.  gemma2's 300-token
    prompt gives its local layers' flash launches a window (32) and every
    launch the soft-cap 50, and its local decode cache (32 slots) rolls
    in the prefill copy and in decode."""
    cfg = get_smoke(arch).scaled(dtype="float32", param_dtype="float32")
    cpu = init_model(cfg, seed=5, device="cpu")
    gpu = tree_map(lambda t: t.cuda(), cpu, lambda t: isinstance(t,
                                                               torch.Tensor))
    g = torch.Generator()
    g.manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (2, 300), generator=g)
    before = (fa.flash_attention_cuda.launches,
              fa.flash_attention_wgmma.launches)
    out_g, lg_g = steps.generate(gpu, cfg, toks.cuda(), 6)
    torch.cuda.synchronize()
    n_fa = fa.flash_attention_cuda.launches - before[0]
    n_wg = fa.flash_attention_wgmma.launches - before[1]
    out_c, lg_c = steps.generate(cpu, cfg, toks, 6)
    assert torch.equal(out_g.cpu(), out_c)
    assert _rel(lg_g, lg_c) < 1e-4
    assert (n_fa, n_wg) == (cfg.n_layers, 0)
    # bfloat16 compute, through the launcher: the tensor-core kernel
    res = serve_launch.main(["--arch", arch, "--smoke", "--batch", "2",
                             "--prompt-len", "300", "--gen", "3",
                             "--warmup", "0"])
    assert res["prefill_launches"] == {"ssd": 0, "flash": cfg.n_layers}
    assert res["decode_launches"] == {"ssd": 0, "flash": 0}
    assert fa.flash_attention_wgmma.launches - before[1] == cfg.n_layers


@pytest.mark.parametrize("arch,threshold", [("olmoe_1b_7b", None),
                                            ("deepseek_v3_671b", None),
                                            ("deepseek_v3_671b", 64)])
def test_moe_smoke_serve_on_card_matches_cpu(card, arch, threshold,
                                             monkeypatch):
    """The MoE smoke models (float32, default capacity) served on the
    card against the CPU: the same greedy tokens, logits within relative
    1e-4; OLMoE's qk-norm attention takes one flash launch per layer in
    prefill, DeepSeek-V3's MLA none (plain PyTorch; with the threshold at
    64 its chunked branch), and decode none."""
    if threshold:
        monkeypatch.setattr(mla, "FLASH_THRESHOLD", threshold)
    cfg = get_smoke(arch).scaled(dtype="float32", param_dtype="float32")
    cpu = init_model(cfg, seed=5, device="cpu")
    gpu = tree_map(lambda t: t.cuda(), cpu, lambda t: isinstance(t,
                                                               torch.Tensor))
    g = torch.Generator()
    g.manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (2, 300), generator=g)
    before = (fa.flash_attention_cuda.launches,
              fa.flash_attention_wgmma.launches)
    out_g, lg_g = steps.generate(gpu, cfg, toks.cuda(), 6)
    torch.cuda.synchronize()
    n_fa = fa.flash_attention_cuda.launches - before[0]
    n_wg = fa.flash_attention_wgmma.launches - before[1]
    out_c, lg_c = steps.generate(cpu, cfg, toks, 6)
    assert torch.equal(out_g.cpu(), out_c)
    assert _rel(lg_g, lg_c) < 1e-4
    assert (n_fa, n_wg) == (0 if cfg.use_mla else cfg.n_layers, 0)


def test_launcher_on_card_counts_prefill_launches(card):
    """The smoke config computes in bfloat16: its attention launches are
    the tensor-core kernel's."""
    before = fa.flash_attention_wgmma.launches
    res = serve_launch.main(["--arch", "zamba2_7b", "--smoke", "--batch",
                             "2", "--prompt-len", "300", "--gen", "3",
                             "--warmup", "0"])
    assert res["prefill_launches"] == {"ssd": 5, "flash": 2}
    assert res["decode_launches"] == {"ssd": 0, "flash": 0}
    assert fa.flash_attention_wgmma.launches - before == 2
    assert res["tokens"].shape == (2, 3) and res["device"] != "cpu"


# Whisper-large-v3's attention at a reduced batch: the encoder's
# non-causal self-attention (Sq = Sk = 1500, whose last key tile holds
# 1500 - 11 * 128 = 92 keys) and the decoder's cross-attention over it
# (Sq 224 != Sk 1500), H = KV = 20, D 64
WHISPER_FLASH = [(2, 1500, 1500, 20, 20, 64), (2, 224, 1500, 20, 20, 64)]


@pytest.mark.parametrize("shape", WHISPER_FLASH, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_flash_whisper_shapes_match_plain(card, shape, dtype):
    """Both kernels non-causal at Whisper's shapes, one launch each,
    through ``attention_op`` as the model calls it: float32 within 2e-5
    of the plain version, bfloat16 within 2e-2 and WGMMA_REL_NORM."""
    q, k, v = flash_inputs(*shape, dtype)
    want = attention_ref(q.float(), k.float(), v.float(), causal=False)
    kernel = (fa.flash_attention_cuda if dtype == torch.float32
              else fa.flash_attention_wgmma)
    before = kernel.launches
    got = attention_op(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    else:
        torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)
        assert rel_norm(got, want) <= WGMMA_REL_NORM


def test_whisper_smoke_serve_on_card_matches_cpu(card):
    """Whisper's smoke config with 320 frames (float32), prompt 260: the
    encoder (320 x 320), the cross-attention (260 x 320) and the decoder's
    self-attention (260 x 260) each take the float32 flash kernel, one
    launch a layer (2 + 4 + 4) in prefill and none in decode; the same
    greedy tokens as the CPU, logits within relative 1e-4."""
    cfg = get_smoke("whisper_large_v3").scaled(
        dtype="float32", param_dtype="float32", encoder_seq=320)
    cpu = init_model(cfg, seed=5, device="cpu")
    gpu = tree_map(lambda t: t.cuda(), cpu, lambda t: isinstance(t,
                                                               torch.Tensor))
    g = torch.Generator()
    g.manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (2, 260), generator=g)
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=g) * 0.1
    before = fa.flash_attention_cuda.launches
    out_g, lg_g = steps.generate(gpu, cfg, toks.cuda(), 6,
                                 frames=frames.cuda())
    torch.cuda.synchronize()
    n_fa = fa.flash_attention_cuda.launches - before
    out_c, lg_c = steps.generate(cpu, cfg, toks, 6, frames=frames)
    assert torch.equal(out_g.cpu(), out_c)
    assert _rel(lg_g, lg_c) < 1e-4
    assert n_fa == cfg.n_encoder_layers + 2 * cfg.n_layers


# long rows whose values run coherently along the keys (mean 2): the
# tensor cores round each sum toward zero, and P V taken straight into O
# drifted past 2e-5 over 1500 keys on a Whisper encoder layer; the
# float32 kernel's per-8-key partials hold it (both row-tile plans)
COHERENT = [(1, 1500, 1500, 20, 20, 64), (8, 1500, 1500, 20, 20, 64),
            (1, 4096, 4096, 4, 4, 112)]


@pytest.mark.parametrize("shape", COHERENT, ids=str)
def test_flash_f32_coherent_values_long_rows(card, shape):
    q, k, v = flash_inputs(*shape, torch.float32)
    v = 2.0 + 0.5 * v
    want = attention_ref(q, k, v, causal=False)
    got = fa.flash_attention_cuda(q, k, v, causal=False)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)

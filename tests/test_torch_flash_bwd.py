"""The flash-attention backward: the wrapper's refusals and launch plan,
``attention_op``'s routes, and the ``refuse_grad`` guards of the forward
and SSD kernels on the CPU; on the card (marker ``cuda``) the backward
kernel against the plain version's autograd gradients in every mask case
and head dim, the model's chunked branch through ``FlashAttention`` and
``ssd_chunked``'s refusal.  No JAX here, so the card's cases run on a
machine that has the card but no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_bwd.py

Tolerances, on the relative norm of each gradient's whole error against
the plain version's float32 autograd gradient (``ref.py::attention_ref``
on the inputs upcast to float32, dO too): float32 1e-5 (the kernel sums
in float32 in another order, and its O is the TF32 x 3 forward's);
bfloat16 5e-3 (the inputs are bfloat16 on both sides and the kernel
recomputes O in float32, but its gradients are rounded to bfloat16:
1.7e-3 seen on an H100)."""
import numpy as np
import pytest
import torch

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

@pytest.mark.parametrize("D", HEAD_DIMS)
def test_bwd_plan_fits_a_block(D):
    plan = fa.bwd_plan(D)
    assert plan.bq == plan.bk == (64 if D <= 128 else 32)
    floats = (4 * plan.bq) * (D + 1) + 2 * plan.bq * (plan.bk + 1) \
        + 2 * plan.bq
    assert plan.smem_bytes == 4 * floats <= fa.SMEM_LIMIT


def test_bwd_refuses_what_the_kernel_does_not_take():
    q, k, v, do = inputs(1, 8, 8, 2, 1, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, k, v, q, do)
    with pytest.raises(ValueError, match="head dim"):
        fa.bwd_plan(32)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        fa.flash_attention_bwd_cuda(q, k, v, q.double(), do)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        fa.flash_attention_bwd_cuda(q.half(), k.half(), v.half(), q.half(),
                                    do.half())
    with pytest.raises(ValueError, match="multiple"):
        q3, k3, v3, do3 = inputs(1, 8, 8, 3, 2, 16, torch.float32, "cpu")
        fa.flash_attention_bwd_cuda(q3, k3, v3, q3, do3)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_bwd_cuda(q, k, v, q[:, :4], do)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_bwd_cuda(q, k, v, q, do, window=-1)
    with pytest.raises(ValueError, match="None for bfloat16"):
        fa.flash_attention_bwd_cuda(q, k, v, None, do)
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    with pytest.raises(ValueError, match="None for bfloat16"):
        fa.flash_attention_bwd_cuda(qb, kb, vb, qb, dob)
    assert fa.flash_attention_bwd_cuda.launches == 0


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("causal,window,cap,dims", CASES)
def test_bwd_kernel_matches_plain_autograd(card, causal, window, cap, dims,
                                           D, dtype):
    B, Sq, Sk, H, KV = dims
    q, k, v, do = inputs(B, Sq, Sk, H, KV, D, dtype, "cuda")
    # the float32 backward reads the forward's o; bfloat16's recomputes it
    o = (fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                 softcap=cap)
         if dtype == torch.float32 else None)
    n = fa.flash_attention_bwd_cuda.launches
    got = fa.flash_attention_bwd_cuda(q, k, v, o, do, causal=causal,
                                      window=window, softcap=cap)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_cuda.launches == n + 1
    want = plain_grads(q, k, v, do, causal, window, cap)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.isfinite(g).all()
        assert rel_norm(g, w) <= REL[dtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_op_routes_a_gradient_through_the_kernels(card, dtype):
    """Grad mode on and inputs that require a gradient: one forward and
    one backward launch through ``FlashAttention``; under inference mode
    the forward kernel alone, as the serve steps run it."""
    q, k, v, do = inputs(2, 300, 300, 4, 2, 64, dtype, "cuda")
    fwd = fa.forward_kernel(dtype)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    n_f, n_b = fwd.launches, fa.flash_attention_bwd_cuda.launches
    o = attention_op(*leaves, causal=True)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert (fwd.launches - n_f, fa.flash_attention_bwd_cuda.launches - n_b) \
        == (1, 1)
    for g, w in zip(got, plain_grads(q, k, v, do, True, 0, 0.0)):
        assert rel_norm(g, w) <= REL[dtype]
    with torch.inference_mode():
        o2 = attention_op(q, k, v, causal=True)
    assert fa.flash_attention_bwd_cuda.launches - n_b == 1
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


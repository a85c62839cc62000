"""The port's SSD scan against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages: the port's
sequential ``ssd_ref``, its ``ssd_op`` (that oracle in the model's
layout) and its chunked ``ssd_chunked`` (y and the final state, with and
without an initial state) against JAX ``ssd_ref``, ``ssd_op`` with the
Pallas kernel in interpret mode, and ``models.mamba2.ssd_chunked``.
Tolerances are the JAX package's own: 1e-3 in float32 and 5e-2 in
bfloat16 (``tests/test_kernels.py::test_ssd_sweep``), 1e-4 between the
two chunked versions (``test_model_chunked_ssd_matches_kernel``).  The
CUDA kernel itself is held to these plain versions on the card
(``tests/test_torch_model_cuda.py``); here its launch plan is checked on
every shape the tests and ``chip_smoke.py`` use, and the three-pass TF32
split of its tensor-core products is emulated on a Zamba2-7B chunk.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import mm_one_pass, mm_three_pass
from repro.kernels.ssd.ops import ssd_op as jax_ssd_op
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd.ops import ssd_op
from repro_torch.kernels.ssd.ref import ssd_ref
from repro_torch.models.mamba2 import ssd_chunked, ssd_chunked_plain

# (b, L, H, P, G, N, chunk): tests/test_kernels.py's four SSD shapes, its
# model-vs-kernel shape, and Zamba2-7B's per-head shape at a short,
# ragged L
SHAPES = [(1, 32, 2, 16, 1, 16, 16), (2, 64, 4, 32, 2, 32, 32),
          (1, 100, 4, 64, 1, 64, 64), (2, 256, 8, 64, 4, 128, 128),
          (2, 96, 4, 32, 1, 32, 32), (1, 300, 4, 64, 1, 64, 128)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _inputs(b, L, H, P, G, N, seed=0):
    """Seeded float32 numpy inputs in the model layout, drawn as
    tests/test_kernels.py draws its JAX ones."""
    rng = np.random.default_rng(seed + 7 * b * L + H * P + N)
    f = np.float32
    x = (rng.standard_normal((b, L, H, P)) * 0.5).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, L, H)))).astype(f)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(f)
    B = (rng.standard_normal((b, L, G, N)) * 0.3).astype(f)
    C = (rng.standard_normal((b, L, G, N)) * 0.3).astype(f)
    return x, dt, A, B, C


def _both(arrays, jdt, tdt):
    """The same values as JAX arrays and torch tensors of one dtype (both
    round float32 to bfloat16 to nearest even)."""
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


def _flat(x, dt, B, C, H):
    """Model layout -> the kernels' (b*H, L, ...) layout, groups broadcast
    to heads (as the JAX kernel test builds its oracle's inputs)."""
    b, L, _, P = x.shape
    rep = H // B.shape[2]
    Bh = np.repeat(B, rep, axis=2)
    Ch = np.repeat(C, rep, axis=2)
    return (x.transpose(0, 2, 1, 3).reshape(b * H, L, P),
            dt.transpose(0, 2, 1).reshape(b * H, L),
            Bh.transpose(0, 2, 1, 3).reshape(b * H, L, -1),
            Ch.transpose(0, 2, 1, 3).reshape(b * H, L, -1))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_ref_matches_jax(shape, dtype):
    b, L, H, P, G, N, _ = shape
    x, dt, A, B, C = _inputs(b, L, H, P, G, N)
    xf, dtf, Bf, Cf = _flat(x, dt, B, C, H)
    Af = np.tile(A, b)
    jdt, tdt, tol = DTYPES[dtype]
    (jx, jdt_, jB, jC), (tx, tdt_, tB, tC) = _both([xf, dtf, Bf, Cf], jdt,
                                                   tdt)
    want = jax_ssd_ref(jx, jdt_, jnp.asarray(Af), jB, jC)
    got = ssd_ref(tx, tdt_, torch.from_numpy(Af), tB, tC)
    assert got.dtype == tdt and got.shape == (b * H, L, P)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_op_matches_jax_pallas_interpret(shape, dtype):
    """The port's oracle in the model's layout against the JAX entry
    running the Pallas kernel in interpret mode."""
    b, L, H, P, G, N, Q = shape
    x, dt, A, B, C = _inputs(b, L, H, P, G, N)
    jdt, tdt, tol = DTYPES[dtype]
    (jx, jdt_, jB, jC), (tx, tdt_, tB, tC) = _both([x, dt, B, C], jdt, tdt)
    want = jax_ssd_op(jx, jdt_, jnp.asarray(A), jB, jC, chunk=Q,
                      use_pallas=True)
    got = ssd_op(tx, tdt_, torch.from_numpy(A), tB, tC)
    assert got.dtype == tdt and got.shape == (b, L, H, P)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_jax(shape, dtype, with_init):
    """The port's chunked SSD (the CPU route of ``mamba_block``) against
    ``models.mamba2.ssd_chunked``: y and the final state, from zeros or
    from a given state.  dt and A are float32, as on the model path."""
    b, L, H, P, G, N, Q = shape
    x, dt, A, B, C = _inputs(b, L, H, P, G, N)
    init = (np.random.default_rng(L).standard_normal((b, H, P, N)) * 0.2
            ).astype(np.float32) if with_init else None
    jdt, tdt, _ = DTYPES[dtype]
    (jx, jB, jC), (tx, tB, tC) = _both([x, B, C], jdt, tdt)
    y_w, s_w = jax_ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                               Q, None if init is None else jnp.asarray(init))
    y, s = ssd_chunked(tx, torch.from_numpy(dt), torch.from_numpy(A), tB,
                       tC, Q, None if init is None else torch.from_numpy(init))
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    assert y.shape == (b, L, H, P) and s.shape == (b, H, P, N)
    np.testing.assert_allclose(_np(y), _np(y_w), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(s), _np(s_w), atol=1e-4, rtol=1e-4)


def test_ssd_chunked_plain_matches_sequential_oracle():
    """The two plain versions agree with each other (chunked vs the
    step-by-step recurrence), so the card's comparisons have one answer."""
    b, L, H, P, G, N, Q = 2, 100, 4, 16, 2, 16, 32
    x, dt, A, B, C = (torch.from_numpy(a) for a in
                      _inputs(b, L, H, P, G, N, seed=5))
    y, _ = ssd_chunked_plain(x, dt, A, B, C, Q)
    want = ssd_op(x, dt, A, B, C)
    torch.testing.assert_close(y, want, atol=1e-4, rtol=1e-4)


# every (P, N, Q) the tests and chip_smoke.py run: the shapes above, the
# smoke configs (16, 16, 16), Zamba2-7B (64, 64, 128), Mamba2-370M
# (64, 128, 128), and the card tests' segmented row at odd widths
PLAN_SHAPES = sorted({(s[3], s[5], s[6]) for s in SHAPES}
                     | {(16, 16, 16), (64, 64, 128), (64, 128, 128),
                        (22, 18, 16)})


@pytest.mark.parametrize("P,N,Q", PLAN_SHAPES)
def test_ssd_launch_plan_takes_every_shape(P, N, Q):
    """No shape of the tests or the smoke run is refused: the kernel's
    chunk is the model's, cut to 64 steps, and the plan takes the
    smallest power-of-two cluster, at most 8 blocks, that covers the
    row's chunks, walked in as few segments as that allows, within the
    shared memory a block may use, for rows of 1 to 40 model chunks (a
    ragged last one included): clusters of 1, 2, 4 and 8 all occur."""
    steps = min(Q, ssd_kernel.MAX_STEPS)
    clusters = set()
    for L in (1, steps + 1, 3 * steps, Q, 16 * Q, 16 * Q + 1, 33 * Q - 5,
              40 * Q):
        chunks = -(-L // steps)
        plan = ssd_kernel.ssd_plan(L, P, N, Q)
        assert plan.steps == steps
        assert plan.cluster == min(8, 1 << (chunks - 1).bit_length())
        assert plan.segments == -(-chunks // plan.cluster)
        assert plan.smem_bytes == ssd_kernel.ssd_smem_bytes(
            P, N, steps) <= ssd_kernel.SMEM_LIMIT
        clusters.add(plan.cluster)
    assert clusters == {1, 2, 4, 8}


def test_ssd_plan_segments_long_rows_and_refuses_what_does_not_fit():
    """Zamba2-7B's prefill row (2048 steps, model chunk 128) runs as 32
    kernel chunks of 64 in four segments of an 8-block cluster, and its
    block fits four times on an SM; a row of 4133 steps takes nine
    segments.  A state too wide for shared memory is refused, not placed
    some other way; a longer model chunk is cut to 64 steps like any
    other."""
    smem = ssd_kernel.ssd_smem_bytes(64, 64, 64)
    assert ssd_kernel.ssd_plan(2048, 64, 64, 128) == (64, 8, 4, smem)
    assert 4 * (smem + 1024) <= 228 * 1024
    assert ssd_kernel.ssd_plan(4133, 64, 64, 128)[:3] == (64, 8, 9)
    assert ssd_kernel.ssd_plan(2048, 64, 64, 256)[:3] == (64, 8, 4)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_kernel.ssd_plan(2048, 256, 256, 128)
    with pytest.raises(ValueError, match="empty"):
        ssd_kernel.ssd_plan(0, 64, 64, 128)


def _chunk(x, dt, A, B, C, state, mm):
    """One chunk of the SSD scan through its four products, each taken by
    ``mm``: y (Q, P) and the state after the chunk (P, N)."""
    a = torch.cumsum(dt * A, 0)
    causal = torch.ones(len(a), len(a), dtype=torch.bool).tril()
    decay = torch.exp((a[:, None] - a[None, :]).masked_fill(~causal,
                                                            float("-inf")))
    scores = mm(C, B.T) * decay * dt[None, :]
    y = mm(scores, x) + torch.exp(a)[:, None] * mm(C, state.T)
    w = torch.exp(a[-1] - a) * dt
    return y, state * torch.exp(a[-1]) + mm((x * w[:, None]).T, B)


def test_tf32_three_pass_split_keeps_float32_tolerance():
    """The precision argument for the kernel's tensor-core products, on a
    Zamba2-7B chunk (P = N = 64, Q = 128, a carried state): the three-pass
    TF32 split stays within the float32 tolerance (1e-3) of the float32
    products, and well inside it; one TF32 pass does not stay well
    inside it.  Both errors are printed (pytest -s)."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in
                      _inputs(1, 128, 1, 64, 1, 64, seed=19))
    x, dt, B, C = x[0, :, 0], dt[0, :, 0], B[0, :, 0], C[0, :, 0]
    state = torch.from_numpy((np.random.default_rng(19).standard_normal(
        (64, 64)) * 0.2).astype(np.float32))
    want = _chunk(x, dt, A[0], B, C, state, torch.matmul)
    err = {}
    for name, mm in (("three_pass", mm_three_pass),
                     ("one_pass", mm_one_pass)):
        got = _chunk(x, dt, A[0], B, C, state, mm)
        err[name] = max(float(((g - w).abs() / (1e-3 + 1e-3 * w.abs())
                               ).max()) for g, w in zip(got, want))
        if name == "three_pass":
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3)
    print(f"TF32 error over the 1e-3 float32 tolerance (1.0 = at the "
          f"bound): three_pass={err['three_pass']:.3g} "
          f"one_pass={err['one_pass']:.3g}")
    assert err["three_pass"] < 0.01 < err["one_pass"]


def test_ssd_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches on a CUDA tensor or raises: it has no CPU
    mode of its own (the CPU route is the plain version, by device)."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in
                      _inputs(1, 32, 2, 16, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_cuda(x, dt, A, B, C, chunk=16)
    assert jax.default_backend() == "cpu"

"""The port's min-plus DP sweep against the JAX package.

The plain PyTorch sweep (the port's CPU path and the CUDA kernel's
oracle) must equal the reference's jnp sweep in float64 and float32, and
its Pallas kernel (interpret mode) in float32, bit for bit in cost and
exactly in the first-index split: min-plus has no multiply, so there is
no rounding for the two to disagree on.  The CUDA kernel itself is held
to the plain version on the card (tests/test_torch_minplus_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_shims  # noqa: F401  (fixture)
from repro.kernels.minplus.kernel import minplus_sweep_pallas
from repro.kernels.minplus.ref import minplus_sweep_ref as jax_sweep_ref
from repro_torch.kernels.minplus import ops
from repro_torch.kernels.minplus.kernel import minplus_sweep_cuda
from repro_torch.kernels.minplus.ref import minplus_sweep_ref

# tests/test_kernels.py's sweep shapes plus the slice's (m_pad, d1) buckets
SHAPES = [(3, 2, 6), (9, 17, 33), (16, 65, 300), (8, 64, 1280),
          (4, 640, 1280)]


def _rows(T, dc1, d1, inf_frac):
    rng = np.random.default_rng(T * d1 + dc1)
    rows = rng.random((T, dc1))
    rows[rng.random((T, dc1)) < inf_frac] = np.inf
    rows[:, 0] = 0.0
    return rows


def _assert_same(cost, split, cost_ref, split_ref):
    cost, cost_ref = np.asarray(cost), np.asarray(cost_ref)
    assert cost.dtype == cost_ref.dtype
    assert np.array_equal(np.isinf(cost), np.isinf(cost_ref))
    # bitwise: same bit patterns, +inf included
    assert np.array_equal(cost.view(np.uint8), cost_ref.view(np.uint8))
    assert np.array_equal(np.asarray(split), np.asarray(split_ref))


@pytest.mark.parametrize("T,dc1,d1", SHAPES)
@pytest.mark.parametrize("inf_frac", [0.0, 0.4])
def test_sweep_ref_equals_jax_ref_f64(jax_shims, T, dc1, d1, inf_frac):
    rows = _rows(T, dc1, d1, inf_frac)
    with jax.enable_x64(True):
        c_ref, s_ref = jax_sweep_ref(jnp.asarray(rows, jnp.float64), d1 - 1)
        c_ref, s_ref = np.asarray(c_ref), np.asarray(s_ref)
    cost, split = minplus_sweep_ref(torch.tensor(rows), d1 - 1)
    assert cost.dtype == torch.float64 and split.dtype == torch.int32
    _assert_same(cost.numpy(), split.numpy(), c_ref, s_ref)


@pytest.mark.parametrize("T,dc1,d1", SHAPES)
@pytest.mark.parametrize("inf_frac", [0.0, 0.4])
def test_sweep_ref_equals_jax_ref_and_pallas_f32(jax_shims, T, dc1, d1,
                                                 inf_frac):
    rows = _rows(T, dc1, d1, inf_frac).astype(np.float32)
    cost, split = minplus_sweep_ref(torch.tensor(rows), d1 - 1)
    assert cost.dtype == torch.float32
    c_ref, s_ref = jax_sweep_ref(jnp.asarray(rows), d1 - 1)
    _assert_same(cost.numpy(), split.numpy(), c_ref, s_ref)
    c_pl, s_pl = minplus_sweep_pallas(jnp.asarray(rows), d1 - 1,
                                      interpret=True)
    _assert_same(cost.numpy(), split.numpy(), c_pl, s_pl)


def test_sweep_all_inf_split_is_zero():
    """Cells no split can reach stay +inf with split 0, as in the Pallas
    kernel and the jnp reference."""
    rows = torch.full((3, 4), float("inf"), dtype=torch.float64)
    rows[:, 0] = 0.0
    cost, split = minplus_sweep_ref(rows, 9)
    assert torch.equal(cost[:, 0], torch.zeros(3, dtype=torch.float64))
    assert torch.isinf(cost[:, 1:]).all()
    assert (split == 0).all()


def test_ops_dispatch_cpu_uses_plain_version():
    rows = torch.tensor(_rows(5, 7, 20, 0.3))
    before = minplus_sweep_cuda.launches
    cost, split = ops.minplus_sweep(rows, 19)
    cost_only, none = ops.minplus_sweep(rows, 19, want_split=False)
    ref_cost, ref_split = minplus_sweep_ref(rows, 19)
    assert none is None and minplus_sweep_cuda.launches == before
    assert torch.equal(cost, ref_cost) and torch.equal(split, ref_split)
    assert torch.equal(cost_only, ref_cost)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        minplus_sweep_cuda(torch.zeros((2, 3), dtype=torch.float64), 4)


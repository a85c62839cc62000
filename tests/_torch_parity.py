"""Shared pieces of the port's parity tests (tests/test_torch_*.py).

``jax_shims`` maps two JAX APIs that newer JAX releases renamed back to
the names the reference package calls (``jax.experimental.enable_x64``,
``pltpu.TPUCompilerParams``), only where the attribute is missing, and
makes ``jax.make_mesh`` build Auto axes where its default became
Explicit ones (which the reference's ``with_sharding_constraint`` calls
refuse), only for the test that asks for it: monkeypatch undoes all three
at teardown, and JAX's compilation caches are cleared so no executable
traced under the shims outlives the test.

``one_torch_thread`` (autouse where a test module imports it) runs
torch's CPU ops on one thread: the scheduler instances of the serving and
churn tests are small, and on a busy machine (the test workers run side
by side) a pool of threads mostly waits at each op's barrier.

``tf32``, ``mm_one_pass`` and ``mm_three_pass`` emulate on the CPU how
the port's tensor-core kernels (the SSD scan and the float32 flash
attention) take a float32 product in TF32: the precision argument both
kernels rest on.
"""
import jax
import jax.experimental
import jax.sharding
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu


@pytest.fixture
def jax_shims(monkeypatch):
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                            raising=False)
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)
    axis_type = getattr(jax.sharding, "AxisType", None)
    if axis_type is not None and any(
            t != axis_type.Auto for t in jax.make_mesh((1,), ("x",)).axis_types):
        make_mesh = jax.make_mesh

        def auto_mesh(shape, names, axis_types=None, **kw):
            if axis_types is None:
                axis_types = (axis_type.Auto,) * len(names)
            return make_mesh(shape, names, axis_types, **kw)
        monkeypatch.setattr(jax, "make_mesh", auto_mesh)
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(a: torch.Tensor) -> torch.Tensor:
    """``a`` as the TF32 tensor cores read a float32: the low 13 mantissa
    bits dropped."""
    return (a.view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_one_pass(a, b):
    return tf32(a) @ tf32(b)


def mm_three_pass(a, b):
    """The kernels' product: a = hi + lo with hi = tf32(a) and lo =
    tf32(a - hi), likewise b, summed as lo_a hi_b + hi_a lo_b + hi_a hi_b
    (TF32 products are exact in float32; the sums are float32)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh

"""Shared pieces of the port's parity tests (tests/test_torch_*.py).

``jax_shims`` maps two JAX APIs that newer JAX releases renamed back to
the names the reference package calls (``jax.experimental.enable_x64``,
``pltpu.TPUCompilerParams``), only where the attribute is missing, and
only for the test that asks for it: monkeypatch undoes both at teardown,
and JAX's compilation caches are cleared so no executable traced under
the shims outlives the test.
"""
import jax
import jax.experimental
import pytest
from jax.experimental.pallas import tpu as pltpu


@pytest.fixture
def jax_shims(monkeypatch):
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                            raising=False)
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)
    yield
    jax.clear_caches()

"""The port's CUDA DP sweep on the card, against its plain version.

Needs a CUDA device (marker ``cuda``) and nothing of JAX, so it also runs
on a machine that has the card but no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_minplus_cuda.py

Min-plus has no multiply, so the kernel must equal the plain version bit
for bit, in cost and in the first-index split, in float32 and float64.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.schedule_torch import _shape_bucket
from repro_torch.kernels.minplus.kernel import minplus_sweep_cuda
from repro_torch.kernels.minplus.ref import minplus_sweep_ref
from repro_torch.sim import engine, workload

# tests/test_kernels.py's sweep shapes, the slice's (m_pad, d1) buckets
# and the widest 10x-instance sweep
SHAPES = [(3, 2, 6), (9, 17, 33), (16, 65, 300), (8, 64, 1280),
          (4, 640, 1280), (500, 640, 1280)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _rows(T, dc1, d1, inf_frac):
    rng = np.random.default_rng(T * d1 + dc1)
    rows = rng.random((T, dc1))
    rows[rng.random((T, dc1)) < inf_frac] = np.inf
    rows[:, 0] = 0.0
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("T,dc1,d1", SHAPES)
def test_cuda_kernel_equals_plain_version(card, T, dc1, d1, dtype):
    rows = torch.tensor(_rows(T, dc1, d1, 0.4), dtype=dtype, device="cuda")
    cost, split = minplus_sweep_cuda(rows, d1 - 1)
    cost_only, none = minplus_sweep_cuda(rows, d1 - 1, want_split=False)
    ref_cost, ref_split = minplus_sweep_ref(rows, d1 - 1)
    torch.cuda.synchronize()
    assert none is None and cost.dtype == dtype and split.dtype == torch.int32
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(cost.view(bits), ref_cost.view(bits))   # +inf too
    assert torch.equal(split, ref_split)
    assert torch.equal(cost_only.view(bits), cost.view(bits))


@pytest.mark.cuda
def test_engine_on_card_equals_cpu_and_launches_once_per_decision(card):
    cluster = workload.make_cluster(T=30, H=6, K=6)
    jobs = workload.make_jobs(30, T=30, seed=4, small=True)
    dp = sum(_shape_bucket(engine._with_quantum(j, 0)) is not None
             for j in jobs)
    before = minplus_sweep_cuda.launches
    gpu = engine.run(cluster, jobs, quantum=0)
    assert minplus_sweep_cuda.launches - before == dp
    cpu = engine.run(cluster, jobs, quantum=0, device="cpu")
    assert gpu.completion == cpu.completion
    assert gpu.total_utility == pytest.approx(cpu.total_utility, rel=1e-9)
    assert gpu.device_uploads == 1

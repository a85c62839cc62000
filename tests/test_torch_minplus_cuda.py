"""The port's CUDA min-plus kernels on the card, against their plain
versions: the DP sweep, the chain tile (the sweep from a carry-in, one
lane or a batch of lanes), the one-slot kernel (A) and the plateau tile
(B, one launch per plateau tile); the tiled route's tables on the card
(left-to-right prefix sums, a tile against the whole horizon) against the
CPU's; and both decision routes and the batched arrival path on the card
against the CPU.

Needs a CUDA device (marker ``cuda``) and nothing of JAX, so it also runs
on a machine that has the card but no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_minplus_cuda.py

Min-plus has no multiply, so each kernel must equal its plain version bit
for bit, in cost and in the first-index split or argmin, in float32 and
float64, in every launch plan it can take (the sweep: every cluster
size).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import schedule_torch
from repro_torch.core.schedule_torch import _shape_bucket
from repro_torch.kernels.minplus import kernel, ops
from repro_torch.kernels.minplus.kernel import (minplus_cuda,
                                                minplus_dnc_cuda,
                                                minplus_plateau_cuda,
                                                minplus_sweep_cuda)
from repro_torch.kernels.minplus.monotone import (convex_certificate,
                                                  plateau_step, run_count)
from repro_torch.kernels.minplus.ref import minplus_ref, minplus_sweep_ref
from repro_torch.kernels.minplus.tiled import minplus_tile
from repro_torch.sim import engine, workload

# tests/test_kernels.py's sweep shapes, the slice's (m_pad, d1) buckets,
# the widest 10x-instance sweep, and the wide unquantized jobs' d1 with
# the narrowest band and the widest of the T=100 and the 10x traces
SHAPES = [(3, 2, 6), (9, 17, 33), (16, 65, 300), (8, 64, 1280),
          (4, 640, 1280), (500, 640, 1280), (100, 64, 20480),
          (100, 2688, 20480), (100, 8960, 20480)]
# the slot kernels' shapes: the tests', the 10x buckets, the wide jobs'
SLOT_SHAPES = [(1, 1), (2, 5), (17, 129), (65, 1281), (641, 1281),
               (64, 1280), (640, 1280), (64, 20480), (2688, 20480),
               (8960, 20480)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    view = torch.int32 if a.dtype == torch.float32 else torch.int64
    return torch.equal(a.view(view), b.view(view))      # +inf too


def _row_prev(dc1, d1, dtype, runs=None):
    """A seeded row (``runs`` runs of equal values, else random with +inf
    cells) and carry on the card."""
    rng = np.random.default_rng(dc1 * 7 + d1 + (runs or 0))
    if runs is None:
        row = rng.random(dc1)
        row[rng.random(dc1) < 0.3] = np.inf
    else:
        vals = np.concatenate([[0.0], rng.random(runs - 1) + 0.5])
        cuts = np.sort(rng.choice(np.arange(1, dc1), runs - 1,
                                  replace=False))
        row = np.repeat(vals, np.diff(np.concatenate([[0], cuts, [dc1]])))
    row[0] = 0.0
    prev = rng.random(d1)
    prev[rng.random(d1) < 0.3] = np.inf
    prev[0] = 0.0
    return (torch.tensor(row, dtype=dtype, device="cuda"),
            torch.tensor(prev, dtype=dtype, device="cuda"))


def _rows(T, dc1, d1, inf_frac):
    rng = np.random.default_rng(T * d1 + dc1)
    rows = rng.random((T, dc1))
    rows[rng.random((T, dc1)) < inf_frac] = np.inf
    rows[:, 0] = 0.0
    return rows


def _stair_rows(T, dc1, d1):
    """COST-row stand-ins: non-decreasing staircases of a few runs on a
    grid of quarters, so candidates tie exactly across blocks and j
    groups; +inf past a feasible prefix, 0 (of either sign) at column 0
    and in the first run."""
    rng = np.random.default_rng(T * d1 + dc1 + 1)
    rows = np.empty((T, dc1))
    for t in range(T):
        runs = int(rng.integers(1, min(dc1, 8) + 1))
        cuts = np.sort(rng.choice(np.arange(1, dc1), runs - 1,
                                  replace=False)) if runs > 1 else \
            np.zeros(0, np.int64)
        vals = np.cumsum(rng.integers(0, 3, runs)) / 4.0
        rows[t] = np.repeat(vals, np.diff(np.concatenate([[0], cuts,
                                                          [dc1]])))
        rows[t, int(rng.integers(dc1 // 2, dc1 + 1)):] = np.inf
    rows[:, 0] = 0.0
    rows[rows == 0] = np.where(rng.random(T) < 0.5, -0.0, 0.0)[
        np.nonzero(rows == 0)[0]]          # zeros of both signs
    return rows


def _sweep_equals_plain(rows, d1, plan=None):
    cost, split = minplus_sweep_cuda(rows, d1 - 1, plan=plan)
    cost_only, none = minplus_sweep_cuda(rows, d1 - 1, want_split=False,
                                         plan=plan)
    ref_cost, ref_split = minplus_sweep_ref(rows, d1 - 1)
    torch.cuda.synchronize()
    assert none is None and split.dtype == torch.int32
    assert _bits(cost, ref_cost) and torch.equal(split, ref_split)
    assert _bits(cost_only, ref_cost)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("T,dc1,d1", SHAPES)
def test_cuda_kernel_equals_plain_version(card, T, dc1, d1, dtype):
    """Bitwise, cost and split, on random rows with +inf cells and on
    staircase rows full of ties."""
    for rows in (_rows(T, dc1, d1, 0.4), _stair_rows(T, dc1, d1)):
        _sweep_equals_plain(torch.tensor(rows, dtype=dtype, device="cuda"),
                            d1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cluster", kernel.SWEEP_CLUSTERS)
def test_cuda_sweep_every_cluster_size(card, cluster, dtype):
    """Every cluster size the plan can choose, reached through its shape:
    d1 = 64 C columns take C blocks, and a band of 0.6 d1 reaches over the
    halo of up to 10 lower ranks, with the j range split: bitwise, ties
    and zeros of both signs included."""
    T, dc1, d1 = 7, max(2, 64 * cluster * 3 // 5), 64 * cluster
    assert kernel.sweep_plan(dc1, d1, dtype).cluster == cluster
    for rows in (_rows(T, dc1, d1, 0.4), _stair_rows(T, dc1, d1)):
        _sweep_equals_plain(torch.tensor(rows, dtype=dtype, device="cuda"),
                            d1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dc1,d1", SLOT_SHAPES)
def test_cuda_slot_kernel_equals_plain_version(card, dc1, d1, dtype):
    row, prev = _row_prev(dc1, d1, dtype)
    new, arg = minplus_cuda(row, prev)
    cost_only, none = minplus_cuda(row, prev, want_arg=False)
    unstaged, _ = minplus_cuda(row, prev, staged=False)
    ref_new, ref_arg = minplus_ref(row, prev)
    torch.cuda.synchronize()
    assert none is None and arg.dtype == torch.int32
    assert _bits(new, ref_new) and torch.equal(arg, ref_arg)
    assert _bits(cost_only, ref_new) and _bits(unstaged, ref_new)


def _plateau_rows(n, dc1, d1, dtype, runs):
    """``n`` seeded rows of exactly ``runs`` runs of equal values each (0
    first, the last run +inf in every other row), on the card."""
    rng = np.random.default_rng(dc1 * 7 + d1 + runs)
    rows = np.empty((n, dc1))
    for t in range(n):
        vals = np.concatenate([[0.0], rng.random(runs - 1) + 0.5])
        if t % 2 and runs > 1:
            vals[-1] = np.inf
        cuts = np.sort(rng.choice(np.arange(1, dc1), runs - 1,
                                  replace=False))
        rows[t] = np.repeat(vals, np.diff(np.concatenate([[0], cuts,
                                                          [dc1]])))
    return torch.tensor(rows, dtype=dtype, device="cuda")


def _plain_plateau_tile(rows, prev):
    cols = []
    for row in rows:
        prev = plateau_step(row, prev)
        cols.append(prev)
    return torch.stack(cols)


def _plateau_tiles_equal_plain(dc1, d1, dtype, plans, r_max=16):
    """chip_smoke's tile check: rows of 1, r_max - 1, r_max and 3 r_max
    runs, tiles of 1, 17 and 64 slots from the identity and from a real
    DP column, each plan: one launch into rows [2, n+2) of a NaN-filled
    table, bitwise the plain tile and the chain, every other row
    untouched."""
    carry = _dp_carry(dc1, d1, dtype, 3)
    for runs in sorted({min(r, dc1) for r in (1, r_max - 1, r_max,
                                              3 * r_max)}):
        rows = _plateau_rows(64, dc1, d1, dtype, runs)
        assert bool((run_count(rows) == runs).all())
        for prev in (_identity(d1, dtype), carry):
            want = _plain_plateau_tile(rows, prev)
            chain, _ = minplus_sweep_cuda(rows, d1 - 1, prev=prev)
            for n in (1, 17, 64):
                for plan in plans:
                    table = torch.full((n + 4, d1), float("nan"),
                                       dtype=dtype, device="cuda")
                    before = minplus_plateau_cuda.launches
                    got = minplus_plateau_cuda(rows[:n], prev, r_max=r_max,
                                               out=table[2:n + 2], plan=plan)
                    torch.cuda.synchronize()
                    assert minplus_plateau_cuda.launches == before + 1
                    assert got.data_ptr() == table[2].data_ptr()
                    assert _bits(table[2:n + 2], want[:n]), (runs, n, plan)
                    assert _bits(table[2:n + 2], chain[:n]), (runs, n, plan)
                    assert torch.isnan(table[:2]).all()
                    assert torch.isnan(table[n + 2:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dc1,d1", SLOT_SHAPES)
def test_cuda_plateau_kernel_equals_plain_version(card, dc1, d1, dtype):
    """The plateau tile under the planned table placement and the global
    one, against the plain tile and the chain (chip_smoke's tile check);
    one row through ``ops.minplus_monotone``, the one-slot entry."""
    plans = {kernel.plateau_plan(dc1, d1, dtype, 16),
             kernel.plateau_plan(dc1, d1, dtype, 16, table_shared=False)}
    _plateau_tiles_equal_plain(dc1, d1, dtype, plans)
    row, prev = _row_prev(dc1, d1, dtype, runs=min(16, dc1))
    got = ops.minplus_monotone(row, prev)
    torch.cuda.synchronize()
    assert _bits(got, plateau_step(row, prev))
    assert _bits(got, minplus_ref(row, prev)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("table_shared", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cluster", kernel.SWEEP_CLUSTERS)
def test_cuda_plateau_tile_every_plan(card, cluster, dtype, table_shared):
    """Every plan the planner can give: each cluster size, reached through
    d1 = 64 C columns (the route's band of 64, cut to d1), with the table
    in shared memory and in global scratch."""
    d1 = 64 * cluster
    dc1 = min(64, d1)
    plan = kernel.plateau_plan(dc1, d1, dtype, 16, table_shared=table_shared)
    assert plan.cluster == cluster and plan.table_shared == table_shared
    _plateau_tiles_equal_plain(dc1, d1, dtype, [plan])


def _dp_carry(dc1, d1, dtype, seed, slots=5):
    """A real DP column on the card: the sweep's last column after
    ``slots`` seeded slots from the identity, as one tile hands the next."""
    rows = _rows(slots, dc1, d1, 0.3)
    rows = np.round(rows * 8) / 8 + seed % 3
    rows[:, 0] = 0.0
    return minplus_sweep_ref(torch.tensor(rows, dtype=dtype, device="cuda"),
                             d1 - 1)[0][-1].contiguous()


def _identity(d1, dtype):
    prev = torch.full((d1,), float("inf"), dtype=dtype, device="cuda")
    prev[0] = 0.0
    return prev


def _tile_equals_plain(rows, prev):
    """One tile launch into rows [2, n+2) of a NaN-filled table: bitwise
    the plain tile's columns, every other row untouched."""
    n, d1 = rows.shape[0], prev.numel()
    table = torch.full((n + 4, d1), float("nan"), dtype=prev.dtype,
                       device="cuda")
    before = minplus_sweep_cuda.launches
    got, split = minplus_sweep_cuda(rows, d1 - 1, prev=prev,
                                    out=table[2:n + 2])
    want = minplus_tile(rows[:, None, :], prev[None])[1][:, 0]
    torch.cuda.synchronize()
    assert minplus_sweep_cuda.launches == before + 1 and split is None
    assert got.data_ptr() == table[2].data_ptr()
    assert _bits(table[2:n + 2], want)
    assert torch.isnan(table[:2]).all() and torch.isnan(table[n + 2:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 17, 64])
@pytest.mark.parametrize("dc1", [64, 128, 256, 384, 512, 640])
def test_cuda_tile_equals_minplus_tile(card, dc1, n, dtype):
    """At each 10x bucket (d1 = 1280), tiles of 1, 17 and 64 slots from
    the identity and from a real DP column: bitwise ``minplus_tile``, on
    random rows with +inf cells and on staircase rows full of ties."""
    d1 = 1280
    for rows in (_rows(n, dc1, d1, 0.4), _stair_rows(n, dc1, d1)):
        rows = torch.tensor(rows, dtype=dtype, device="cuda")
        for prev in (_identity(d1, dtype), _dp_carry(dc1, d1, dtype, n)):
            _tile_equals_plain(rows, prev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cluster", [4, 8, 16])
@pytest.mark.parametrize("dc1", [64, 640])
def test_cuda_tile_every_cluster_size(card, dc1, cluster, dtype):
    """64-slot tiles under clusters of 4, 8 and 16 blocks, reached
    through d1 = 64 C columns, with the narrowest and the widest 10x band
    (cut to d1): bitwise ``minplus_tile``."""
    d1 = 64 * cluster
    dc1 = min(dc1, d1)
    assert kernel.sweep_plan(dc1, d1, dtype).cluster == cluster
    rows = torch.tensor(_rows(64, dc1, d1, 0.4), dtype=dtype, device="cuda")
    _tile_equals_plain(rows, _dp_carry(dc1, d1, dtype, cluster))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dc1", [64, 2688, 8960])
def test_cuda_tile_wide_shapes(card, dc1, dtype):
    """The wide jobs' d1 = 20480 with the narrowest band and the widest of
    the T=100 and the 10x traces: three slots from a real DP column."""
    d1 = 20480
    rows = torch.tensor(_rows(3, dc1, d1, 0.4), dtype=dtype, device="cuda")
    _tile_equals_plain(rows, _dp_carry(dc1, d1, dtype, 2, slots=2))


def _lanes_equal_plain(B, n, dc1, d1, dtype, seed):
    """One launch over B lanes, each a view into a larger table (rows,
    carries and outputs at lane strides): bitwise the plain tile lane by
    lane and B one-lane launches; the table's other rows untouched."""
    rng = np.random.default_rng(seed)
    rows = np.round(rng.random((B, n + 4, dc1)) * 8) / 8
    rows[rng.random(rows.shape) < 0.3] = np.inf
    rows[..., 0] = 0.0
    rows = torch.tensor(rows, dtype=dtype, device="cuda")[:, 2:n + 2]
    carries = torch.stack([_dp_carry(dc1, d1, dtype, seed + b)
                           for b in range(B)])
    table = torch.full((B, n + 5, d1), float("nan"), dtype=dtype,
                       device="cuda")
    table[:, 0] = carries
    before = minplus_sweep_cuda.launches
    ops.minplus_chain(rows, table[:, 0], table[:, 3:n + 3])
    assert minplus_sweep_cuda.launches == before + 1
    for b in range(B):
        want = minplus_tile(rows[b][:, None, :], carries[b][None])[1][:, 0]
        one = torch.empty((n, d1), dtype=dtype, device="cuda")
        minplus_sweep_cuda(rows[b].contiguous(), d1 - 1, prev=carries[b],
                           out=one)
        torch.cuda.synchronize()
        assert _bits(table[b, 3:n + 3], want), b
        assert _bits(one, want), b
    assert torch.isnan(table[:, 1:3]).all()
    assert torch.isnan(table[:, n + 3:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("B", [2, 8])
def test_cuda_tile_lanes_every_cluster_size(card, B, cluster, dtype):
    """B lanes under every cluster size (d1 = 64 C): one cluster per
    lane, bitwise the plain tile and one-lane launches."""
    d1 = 64 * cluster
    dc1 = min(64, d1)
    assert kernel.sweep_plan(dc1, d1, dtype).cluster == cluster
    _lanes_equal_plain(B, 64, dc1, d1, dtype, cluster + B)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dc1", [64, 128, 256, 384, 512, 640])
def test_cuda_tile_lanes_at_10x_buckets(card, dc1, dtype):
    """Eight lanes (the burst's lanes at REPRO_BURST_LANES=8) at each 10x
    bucket, 64 and 17 slots."""
    for n in (64, 17):
        _lanes_equal_plain(8, n, dc1, 1280, dtype, dc1 + n)


@pytest.mark.cuda
def test_cuda_tile_lanes_refuse_bad_layouts(card):
    rows = torch.zeros((2, 4, 64), dtype=torch.float64, device="cuda")
    prev = torch.zeros((2, 128), dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError, match="carry"):
        minplus_sweep_cuda(rows, 127)
    with pytest.raises(ValueError, match="prev"):
        minplus_sweep_cuda(rows, 127, prev=prev[:1])
    with pytest.raises(ValueError, match="contiguous"):
        minplus_sweep_cuda(rows.transpose(1, 2).contiguous()
                           .transpose(1, 2), 127, prev=prev)
    with pytest.raises(ValueError, match="overlap"):
        minplus_sweep_cuda(rows, 127, prev=prev,
                           out=torch.empty((4, 128), dtype=torch.float64,
                                           device="cuda").expand(2, 4, 128))
    with pytest.raises(ValueError, match="overlap"):
        minplus_sweep_cuda(rows, 127, prev=prev,
                           out=torch.empty(4 * 128 + 128,
                                           dtype=torch.float64,
                                           device="cuda").as_strided(
                                               (2, 4, 128), (128, 128, 1)))
    with pytest.raises(ValueError, match="overlap"):
        minplus_sweep_cuda(rows[:1].expand(2, 4, 64), 127, prev=prev)


def _tables_state(T, H, K, n_commits, seed):
    """Price states on the card and the CPU after the same seeded commits
    of the 10x trace's jobs (each decided on the CPU), with a job whose
    tables are compared."""
    from repro_torch.core.pricing import PriceState, price_params_from_jobs
    cluster = workload.make_cluster(T=T, H=H, K=K)
    jobs = [engine._with_quantum(j, 0)
            for j in workload.make_jobs(40, T=T, seed=seed)]
    params = price_params_from_jobs(jobs, cluster)
    gpu = PriceState(cluster, params)
    cpu = PriceState(cluster, params, device="cpu")
    versions = []
    for job in sorted(jobs, key=lambda j: j.arrival)[:n_commits]:
        sched = schedule_torch.best_schedule_fused(job, cpu, core="tiled")
        if sched is not None:
            versions.append(gpu.version)
            gpu.device_state()
            for st_ in (gpu, cpu):
                st_.commit(job, sched.workers, sched.ps)
    return gpu, cpu, jobs, versions


@pytest.mark.cuda
@pytest.mark.parametrize("T,H,K", [(100, 50, 50), (500, 100, 100)])
def test_cuda_tables_equal_cpu_and_tiles_equal_full(card, T, H, K):
    """At paper scale and at 10x: the card's resident prices, its padded
    state, a job's prefix tables over each tile and its tiles' COST rows
    equal the same slots of a whole-horizon build on the card and the
    CPU's, bit for bit (the prices come from the host; every prefix sum
    runs left to right on both devices, over one tile's slots as over the
    whole horizon)."""
    gpu, cpu, jobs, versions = _tables_state(T, H, K, 12, 0)
    assert len(versions) >= 2
    T_pad = schedule_torch._pad_tiles(T)
    for a, b in zip(gpu.device_prices(), cpu.device_prices()):
        assert torch.equal(a.cpu(), b)
    psd = schedule_torch._padded_state(gpu, torch.float64, T_pad)
    full = schedule_torch._pad_state(gpu.device_state(),
                                     gpu.device_prices(), T_pad)
    psd_cpu = schedule_torch._padded_state(cpu, torch.float64, T_pad)
    for k, w in zip((0, 1, 8, 9, 10), full):
        assert torch.equal(psd[0][k], w), k
        assert torch.equal(psd[0][k].cpu(), psd_cpu[0][k]), k
    job = max(jobs, key=lambda j: j.worker_res.sum())
    m_pad, _ = _shape_bucket(job)
    lane, _ = schedule_torch._job_arrays_tiled(job, T, T_pad, m_pad)
    jd = schedule_torch._stack_lanes([lane], T, torch.float64, gpu.device)
    jd_cpu = schedule_torch._stack_lanes([lane], T, torch.float64,
                                         cpu.device)
    g, v, wcaps, scaps = psd[0][:4]
    R = schedule_torch.R
    whole = (schedule_torch._prefix_tables_b(psd[0][9], wcaps[None] - g,
                                             jd.resbw[:, :R])
             + schedule_torch._prefix_tables_b(psd[0][10], scaps[None] - v,
                                               jd.resbw[:, R:2 * R]))
    for t0 in range(0, T_pad, 64):
        sl = slice(t0, t0 + 64)
        tile = (schedule_torch._prefix_tables_b(
                    psd[0][9][sl], wcaps[None] - g[sl], jd.resbw[:, :R])
                + schedule_torch._prefix_tables_b(
                    psd[0][10][sl], scaps[None] - v[sl], jd.resbw[:, R:2 * R]))
        for a, b in zip(tile, whole):
            assert torch.equal(a, b[:, sl]), t0
        rows = schedule_torch._tile_rows(psd[0], jd, t0)
        assert torch.equal(rows.cpu(), schedule_torch._tile_rows(
            psd_cpu[0], jd_cpu, t0))


@pytest.mark.cuda
def test_cuda_float32_rows_equal_cpu(card):
    """The float32 route's tables at 10x: the padded state and every
    tile's COST rows on the card equal the CPU's bit for bit.  The CPU's
    float32 ``cumsum`` adds in float64 and CUDA's in float32, so
    ``_prefix_sums`` adds a float32 pair in float64 on both devices."""
    gpu, cpu, jobs, _ = _tables_state(500, 100, 100, 12, 0)
    T_pad = schedule_torch._pad_tiles(500)
    psd = schedule_torch._padded_state(gpu, torch.float32, T_pad)
    psd_cpu = schedule_torch._padded_state(cpu, torch.float32, T_pad)
    for a, b in zip(psd[0], psd_cpu[0]):
        assert a.dtype == torch.float32 and torch.equal(a.cpu(), b)
    for job in [j for j in jobs if _shape_bucket(j)][:4]:
        m_pad, _ = _shape_bucket(job)
        lane, _ = schedule_torch._job_arrays_tiled(job, 500, T_pad, m_pad)
        jd, jd_cpu = (schedule_torch._stack_lanes([lane], 500, torch.float32,
                                                  dev)
                      for dev in (gpu.device, cpu.device))
        for t0 in range(0, T_pad, 64):
            rows = schedule_torch._tile_rows(psd[0], jd, t0)
            assert torch.equal(rows.cpu(), schedule_torch._tile_rows(
                psd_cpu[0], jd_cpu, t0)), t0


@pytest.mark.cuda
def test_burst_lanes_on_card_equal_cpu(card, monkeypatch):
    """The batched arrival path at paper scale on the card, one lane and
    eight lanes a launch, equals the CPU's (one lane): completions and
    utility, and each burst's launches step one sweep or plateau launch
    per tile."""
    cluster = workload.make_cluster(T=100, H=50, K=50)
    jobs = workload.make_jobs(200, T=100, seed=0, small=True)
    cpu = engine.run(cluster, jobs, quantum=0, core="tiled", device="cpu")
    for lanes in ("1", "8"):
        monkeypatch.setenv("REPRO_BURST_LANES", lanes)
        before = (minplus_plateau_cuda.launches, minplus_sweep_cuda.launches)
        schedule_torch.monotone_counters_reset()
        gpu = engine.run(cluster, jobs, quantum=0, core="tiled")
        snap = schedule_torch.monotone_counters_snapshot()
        plateau, tile = (x - y for x, y in zip(
            (minplus_plateau_cuda.launches, minplus_sweep_cuda.launches),
            before))
        assert gpu.completion == cpu.completion, lanes
        assert gpu.total_utility == cpu.total_utility, lanes
        assert tile == snap["chain"] and plateau == snap["plateau"]
        assert snap["speculative"] > 0 and snap["resolves"] > 0
        if lanes == "8":
            assert snap["launches"] < snap["decisions"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_sweep_null_carry_unchanged(card, dtype):
    """The whole route's sweep passes no carry: it equals the plain sweep
    and a tile launched from the identity column, bit for bit, and a
    carry-in launch refuses a mismatched ``out`` on the card."""
    T, dc1, d1 = 500, 256, 1280
    rows = torch.tensor(_rows(T, dc1, d1, 0.4), dtype=dtype, device="cuda")
    cost, _ = minplus_sweep_cuda(rows, d1 - 1, want_split=False)
    tile, _ = minplus_sweep_cuda(rows, d1 - 1, prev=_identity(d1, dtype))
    ref_cost, _ = minplus_sweep_ref(rows, d1 - 1)
    torch.cuda.synchronize()
    assert _bits(cost, ref_cost) and _bits(tile, ref_cost)
    with pytest.raises(ValueError, match="out"):
        minplus_sweep_cuda(rows, d1 - 1, prev=_identity(d1, dtype),
                           out=torch.empty((T - 1, d1), dtype=dtype,
                                           device="cuda"))


@pytest.mark.cuda
def test_tiled_route_on_card_equals_cpu_one_launch_per_tile(card):
    """The tiled route on the card: one tile launch per chain tile and one
    plateau launch per plateau tile (every visited tile has live slots),
    and no one-slot launch; the same trajectory as on the CPU."""
    cluster = workload.make_cluster(T=100, H=20, K=20)
    jobs = workload.make_jobs(40, T=100, seed=1)
    before = (minplus_cuda.launches, minplus_plateau_cuda.launches,
              minplus_sweep_cuda.launches)
    schedule_torch.monotone_counters_reset()
    gpu = engine.run(cluster, jobs, quantum=0, core="tiled")
    snap = schedule_torch.monotone_counters_snapshot()
    slot, plateau, tile = (x - y for x, y in zip(
        (minplus_cuda.launches, minplus_plateau_cuda.launches,
         minplus_sweep_cuda.launches), before))
    assert slot == 0
    assert tile == snap["chain"] > 0
    assert plateau == snap["plateau"] > 0
    assert snap["plateau_slots"] > snap["plateau"]
    assert snap["slots"] > snap["plateau_slots"]
    cpu = engine.run(cluster, jobs, quantum=0, core="tiled", device="cpu")
    assert gpu.completion == cpu.completion
    assert gpu.total_utility == pytest.approx(cpu.total_utility, rel=1e-9)


@pytest.mark.cuda
def test_wide_jobs_run_through_both_routes(card):
    """Unquantized full-size jobs (d1 up to 20480) are decided on the card
    by both routes as by the port on the CPU: the same completions and
    the utility within rel 1e-9.  The whole route's exact first-index
    split meets any last-ulp difference of the COST rows, so its
    completions hold only because the card reads the CPU's prices and
    sums left to right."""
    cluster = workload.make_cluster(T=100, H=20, K=20)
    jobs = workload.make_jobs(40, T=100, seed=1)
    assert any(_shape_bucket(j)[1] == 20480 for j in jobs)
    for core in ("whole", "tiled"):
        before = minplus_plateau_cuda.launches
        schedule_torch.monotone_counters_reset()
        res = engine.run(cluster, jobs, core=core, check=True)
        snap = schedule_torch.monotone_counters_snapshot()
        plateau = minplus_plateau_cuda.launches - before
        print(f"{core} route: accepted {res.accepted}, utility "
              f"{res.total_utility!r}, plateau launches {plateau}")
        assert plateau == (snap["plateau"] if core == "tiled" else 0)
        cpu = engine.run(cluster, jobs, core=core, device="cpu")
        assert res.accepted > 0
        assert set(res.completion) == set(cpu.completion)
        assert res.total_utility == pytest.approx(cpu.total_utility,
                                                  rel=1e-9)
        assert res.completion == cpu.completion, core


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


def _churn_cases():
    """(label, driver call) pairs: the churn and stream parity instances
    of the CPU tests (tests/test_torch_fleet.py, test_torch_stream.py)."""
    import itertools

    from repro_torch.sim import fleet

    c60 = workload.make_cluster(T=60, H=12, K=12)
    jobs60 = workload.make_jobs(30, T=60, seed=0)
    tr60 = fleet.churn_trace(c60, frac=0.25, seed=2)
    cancel = {j.jid: j.arrival + 3 for j in jobs60[::4]}
    c32 = workload.make_cluster(T=32, H=8, K=8)
    tr32 = fleet.churn_trace(c32, frac=0.25, seed=2, T=200)

    def stream(**kw):
        return lambda core, device: engine.run_stream(
            c32, itertools.islice(workload.stream_jobs(rate=0.2, seed=0), 30),
            window=32, quantum=0, check=True, core=core, device=device, **kw)

    return {
        "episodic churn": lambda core, device: engine.run(
            c60, jobs60, quantum=0, check=True, fleet=tr60, core=core,
            device=device),
        "episodic churn and cancellations": lambda core, device: engine.run(
            c60, jobs60, quantum=0, check=True, fleet=tr60,
            cancellations=cancel, core=core, device=device),
        "stream": stream(),
        "stream churn": stream(fleet=tr32),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("core", ["whole", "tiled"])
@pytest.mark.parametrize("case", ["episodic churn",
                                  "episodic churn and cancellations",
                                  "stream", "stream churn"])
def test_churn_and_stream_on_card_equal_cpu(card, case, core):
    """Server blocking, preemption, cancellations and the rolling window
    on the card decide as the port on the CPU: the whole route exactly,
    the tiled route with the same completions and its utility within rel
    1e-9; one upload per run, every DP decision through the kernels."""
    run = _churn_cases()[case]
    before = (minplus_cuda.launches, minplus_plateau_cuda.launches,
              minplus_sweep_cuda.launches)
    schedule_torch.monotone_counters_reset()
    gpu = run(core, None)
    snap = schedule_torch.monotone_counters_snapshot()
    slot, plateau, sweep = (x - y for x, y in zip(
        (minplus_cuda.launches, minplus_plateau_cuda.launches,
         minplus_sweep_cuda.launches), before))
    cpu = run(core, "cpu")
    assert slot == 0 and sweep > 0
    if core == "tiled":
        assert (sweep, plateau) == (snap["chain"], snap["plateau"])
    else:
        assert plateau == 0 and sweep <= len(gpu.decision_seconds)
    assert gpu.device_uploads == 1
    assert gpu.completion == cpu.completion
    assert (gpu.accepted, gpu.preempted, gpu.preempt_dropped,
            gpu.canceled, gpu.window_bytes) == (
        cpu.accepted, cpu.preempted, cpu.preempt_dropped, cpu.canceled,
        cpu.window_bytes)
    if core == "whole":
        assert gpu.total_utility == cpu.total_utility
        assert gpu.utilization == cpu.utilization
    else:
        assert gpu.total_utility == pytest.approx(cpu.total_utility,
                                                  rel=1e-9)


@pytest.mark.cuda
def test_window_slide_and_blocks_on_card_equal_cpu(card):
    """The residency on the card after commits, server blocks, slides and
    unblocks: all five tables equal the CPU residency's bit for bit, with
    one upload each."""
    from repro_torch.core.pricing import PriceState, price_params_from_jobs
    from repro_torch.core.schedule_torch import best_schedule_fused

    cluster = workload.make_cluster(T=64, H=12, K=12)
    jobs = workload.make_jobs(20, T=64, seed=3)
    params = price_params_from_jobs(jobs, cluster)
    states = [PriceState(cluster, params, device=d, window=64)
              for d in ("cuda", "cpu")]
    for st in states:
        st.device_state()
    down = {7: [("worker", 2), ("ps", 1)], 14: []}
    blocked = []
    for i, job in enumerate(jobs):
        job = engine._with_quantum(job, 0)
        s = best_schedule_fused(job, states[1])
        for st in states:
            if s is not None:
                st.commit(job, s.workers, s.ps)
            if i % 5 == 4:
                # a slide, then the engine's re-block of the opened slots
                st.advance(st.origin + 3 + i)
                for pool, srv in blocked:
                    st.block_server(pool, srv, 0)
        if i in down:
            for st in states:
                for pool, srv in blocked:
                    st.unblock_server(pool, srv, 0)
                for pool, srv in down[i]:
                    st.block_server(pool, srv, 0)
            blocked = down[i]
    for a, b in zip(states[0]._dev, states[1]._dev):
        assert _bits(a.cpu(), b)
    assert [st.device_uploads for st in states] == [1, 1]


def _convex_rows(n, dc1, d1, dtype, seed):
    """Seeded certified-convex rows on the card (increasing increments
    with ties, +inf suffixes in every third row, a linear row, an
    identity row) and a carry with +inf cells."""
    rng = np.random.default_rng(seed)
    rows = np.empty((n, dc1))
    for i in range(n):
        inc = np.round(np.sort(rng.random(dc1 - 1)) * 4) / 4.0
        rows[i] = np.concatenate([[0.0], np.cumsum(inc)])
        if i % 3 == 2:
            rows[i, max(dc1 // 2, 1):] = np.inf
    rows[min(1, n - 1)] = np.arange(dc1)
    rows[-1, 1:] = np.inf
    prev = rng.random(d1)
    prev[rng.random(d1) < 0.3] = np.inf
    prev[0] = 0.0
    return (torch.tensor(rows, dtype=dtype, device="cuda"),
            torch.tensor(prev, dtype=dtype, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dc1,d1", [(5, 33), (17, 129), (64, 129),
                                    (64, 1280), (1, 7), (64, 20480)])
def test_cuda_dnc_kernel_equals_plain_version(card, dc1, d1, dtype):
    """The D&C tile (``minplus_dnc_cuda``, one launch) under the planned
    placement and the global one against the plain step chained and the
    chain tile, bit for bit, written at a row offset of a larger table;
    ``ops.minplus_dnc_tile`` and one row through ``ops.minplus_monotone``
    (the one-slot entry)."""
    rows, prev = _convex_rows(17, dc1, d1, dtype, seed=dc1 * d1)
    assert bool(convex_certificate(rows).all())
    want = minplus_tile(rows[:, None, :], prev[None])[1][:, 0]
    # the plain version: monotone_dnc_step chained on the host (a slot
    # whose candidate buffer spills, the tied row's, takes the chain)
    plain = ops.minplus_dnc_tile(rows.cpu(), prev.cpu(),
                                 torch.empty((17, d1), dtype=dtype))
    assert _bits(plain.cuda(), want)
    plans = {kernel.dnc_plan(dc1, d1, dtype),
             kernel.DncPlan(kernel.DNC_THREADS, False, kernel._dnc_smem(
                 dc1, d1, dtype.itemsize, kernel.DNC_THREADS, False))}
    for plan in plans:
        out = torch.full((19, d1), float("nan"), dtype=dtype, device="cuda")
        before = minplus_dnc_cuda.launches
        minplus_dnc_cuda(rows, prev, out=out[1:18], plan=plan)
        torch.cuda.synchronize()
        assert minplus_dnc_cuda.launches == before + 1
        assert _bits(out[1:18], want), plan
        assert out[0].isnan().all() and out[18].isnan().all()
    out = torch.empty((17, d1), dtype=dtype, device="cuda")
    ops.minplus_dnc_tile(rows, prev, out)
    assert _bits(out, want)
    got = ops.minplus_monotone(rows[0], prev)
    assert _bits(got, want[0])

"""The port's one-slot min-plus kernels' plain versions against the JAX
package, and the sweep's launch plan.

* Kernel A (``minplus_cuda``, replacing ``minplus_pallas``): its plain
  version ``ref.minplus_ref`` must equal the Pallas kernel (interpret
  mode) and the reference ``minplus_ref`` in float32 bit for bit in cost
  and exactly in the first-index argmin — min-plus has no multiply, so
  there is no rounding to disagree on.  In float64 a chain of slots must
  equal the port's whole-horizon sweep row by row.
* Kernel B (``minplus_plateau_cuda``, replacing
  ``minplus_plateau_pallas``; one launch per plateau tile, whose plain
  tile ``tests/test_torch_plateau_tile.py`` holds): its plain version
  ``monotone.plateau_step`` must equal the Pallas kernel and the
  reference ``plateau_step`` bit for bit in float32, for every run count
  up to ``r_max`` and with +inf runs; ``ops.minplus_monotone`` must equal
  ``ops.minplus``'s cost on every row kind of ``tests/test_monotone.py``.
* The tiled building blocks equal the reference's, and the chain tile
  (``minplus_sweep_cuda`` from a carry-in, replacing ``minplus_pallas``
  on the tiled route): its plain version ``tiled.minplus_tile`` from a
  carry that is not the identity equals the per-slot chain step and the
  reference's ``minplus_tile`` bit for bit, its launch plan
  (``sweep_plan``) takes every trace bucket at every tile length, and
  the kernel's decomposition replayed from a carry-in equals it under
  every cluster size a tile can take.
* ``sweep_plan`` takes every (m_pad, d1) shape bucket of the repo's
  unquantized traces: the sweep refuses no shape the reference decides.
  A numpy replay of the CUDA sweep's decomposition (the cluster's carry
  slices, the halo each block copies, the j split and the (value, j)
  merge) equals the plain sweep bit for bit under every cluster size.

The kernels themselves are held to these plain versions on the card
(``tests/test_torch_minplus_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_shims  # noqa: F401  (fixture)
from repro.kernels.minplus import monotone as jax_monotone
from repro.kernels.minplus import tiled as jax_tiled
from repro.kernels.minplus.kernel import minplus_pallas, minplus_plateau_pallas
from repro.kernels.minplus.ref import minplus_ref as jax_minplus_ref
from repro_torch.core.schedule_torch import _shape_bucket
from repro_torch.kernels.minplus import kernel, monotone, ops, tiled
from repro_torch.kernels.minplus.ref import minplus_ref, minplus_sweep_ref
from repro_torch.sim import engine, workload

# tests/test_kernels.py's (d1, dc1) shapes as (dc1, d1), plus the slice's
SLOT_SHAPES = [(2, 5), (8, 64), (17, 129), (100, 1000), (257, 4097),
               (1, 1), (65, 1281), (641, 1281)]
KINDS = ["random", "convex", "stair", "inf_tail", "ties"]


def _row_prev(dc1, d1, inf_frac, seed, dtype=np.float32):
    """Seeded row and carry with +inf cells and exact ties (values on a
    grid of eighths)."""
    rng = np.random.default_rng(seed)
    row = np.round(rng.random(dc1) * 8) / 8
    prev = np.round(rng.random(d1) * 8) / 8
    row[rng.random(dc1) < inf_frac] = np.inf
    prev[rng.random(d1) < inf_frac] = np.inf
    row[0] = 0.0
    prev[0] = 0.0
    return row.astype(dtype), prev.astype(dtype)


def _mk_row(kind, rng, dc1, dtype):
    """tests/test_monotone.py's row kinds."""
    js = np.arange(dc1, dtype=np.float64)
    if kind == "random":
        row = rng.random(dc1)
    elif kind == "convex":
        row = js * (js - 1) / 2.0
    elif kind == "stair":
        row = np.resize(np.repeat(rng.random(max(dc1 // 8, 1)), 8), dc1)
    elif kind == "inf_tail":
        row = rng.random(dc1)
        row[int(dc1 * 0.6):] = np.inf
    else:
        row = np.round(rng.random(dc1) * 3) / 3.0
    row[0] = 0.0
    return row.astype(dtype)


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("dc1,d1", SLOT_SHAPES)
@pytest.mark.parametrize("inf_frac", [0.0, 0.3])
def test_slot_plain_equals_pallas_and_jax_ref_f32(dc1, d1, inf_frac):
    row, prev = _row_prev(dc1, d1, inf_frac, seed=dc1 * d1)
    new, arg = minplus_ref(torch.tensor(row), torch.tensor(prev))
    assert new.dtype == torch.float32 and arg.dtype == torch.int32
    p_new, p_arg = minplus_pallas(jnp.asarray(row), jnp.asarray(prev),
                                  interpret=True)
    r_new, r_arg = jax_minplus_ref(jnp.asarray(row), jnp.asarray(prev))
    assert _bits(new.numpy(), p_new) and _bits(new.numpy(), r_new)
    assert np.array_equal(arg.numpy(), np.asarray(p_arg))
    assert np.array_equal(arg.numpy(), np.asarray(r_arg))


@pytest.mark.parametrize("T,dc1,d1", [(9, 17, 33), (6, 65, 1281),
                                      (3, 641, 1281)])
def test_slot_chain_equals_sweep_f64(T, dc1, d1):
    """Slot after slot from the identity carry, the plain slot equals the
    whole-horizon sweep's cost and split rows, and the tiled chain step
    its cost."""
    rng = np.random.default_rng(T * dc1)
    rows = np.round(rng.random((T, dc1)) * 8) / 8
    rows[rng.random((T, dc1)) < 0.3] = np.inf
    rows[:, 0] = 0.0
    rows = torch.tensor(rows)
    cost, split = minplus_sweep_ref(rows, d1 - 1)
    prev = torch.full((d1,), float("inf"), dtype=torch.float64)
    prev[0] = 0.0
    for t in range(T):
        new, arg = minplus_ref(rows[t], prev)
        chain = tiled.minplus_chain_step(rows[t][None], prev[None])[0]
        assert _bits(new.numpy(), cost[t].numpy()), t
        assert _bits(chain.numpy(), cost[t].numpy()), t
        assert torch.equal(arg, split[t]), t
        prev = new


@pytest.mark.parametrize("dc1,d1", [(17, 33), (65, 129), (130, 200),
                                    (64, 1280)])
@pytest.mark.parametrize("n_runs", range(1, 17))
@pytest.mark.parametrize("inf_runs", [0, 1])
def test_plateau_plain_equals_pallas_and_jax_f32(dc1, d1, n_runs, inf_runs):
    rng = np.random.default_rng(dc1 + d1 + n_runs)
    # exactly n_runs runs: 0 first (COST_t of 0 passes), then distinct
    # values, the last run +inf when inf_runs
    vals = np.concatenate([[0.0], rng.permutation(n_runs - 1) / 4.0 + 0.25])
    if inf_runs and n_runs > 1:
        vals[-1] = np.inf
    cuts = np.sort(rng.choice(np.arange(1, dc1), n_runs - 1, replace=False))
    row = np.repeat(vals, np.diff(np.concatenate([[0], cuts, [dc1]]))
                    ).astype(np.float32)
    prev = (np.round(rng.random(d1) * 8) / 8).astype(np.float32)
    prev[rng.random(d1) < 0.3] = np.inf
    prev[0] = 0.0
    assert int(monotone.run_count_np(row)) == n_runs
    assert int(monotone.run_count(torch.tensor(row))) == n_runs == int(
        jax_monotone.run_count(jnp.asarray(row)))
    got = monotone.plateau_step(torch.tensor(row), torch.tensor(prev))
    pallas = minplus_plateau_pallas(jnp.asarray(row), jnp.asarray(prev),
                                    r_max=16, interpret=True)
    want = jax_monotone.plateau_step(jnp.asarray(row), jnp.asarray(prev))
    chain = minplus_ref(torch.tensor(row), torch.tensor(prev))[0]
    assert _bits(got.numpy(), pallas) and _bits(got.numpy(), want)
    assert _bits(got.numpy(), chain.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_minplus_monotone_equals_minplus_f64(kind):
    """tests/test_monotone.py:191 on the port: the structure-aware entry
    equals the plain slot's cost on every row kind."""
    rng = np.random.default_rng(21)
    row = torch.tensor(_mk_row(kind, rng, 40, np.float64))
    prev = torch.tensor(rng.random(101))
    prev[0] = 0.0
    want = ops.minplus(row, prev)[0]
    got = ops.minplus_monotone(row, prev)
    assert _bits(got.numpy(), want.numpy())
    assert _bits(monotone.plateau_step(row, prev).numpy(), want.numpy())


def test_tiled_blocks_equal_jax_f64(jax_shims):
    import jax
    rng = np.random.default_rng(3)
    T, dc1, d1 = 150, 13, 57
    rows = np.repeat(rng.random((T, 4)), 4, axis=1)[:, :dc1]
    rows[rng.random((T, dc1)) < 0.2] = np.inf
    rows[:, 0] = 0.0
    rows[:70, 1:] = np.inf                  # identity prefix
    with jax.enable_x64(True):
        want = np.asarray(jax_tiled.minplus_sweep_tiled(
            jnp.asarray(rows), d1 - 1, start=70))
        chain = np.asarray(jax_tiled.minplus_chain_step(
            jnp.asarray(rows[75:78]), jnp.asarray(want[70:73])))
    got = tiled.minplus_sweep_tiled(torch.tensor(rows), d1 - 1, start=70)
    assert got.shape == (T, d1)
    assert _bits(got[64:].numpy(), want[64:])
    got_chain = tiled.minplus_chain_step(torch.tensor(rows[75:78]),
                                         torch.tensor(want[70:73]))
    assert _bits(got_chain.numpy(), chain)
    assert tiled.TILE == jax_tiled.TILE
    assert (monotone.PATH_DNC, monotone.PATH_PLATEAU, monotone.PATH_CHAIN) \
        == (jax_monotone.PATH_DNC, jax_monotone.PATH_PLATEAU,
            jax_monotone.PATH_CHAIN)


def test_ops_dispatch_cpu_uses_plain_versions():
    row, prev = _row_prev(20, 90, 0.2, seed=5, dtype=np.float64)
    row, prev = torch.tensor(row), torch.tensor(prev)
    before = (kernel.minplus_cuda.launches,
              kernel.minplus_plateau_cuda.launches)
    new, arg = ops.minplus(row, prev)
    want_new, want_arg = minplus_ref(row, prev)
    assert torch.equal(new, want_new) and torch.equal(arg, want_arg)
    assert torch.equal(ops.minplus_monotone(row, prev, r_max=2), want_new)
    # the plateau tile's entry: two slots chained, the plain step's columns
    rows = torch.stack([row, row.flip(0).sort().values])
    out = ops.minplus_plateau_tile(rows, prev, torch.empty((2, 90),
                                                           dtype=prev.dtype),
                                   r_max=16)
    first = monotone.plateau_step(rows[0], prev)
    assert _bits(out[0].numpy(), first.numpy())
    assert _bits(out[1].numpy(), monotone.plateau_step(rows[1],
                                                       first).numpy())
    assert (kernel.minplus_cuda.launches,
            kernel.minplus_plateau_cuda.launches) == before


@pytest.mark.parametrize("fn", [kernel.minplus_cuda,
                                kernel.minplus_plateau_cuda])
def test_slot_wrappers_refuse_cpu_tensors(fn):
    row = torch.zeros(3, dtype=torch.float64)
    if fn is kernel.minplus_plateau_cuda:      # a tile of one row
        row = row[None]
    with pytest.raises(ValueError, match="CUDA"):
        fn(row, torch.zeros(7, dtype=torch.float64))


def test_plateau_wrapper_refuses_bad_shapes():
    """The tile wrapper takes (n, DC+1) rows and an (n, D+1) ``out``, and
    refuses a 1-D ``rows`` and a mis-shaped ``out`` before it looks at the
    device."""
    rows = torch.zeros((4, 3), dtype=torch.float64)
    prev = torch.zeros(7, dtype=torch.float64)
    with pytest.raises(ValueError, match="matrix"):
        kernel.minplus_plateau_cuda(rows[0], prev)
    with pytest.raises(ValueError, match="out"):
        kernel.minplus_plateau_cuda(rows, prev,
                                    out=torch.zeros((3, 7),
                                                    dtype=torch.float64))
    with pytest.raises(ValueError, match="r_max"):
        kernel.minplus_plateau_cuda(rows, prev, r_max=0)


def test_tile_wrapper_refuses_cpu_tensors():
    rows = torch.zeros((4, 3), dtype=torch.float64)
    prev = torch.zeros(7, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.minplus_sweep_cuda(rows, 6, prev=prev,
                                  out=torch.zeros((4, 7),
                                                  dtype=torch.float64))


def _dp_carry(dc1, d1, dtype, seed, slots=5):
    """A carry that is a real DP column: the sweep's last column after
    ``slots`` seeded slots from the identity (finite and +inf cells, no
    -0), as the tiled core hands one tile to the next."""
    rng = np.random.default_rng(seed)
    rows = np.round(rng.random((slots, dc1)) * 8) / 8
    rows[rng.random((slots, dc1)) < 0.3] = np.inf
    rows[:, 0] = 0.0
    return minplus_sweep_ref(torch.tensor(rows.astype(dtype)), d1 - 1)[0][-1]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,dc1,d1", [(1, 17, 33), (17, 65, 300),
                                      (64, 64, 1280), (5, 640, 1280)])
def test_minplus_tile_from_carry_equals_chain_steps(jax_shims, n, dc1, d1,
                                                    dtype):
    """From a DP column and from an arbitrary carry (ties, +inf cells),
    the plain tile equals the per-slot chain step column by column, the
    reference's ``minplus_tile`` bit for bit, and ``ops.minplus_chain``
    (the route's dispatch) writes the same columns into rows of a larger
    table, leaving the others untouched and launching nothing."""
    import jax
    rng = np.random.default_rng(n * d1 + dc1)
    rows = _stair_rows(rng, n, dc1, dtype)
    rows[rng.random(rows.shape) < 0.2] = np.inf
    rows[:, 0] = 0.0
    rand = (np.round(rng.random(d1) * 8) / 8).astype(dtype)
    rand[rng.random(d1) < 0.3] = np.inf
    for prev in (_dp_carry(dc1, d1, dtype, n + dc1), torch.tensor(rand)):
        rows_t = torch.tensor(rows)
        carry, cols = tiled.minplus_tile(rows_t[:, None, :], prev[None])
        assert cols.shape == (n, 1, d1) and _bits(carry[0], cols[-1, 0])
        step = prev
        for t in range(n):
            step = tiled.minplus_chain_step(rows_t[t][None], step[None])[0]
            assert _bits(cols[t, 0].numpy(), step.numpy()), t
        with jax.enable_x64(dtype == np.float64):
            j_carry, j_cols = jax_tiled.minplus_tile(
                jnp.asarray(rows)[:, None, :], jnp.asarray(prev.numpy())[None])
            j_cols = np.asarray(j_cols)
        assert _bits(cols.numpy(), j_cols)
        table = torch.full((n + 3, d1), float("nan"),
                           dtype=rows_t.dtype)
        before = kernel.minplus_sweep_cuda.launches
        got = ops.minplus_chain(rows_t, prev, table[2:n + 2])
        assert kernel.minplus_sweep_cuda.launches == before
        assert _bits(got.numpy(), cols[:, 0].numpy())
        assert _bits(table[2:n + 2].numpy(), cols[:, 0].numpy())
        assert torch.isnan(table[:2]).all() and torch.isnan(table[n + 2:]).all()


def test_tile_plan_takes_every_trace_bucket():
    """The chain tile plans a launch within the 227 KB of shared memory a
    block may use on every shape bucket of the repo's unquantized traces,
    in float32 and float64, whatever the tile's length (1 to 64 slots: the
    kernel's buffers hold one slot's row and the carry, never the tile),
    and refuses a band wider than shared memory."""
    buckets = _trace_buckets()
    k = kernel.SWEEP_K
    for m_pad, d1 in buckets:
        for dtype in (torch.float32, torch.float64):
            size = 8 if dtype == torch.float64 else 4
            plans = {n: kernel.sweep_plan(m_pad, d1, dtype)
                     for n in range(1, tiled.TILE + 1)}
            p = plans[tiled.TILE]
            assert set(plans.values()) == {p}
            assert p.cluster in kernel.SWEEP_CLUSTERS and p.cluster > 1
            assert p.cluster * p.w >= d1 and p.w % k == 0
            assert p.jpad >= m_pad and p.jpad % k == 0
            assert p.threads == p.w // k * p.jgroups \
                <= kernel.SWEEP_MAX_THREADS
            part = p.jgroups * p.w if p.jgroups > 1 else 0
            assert p.smem_bytes == size * (3 * p.w + 2 * p.jpad + part) \
                + 4 * part <= kernel.SMEM_LIMIT
    with pytest.raises(ValueError, match=str(kernel.SMEM_LIMIT)):
        kernel.sweep_plan(20000, 20480, torch.float64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dc1", [64, 128, 256, 384, 512, 640])
def test_tile_replay_from_carry_equals_minplus_tile(dc1, dtype):
    """The kernel's decomposition, replayed in numpy from a carry-in that
    is a DP column (the kernel loads it into the blocks' slices in place
    of the identity), equals the plain tile bit for bit over three slots:
    at each 10x bucket (d1 = 1280, a cluster of 16) and under clusters of
    4 and 8, reached through d1 = 64 C columns (the band cut to d1)."""
    n = 3
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    for c, d1 in ((16, 1280), (4, 256), (8, 512)):
        band = min(dc1, d1)
        rng = np.random.default_rng(dc1 + d1)
        rows = _stair_rows(rng, n, band, dtype)
        prev = _dp_carry(band, d1, dtype, dc1)
        want = tiled.minplus_tile(torch.tensor(rows)[:, None, :],
                                  prev[None])[1][:, 0].numpy()
        plan = kernel.sweep_plan(band, d1, tdt)
        assert plan.cluster == c
        col = prev.numpy()
        for t in range(n):
            col, _ = _replay_slot(rows[t], col, plan)
            assert _bits(col, want[t]), (plan, t)


def _trace_buckets():
    """Every (m_pad, d1) bucket of the two unquantized traces and of the
    serving stream (T = 64: a 64-slot window, quantum=0)."""
    out = set()
    for n, T, seed in ((2000, 500, 0), (40, 100, 1)):
        for job in workload.make_jobs(n, T=T, seed=seed):
            key = _shape_bucket(engine._with_quantum(job, None))
            if key is not None:
                out.add(key)
    for job in workload.stream_jobs(rate=0.2, seed=0, max_slots=20000):
        key = _shape_bucket(engine._with_quantum(job, 0))
        if key is not None:
            out.add(key)
    return sorted(out)




def test_launch_plans_take_every_trace_bucket():
    """The sweep, the plateau tile (in both table placements) and the
    one-slot kernel plan a launch, within the 227 KB of
    shared memory a block may use, for every shape bucket the reference
    decides on the 10x trace and the T=100 full-size trace at quantum=None
    (among them d1 = 20480 with m_pad up to 8960, the tight float64
    shape) and the port decides on the T = 64 serving stream at quantum=0
    (d1 = 1280, every m_pad bucket); the sweep takes a cluster of several
    blocks on every bucket, and refuses a band wider than shared memory."""
    buckets = _trace_buckets()
    assert (8960, 20480) in buckets and (2688, 20480) in buckets
    assert {(m, 1280) for m in (64, 128, 256, 384, 512, 640)} <= set(buckets)
    for m_pad, d1 in buckets:
        for dtype in (torch.float32, torch.float64):
            plan = kernel.sweep_plan(m_pad, d1, dtype)
            size = 8 if dtype == torch.float64 else 4
            assert plan.cluster in kernel.SWEEP_CLUSTERS and plan.cluster > 1
            k = kernel.SWEEP_K
            assert plan.cluster * plan.w >= d1 and plan.w % k == 0
            assert plan.jpad >= m_pad and plan.jpad % k == 0
            assert plan.threads == plan.w // k * plan.jgroups \
                <= kernel.SWEEP_MAX_THREADS
            part = plan.jgroups * plan.w if plan.jgroups > 1 else 0
            assert plan.smem_bytes == size * (
                3 * plan.w + 2 * plan.jpad + part) \
                + 4 * part <= kernel.SMEM_LIMIT
            r_max = max(16, m_pad // 4)
            pp = kernel.plateau_plan(m_pad, d1, dtype, r_max)
            assert pp.cluster in kernel.SWEEP_CLUSTERS
            assert pp.cluster * pp.w >= d1 and pp.w % k == 0
            assert pp.jpad >= m_pad and pp.jpad % k == 0
            assert pp.kmax == m_pad.bit_length()
            assert pp.threads % 32 == 0 and kernel.PLATEAU_MIN_THREADS \
                <= pp.threads <= kernel.PLATEAU_MAX_THREADS
            assert 1 <= pp.stage <= tiled.TILE
            assert pp.smem_bytes == kernel._plateau_smem(
                pp.w, pp.jpad, r_max, pp.kmax, pp.stage, pp.table_shared,
                size) <= kernel.SMEM_LIMIT
            if pp.stage < tiled.TILE:       # as many slots as fit
                assert kernel._plateau_smem(
                    pp.w, pp.jpad, r_max, pp.kmax, pp.stage + 1,
                    pp.table_shared, size) > kernel.SMEM_LIMIT
            assert pp.scratch == (0 if pp.table_shared else
                                  pp.cluster * pp.kmax * (pp.jpad + pp.w))
            glob = kernel.plateau_plan(m_pad, d1, dtype, r_max,
                                       table_shared=False)
            assert not glob.table_shared and glob.scratch > 0 \
                and glob.smem_bytes <= kernel.SMEM_LIMIT
            kernel.slot_plan(m_pad, dtype)
    # d1 = 64 C columns take a cluster of C blocks, every size there is
    for dtype in (torch.float32, torch.float64):
        assert [kernel.sweep_plan(c * 40, 64 * c, dtype).cluster
                for c in kernel.SWEEP_CLUSTERS] == list(kernel.SWEEP_CLUSTERS)
    assert kernel.sweep_plan(64, 1280, torch.float64) == kernel.SweepPlan(
        cluster=16, w=80, jpad=64, jgroups=8,
        threads=160, smem_bytes=8 * (3 * 80 + 2 * 64 + 8 * 80) + 4 * 8 * 80)
    # the plateau tile at the route's one shape: the sweep's cluster, a
    # whole tile's rows and runs staged, the window and 7 table levels in
    # shared memory
    assert kernel.plateau_plan(64, 1280, torch.float64, 16) == \
        kernel.PlateauPlan(cluster=16, w=80, jpad=64, threads=256, kmax=7,
                           stage=64, table_shared=True,
                           smem_bytes=8 * (2 * 80 + 64 * (64 + 16) + 7 * 144)
                           + 4 * 64 * (2 * 16 + 3), scratch=0)
    # a row wider than shared memory is refused, naming the limit
    with pytest.raises(ValueError, match=str(kernel.SMEM_LIMIT)):
        kernel.sweep_plan(40000, 40001, torch.float64)
    with pytest.raises(ValueError, match=str(kernel.SMEM_LIMIT)):
        kernel.plateau_plan(40000, 40001, torch.float64, 16)


def _stair_rows(rng, T, dc1, dtype):
    """COST-row stand-ins: non-decreasing staircases of a few runs on a
    grid of quarters (so candidates tie exactly, across blocks and j
    groups), +inf past a feasible prefix, 0 at column 0."""
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
    return rows.astype(dtype)


def _ceil_to(n, m):
    return -(-n // m) * m


def _replay_slot(row, prev, plan, groups=None):
    """One slot of csrc/minplus_sweep.cu's decomposition under ``plan``,
    in numpy: block r of the cluster holds the carry slice
    ``prev[r w, (r+1) w)`` (-inf past D, which no column below D+1 may
    read), builds its window from the lower ranks' slices (the halo) and
    its own, stored as ``k`` planes; each thread takes its ``k`` columns
    over its group's j range, and the groups' (value, j) partials merge
    in increasing j.  ``groups`` restricts the replay to those column
    groups of every block.  Returns ``(cost, split)`` (NaN / -1 at the
    columns not replayed)."""
    K, w, jpad, S, C = (kernel.SWEEP_K, plan.w, plan.jpad, plan.jgroups,
                        plan.cluster)
    dc1, d1, dt = row.size, prev.size, row.dtype
    row_buf = np.full(jpad, np.inf, dt)
    row_buf[:dc1] = row
    slices = np.full(C * w, -np.inf, dt)
    slices[:d1] = prev
    slices = slices.reshape(C, w)
    plane = (jpad + w) // K
    sel = np.arange(w // K) if groups is None else np.unique(
        np.asarray(groups) % (w // K))
    c0 = sel * K
    cost = np.full(d1, np.nan, dt)
    split = np.full(d1, -1, np.int32)
    for r in range(C):
        col0 = r * w
        x = np.arange(jpad + w)
        g = col0 - jpad + x
        q = np.where(g >= 0, g // w, 0)
        assert (q[(g >= 0) & (x < jpad)] < r).all()     # halo: lower ranks
        assert (q[x >= jpad] == r).all()
        win = np.empty(jpad + w, dt)
        win[(x % K) * plane + x // K] = np.where(
            g < 0, np.inf, slices[q, np.clip(g - q * w, 0, w - 1)])
        j_block = min(jpad, col0 + w)
        j_step = _ceil_to(-(-j_block // S), K)
        part = np.full((S, sel.size, K), np.inf, dt)
        part_arg = np.zeros((S, sel.size, K), np.int32)
        for s in range(S):
            jlo = s * j_step
            jhi = np.minimum(min(jlo + j_step, j_block), col0 + c0 + K)
            if jhi.max() <= jlo:
                continue
            j = np.arange(jlo, jhi.max())
            xs = jpad + c0[:, None, None] + np.arange(K)[None, :, None] \
                - j[None, None, :]
            live = np.broadcast_to(j[None, None, :] < jhi[:, None, None],
                                   xs.shape)
            assert xs[live].min() >= 0 and xs[live].max() < jpad + w
            xs = np.clip(xs, 0, jpad + w - 1)
            with np.errstate(invalid="ignore"):     # -inf + inf off `live`
                cand = np.where(live, row_buf[j][None, None, :]
                                + win[(xs % K) * plane + xs // K], np.inf)
            a = np.argmin(cand, axis=2)       # first index: strict '<'
            b = np.take_along_axis(cand, a[..., None], 2)[..., 0]
            part[s] = b
            part_arg[s] = np.where(b < np.inf, jlo + a, 0)
        best, arg = part[0], part_arg[0]
        for s in range(1, S):
            won = part[s] < best
            best = np.where(won, part[s], best)
            arg = np.where(won, part_arg[s], arg)
        cols = col0 + c0[:, None] + np.arange(K)[None, :]
        keep = cols < d1
        cost[cols[keep]] = best[keep]
        split[cols[keep]] = arg[keep]
    return cost, split


def _replay_sweep(rows, d1, plan):
    """The whole sweep replayed slot by slot from the carry [0, inf, ...]."""
    prev = np.full(d1, np.inf, rows.dtype)
    prev[0] = 0.0
    cost = np.empty((rows.shape[0], d1), rows.dtype)
    split = np.empty((rows.shape[0], d1), np.int32)
    for t in range(rows.shape[0]):
        cost[t], split[t] = _replay_slot(rows[t], prev, plan)
        prev = cost[t]
    return cost, split


# the sweep's test shapes; shapes with d1 = 64 C, which the plan gives C
# blocks (1, 2, 4, 8, 16; the band's halo reaching over up to 10 lower
# ranks); and the 10x buckets
REPLAY_SHAPES = [(3, 2, 6), (9, 17, 33), (16, 65, 300), (6, 40, 64),
                 (6, 90, 128), (5, 150, 256), (7, 300, 512), (3, 600, 1024),
                 (5, 64, 1280), (4, 128, 1280), (3, 256, 1280),
                 (3, 384, 1280), (2, 512, 1280), (2, 640, 1280)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("T,dc1,d1", REPLAY_SHAPES)
def test_sweep_plan_replay_equals_plain_sweep(T, dc1, d1, dtype):
    """The kernel's decomposition, replayed in numpy under its plan (at
    the 10x buckets, j groups of the low ranks left empty by the band),
    equals the plain sweep bit for bit in cost and split, on staircase
    rows full of ties and on random rows with +inf cells."""
    rng = np.random.default_rng(T * d1 + dc1)
    rand = np.round(rng.random((T, dc1)) * 8) / 8
    rand[rng.random((T, dc1)) < 0.4] = np.inf
    rand[:, 0] = 0.0
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    plan = kernel.sweep_plan(dc1, d1, tdt)
    for rows in (_stair_rows(rng, T, dc1, dtype), rand.astype(dtype)):
        want_cost, want_split = minplus_sweep_ref(torch.tensor(rows), d1 - 1)
        cost, split = _replay_sweep(rows, d1, plan)
        assert _bits(cost, want_cost.numpy()), plan
        assert np.array_equal(split, want_split.numpy()), plan


def test_sweep_plan_replay_every_trace_bucket():
    """On every (m_pad, d1) bucket of the repo's traces, in float32 and
    float64, one slot of the planned decomposition over a staircase row
    from a seeded carry with ties and +inf cells: each block's first,
    second, middle and last column groups (every block boundary, every
    halo edge, every j group) equal the slot's definition, the first
    index of ``min_j row[j] + prev[d - j]``, bit for bit."""
    for m_pad, d1 in _trace_buckets():
        for dtype, tdt in ((np.float32, torch.float32),
                           (np.float64, torch.float64)):
            rng = np.random.default_rng(m_pad * 7 + d1)
            row = _stair_rows(rng, 1, m_pad, dtype)[0]
            prev = (np.round(rng.random(d1) * 8) / 8).astype(dtype)
            prev[rng.random(d1) < 0.3] = np.inf
            plan = kernel.sweep_plan(m_pad, d1, tdt)
            groups = plan.w // kernel.SWEEP_K
            cost, split = _replay_slot(row, prev, plan,
                                       [0, 1, groups // 2, groups - 1])
            cols = np.flatnonzero(split >= 0)
            assert cols[0] == 0 and cols[-1] == d1 - 1
            for r in range(1, plan.cluster):
                assert r * plan.w in cols or r * plan.w >= d1
            for d in cols:
                n = min(m_pad, d + 1)
                cand = row[:n] + prev[d::-1][:n]
                j = int(np.argmin(cand))
                assert _bits(cost[d:d + 1], cand[j:j + 1]), (m_pad, d1, d)
                assert split[d] == (j if cand[j] < np.inf else 0), \
                    (m_pad, d1, d)


def test_sweep_never_yields_negative_zero():
    """No candidate of the sweep is -0, whatever the rows hold: the carry
    starts at +0 and an IEEE sum is -0 only when both addends are.  The
    CUDA sweep's cost-only path takes min (which may pick either zero of a
    +0/-0 tie) where the split path selects the first minimum; this is
    why the two agree bit for bit."""
    rng = np.random.default_rng(11)
    rows = np.round(rng.random((12, 40)) * 2) / 4       # many zeros
    rows[rows == 0] = -0.0
    rows[rng.random(rows.shape) < 0.2] = np.inf
    for dtype in (torch.float32, torch.float64):
        cost, _ = minplus_sweep_ref(torch.tensor(rows, dtype=dtype), 99)
        zeros = cost[cost == 0]
        assert zeros.numel() > 0 and not torch.signbit(zeros).any()


"""The port's plateau tile against the JAX package, and the plateau
kernel's decomposition replayed on the CPU.

* The plain tile (``ops.minplus_plateau_tile`` on CPU tensors: the
  port's ``monotone.plateau_step`` chained over a tile's rows) must equal,
  bit for bit, the reference's in-scan plateau step
  (``repro.kernels.minplus.monotone.plateau_step_unrolled``) chained the
  way the reference's tile body chains it, and the port's chain tile
  (``tiled.minplus_tile``), in float32 and float64, for tiles of 1, 17 and
  64 slots, rows of 1, 15 and 16 runs, from the identity and from a DP
  column.
* A numpy replay of ``csrc/minplus_plateau.cu``'s decomposition under
  its launch plan (the cluster's carry slices, each block's window read
  through the halo, the run scan with its +inf runs left out, the table
  levels each finite run needs and the two reads per run and output, the
  direct loop for a row of more than ``r_max`` runs) equals the plain tile bit for bit, at the route's shape
  under every cluster size and on every shape bucket of the repo's
  traces, and reads no table entry it did not build.

The kernel itself is held to the plain tile and the chain on the card
(``tests/test_torch_minplus_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_shims  # noqa: F401  (fixture)
from repro.kernels.minplus import monotone as jax_monotone
from repro_torch.core.schedule_torch import _shape_bucket
from repro_torch.kernels.minplus import kernel, monotone, ops, tiled
from repro_torch.kernels.minplus.ref import minplus_sweep_ref
from repro_torch.sim import engine, workload

R_MAX = 16


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _plateau_rows(rng, n, dc1, runs, dtype):
    """``n`` COST-row stand-ins of exactly ``runs`` runs each: 0 first,
    then a non-decreasing staircase on a grid of quarters (so candidates
    tie exactly), the last run +inf in every other row."""
    rows = np.empty((n, dc1))
    for t in range(n):
        runs_t = min(runs, dc1)
        cuts = np.sort(rng.choice(np.arange(1, dc1), runs_t - 1,
                                  replace=False)) if runs_t > 1 else \
            np.zeros(0, np.int64)
        vals = np.concatenate([[0.0], 0.25 + np.cumsum(
            rng.integers(1, 4, runs_t - 1)) / 4.0])
        if t % 2 and runs_t > 1:
            vals[-1] = np.inf
        rows[t] = np.repeat(vals, np.diff(np.concatenate([[0], cuts,
                                                          [dc1]])))
    return rows.astype(dtype)


def _carry(kind, dc1, d1, dtype, seed):
    """The identity column, or a real DP column: the sweep's last column
    after three seeded slots from the identity (finite and +inf cells, no
    -0), as the tiled core hands one tile to the next."""
    if kind == "identity":
        prev = np.full(d1, np.inf, dtype)
        prev[0] = 0.0
        return torch.tensor(prev)
    rng = np.random.default_rng(seed)
    rows = np.round(rng.random((3, dc1)) * 8) / 8 + 0.5
    rows[rng.random((3, dc1)) < 0.3] = np.inf
    rows[:, 0] = 0.0
    return minplus_sweep_ref(torch.tensor(rows.astype(dtype)), d1 - 1)[0][-1]


_jax_step = jax.jit(jax_monotone.plateau_step_unrolled, static_argnums=2)


@pytest.mark.parametrize("carry", ["identity", "dp"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("runs", [1, 15, 16])
@pytest.mark.parametrize("n", [1, 17, 64])
@pytest.mark.parametrize("dc1,d1", [(17, 129), (64, 1280)])
def test_plain_tile_equals_jax_plateau_chain_and_minplus_tile(
        jax_shims, dc1, d1, n, runs, dtype, carry):
    """The plain tile, written at a row offset of a larger table whose
    other rows stay untouched and launching nothing, equals the
    reference's unrolled plateau step chained over the tile and the
    port's chain tile, bit for bit."""
    rng = np.random.default_rng(n * 131 + runs * 7 + dc1)
    rows = _plateau_rows(rng, n, dc1, runs, dtype)
    assert (monotone.run_count_np(rows) == min(runs, dc1)).all()
    prev = _carry(carry, dc1, d1, dtype, seed=n + runs)
    table = torch.full((n + 3, d1), float("nan"), dtype=prev.dtype)
    before = kernel.minplus_plateau_cuda.launches
    got = ops.minplus_plateau_tile(torch.tensor(rows), prev,
                                   table[2:n + 2], R_MAX)
    assert kernel.minplus_plateau_cuda.launches == before
    assert got.data_ptr() == table[2].data_ptr()
    assert torch.isnan(table[:2]).all() and torch.isnan(table[n + 2:]).all()
    chain = tiled.minplus_tile(torch.tensor(rows)[:, None, :],
                               prev[None])[1][:, 0]
    assert _bits(got.numpy(), chain.numpy())
    with jax.enable_x64(dtype == np.float64):
        col = jnp.asarray(prev.numpy())
        want = []
        for row in rows:
            col = _jax_step(jnp.asarray(row), col, R_MAX)
            want.append(np.asarray(col))
    assert _bits(got.numpy(), np.stack(want))


# ---------------------------------------------------------------------------
# The kernel's decomposition, replayed
# ---------------------------------------------------------------------------

def _min2(a, b):
    """The kernel's min: ``b < a ? b : a`` (the replay takes the minimum
    over runs or j in one ``np.min``: with no NaN and no -0 candidate,
    any order gives the same bits)."""
    return np.where(b < a, b, a)


def _replay_slot(row, slices, plan, r_max, cols=None):
    """One slot of csrc/minplus_plateau.cu under ``plan``, in numpy, from
    the cluster's carry slices (C, w); returns the next slices, at the
    local columns ``cols`` of every block (all by default; NaN at the
    others).  Asserts that each block's halo comes from lower ranks and
    that every table read lies in an entry the kernel built."""
    C, w, jpad = plan.cluster, plan.w, plan.jpad
    lw = jpad + w
    dc1, dt = row.size, row.dtype
    inf = dt.type(np.inf)
    starts = [j for j in range(dc1) if j == 0 or row[j] != row[j - 1]]
    nxt = np.full_like(slices, np.nan)
    cols = np.arange(w) if cols is None else np.asarray(cols)
    for r in range(C):
        col0 = r * w
        x = np.arange(lw)
        gx = col0 - jpad + x
        q = np.where(gx >= 0, gx // w, 0)
        assert (q[(gx >= 0) & (x < jpad)] < r).all()     # halo: lower ranks
        assert (q[x >= jpad] == r).all()
        win = np.where(gx < 0, inf, slices[q, np.clip(gx - q * w, 0, w - 1)])
        if len(starts) > r_max:                            # the direct loop
            # candidate j of column c reads window c + JP - j
            js = np.arange(dc1)
            cand = row[:, None] + win[jpad - js[:, None] + cols[None, :]]
            nxt[r, cols] = np.min(cand, axis=0)
            continue
        # the finite runs: a +inf run never lowers a minimum
        ends = [s - 1 for s in starts[1:]] + [dc1 - 1]
        runs = [(s, e) for s, e in zip(starts, ends) if row[s] < inf]
        if not runs:
            nxt[r, cols] = inf
            continue
        starts_f, ends_f = zip(*runs)
        # two windows of 2^kw cover a run of up to 2^(kw+1) values
        kws = [max(e - s, 1).bit_length() - 1 for s, e in runs]
        top = max(kws)
        assert top < plan.kmax
        tab = np.full((plan.kmax, lw), np.nan, dt)
        tab[0] = win
        for k in range(1, top + 1):
            half, n_k = 1 << (k - 1), lw - (1 << k) + 1
            tab[k, :n_k] = _min2(tab[k - 1, :n_k], tab[k - 1, half:half + n_k])
        s_, e_, kw = (np.asarray(v)[:, None]
                      for v in (starts_f, ends_f, kws))
        off_lo = kw * lw + jpad - e_
        off_hi = kw * lw + jpad - s_ - (1 << kw) + 1
        best = np.full(cols.size, inf, dt)
        for off in (off_lo, off_hi):
            idx = cols[None, :] + off
            assert (idx >= kw * lw).all()
            assert (idx <= kw * lw + lw - (1 << kw)).all()     # built
        flat = tab.reshape(-1)
        cand = row[s_] + _min2(flat[cols[None, :] + off_lo],
                               flat[cols[None, :] + off_hi])
        best = np.min(np.concatenate([best[None], cand]), axis=0)
        nxt[r, cols] = best
    return nxt


def _replay_tile(rows, prev, plan, r_max):
    """The tile replayed slot by slot: the carry loaded into the slices
    (+inf past D), each slot's columns below D+1 returned."""
    d1 = prev.size
    slices = np.full(plan.cluster * plan.w, np.inf, prev.dtype)
    slices[:d1] = prev
    slices = slices.reshape(plan.cluster, plan.w)
    cols = []
    for row in rows:
        slices = _replay_slot(row, slices, plan, r_max)
        cols.append(slices.reshape(-1)[:d1].copy())
    return np.stack(cols)


def _plain_tile(rows, prev):
    out = torch.empty((rows.shape[0], prev.numel()), dtype=prev.dtype)
    return ops.minplus_plateau_tile(torch.tensor(rows), prev, out,
                                    R_MAX).numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cluster", kernel.SWEEP_CLUSTERS)
def test_replay_route_shape_every_cluster_equals_plain_tile(cluster, dtype):
    """At the route's shape (DC+1 = 64, D+1 = 1280), under every cluster
    size the probe times and both table placements' plan (the same
    arithmetic), five slots of 1, 15, 16 and 48 runs (the last through
    the direct loop) from a DP column equal the plain tile bit for bit."""
    dc1, d1 = 64, 1280
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    prev = _carry("dp", dc1, d1, dtype, seed=cluster)
    rng = np.random.default_rng(cluster)
    rows = np.concatenate([_plateau_rows(rng, 2, dc1, 16, dtype),
                           _plateau_rows(rng, 1, dc1, 1, dtype),
                           _plateau_rows(rng, 1, dc1, 48, dtype),
                           _plateau_rows(rng, 1, dc1, 15, dtype)])
    want = _plain_tile(rows, prev)
    for shared in (True, False):
        plan = kernel._plateau_plan_at(dc1, d1, tdt.itemsize, R_MAX,
                                       cluster, shared)
        assert plan is not None and plan.cluster * plan.w >= d1
        assert _bits(_replay_tile(rows, prev.numpy(), plan, R_MAX), want)
    if cluster == 16:
        assert kernel.plateau_plan(dc1, d1, tdt, R_MAX) == \
            kernel._plateau_plan_at(dc1, d1, tdt.itemsize, R_MAX, 16, True)


def _trace_buckets():
    """Every (m_pad, d1) bucket of the two unquantized traces."""
    out = set()
    for n, T, seed in ((2000, 500, 0), (40, 100, 1)):
        for job in workload.make_jobs(n, T=T, seed=seed):
            key = _shape_bucket(engine._with_quantum(job, None))
            if key is not None:
                out.add(key)
    return sorted(out)


def test_replay_every_trace_bucket_equals_plain_slot():
    """On every (m_pad, d1) bucket of the repo's traces, with the route's
    ``r_max = max(16, m_pad // 4)``, one slot of the planned decomposition
    from a seeded carry with ties and +inf cells equals the plain step bit
    for bit at each block's first, second, middle and last columns (every
    block boundary, every halo edge), in float32 and float64: a row of
    r_max runs through the table (in shared memory or, for the wide
    bands, in global scratch) and one of more runs through the direct
    loop."""
    for m_pad, d1 in _trace_buckets():
        r_max = max(R_MAX, m_pad // 4)
        for dtype, tdt in ((np.float32, torch.float32),
                           (np.float64, torch.float64)):
            plan = kernel.plateau_plan(m_pad, d1, tdt, r_max)
            rng = np.random.default_rng(m_pad + d1)
            prev = (np.round(rng.random(d1) * 8) / 8).astype(dtype)
            prev[rng.random(d1) < 0.3] = np.inf
            prev[0] = 0.0
            slices = np.full(plan.cluster * plan.w, np.inf, dtype)
            slices[:d1] = prev
            slices = slices.reshape(plan.cluster, plan.w)
            cols = [0, 1, plan.w // 2, plan.w - 1]
            at = (np.arange(plan.cluster)[:, None] * plan.w
                  + np.asarray(cols)[None, :]).reshape(-1)
            at = at[at < d1]
            rows = np.concatenate([
                _plateau_rows(rng, 1, m_pad, r_max, dtype),
                _plateau_rows(rng, 1, m_pad, min(r_max + 3, m_pad), dtype)])
            for row in rows:
                want = monotone.plateau_step(torch.tensor(row),
                                             torch.tensor(prev)).numpy()
                got = _replay_slot(row, slices, plan, r_max,
                                   cols).reshape(-1)
                assert _bits(got[at], want[at]), (m_pad, d1, dtype, plan)

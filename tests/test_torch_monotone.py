"""The convex divide-and-conquer branch of the monotone min-plus dispatch
against the JAX package.

* **The certificate.**  ``monotone.convex_certificate`` (torch) and
  ``convex_certificate_np`` against the reference's, on its ulp-dent rows
  (``tests/test_monotone.py:122-146``, both dtypes) and on random and
  crafted rows: exact, no tolerance.
* **The D&C step.**  ``monotone_dnc_step`` against the reference's,
  values and overflow flag, on certified and arbitrary rows (a tie-driven
  spill among them), and against the chain bit for bit on certified rows
  over the reference's shape set (dc1 5/17/64, d1 33/129, float32 and
  float64).
* **The dispatcher, the sweep, the ops entry.**  Path codes against
  ``monotone_path_ref`` and the reference's dispatcher; ``monotone_sweep``
  against ``minplus_sweep_cost``; ``ops.minplus_monotone`` against
  ``ops.minplus`` on every branch; ``ops.minplus_dnc_tile`` on the CPU
  against the step chained; a numpy replay of the CUDA kernel's
  recursion (``kernel.dnc_levels``' table, per-midpoint bounds) against
  the chain.  The kernel itself is held to the plain step on the card
  by ``tests/test_torch_minplus_cuda.py``, which imports nothing of JAX.
* **The core at level 2.**  The port's rows fed to the reference's
  ``_decide_tiled(..., mono=2)`` through its row cache: best slot,
  payoff, visited tiles, the [dnc, plateau, chain] tile counts and every
  live DP column bit for bit.
* **Trajectories with the switch on.**  ``REPRO_MONOTONE_DNC=1``:
  ``engine.run(core="tiled")`` equals the reference's ``impl="fast"``
  exactly on the paper seeds 0..4, with D&C tiles on each (the switch is
  restored after each test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_shims, one_torch_thread  # noqa: F401
from repro.core import price_params_from_jobs
from repro.core import schedule_jax as sj
from repro.core.pricing import PriceState as RefPriceState
from repro.kernels.minplus import monotone as jm
from repro.kernels.minplus.ref import minplus_sweep_cost as jax_sweep_cost
from repro.kernels.minplus.tiled import minplus_chain_step as jax_chain
from repro.sim import make_cluster, make_jobs, simulate
from repro.sim.engine import _with_quantum as ref_with_quantum
from repro_torch import compat
from repro_torch.core import schedule_torch as st
from repro_torch.core.pricing import PriceState
from repro_torch.kernels.minplus import kernel, monotone, ops
from repro_torch.kernels.minplus.ref import minplus_sweep_cost
from repro_torch.kernels.minplus.tiled import TILE, minplus_tile
from repro_torch.sim import engine, workload

DTYPES = [np.float32, np.float64]
# tests/test_monotone.py's randomized shape set
DNC_SHAPES = [(dc1, d1) for dc1 in (5, 17, 64) for d1 in (33, 129)]
KINDS = ["random", "convex", "stair", "inf_tail", "ties"]
# the reference's device functions, compiled once per shape (eagerly each
# call re-traces them: seconds per call)
_jax_cert = jax.jit(jax.vmap(jm.convex_certificate))
_jax_dnc = jax.jit(jm.monotone_dnc_step)
_jax_dispatch = jax.jit(jm.monotone_step_with_path)


def _bits(a, b):
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _chain(row, prev):
    """The reference's chain step (the engine's slot oracle)."""
    with jax.enable_x64(True):
        return np.asarray(jax_chain(jnp.asarray(row)[None],
                                    jnp.asarray(prev)[None])[0])


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


def _convex_row(rng, dc1, dtype, inf_from=None, ties=True):
    """A certified-convex row: 0 first, then increasing increments (equal
    increments where ``ties``: linear stretches), +inf from
    ``inf_from`` on."""
    inc = np.sort(rng.random(dc1 - 1))
    if ties:
        inc = np.round(inc * 4) / 4.0
    row = np.concatenate([[0.0], np.cumsum(inc)]).astype(dtype)
    if inf_from is not None:
        row[inf_from:] = np.inf
    return row


def _prev(rng, d1, dtype, inf_frac=0.3):
    prev = rng.random(d1).astype(dtype)
    prev[rng.random(d1) < inf_frac] = np.inf
    prev[0] = 0.0
    return prev


# ---------------------------------------------------------------------------
# The certificate
# ---------------------------------------------------------------------------

def _certs(row, device=True):
    """(port torch, port numpy, reference numpy[, reference jnp])."""
    out = (bool(monotone.convex_certificate(torch.tensor(row))),
           bool(monotone.convex_certificate_np(row)),
           bool(jm.convex_certificate_np(row)))
    if device:
        with jax.enable_x64(True):
            out += (bool(_jax_cert(jnp.asarray(row)[None])[0]),)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_certificate_is_exact(dtype):
    """tests/test_monotone.py:122-146 on the port, both dtypes: a linear
    row certifies, one ulp up at an interior point decertifies, an
    infeasible suffix stays certified and an interior hole does not."""
    js = np.arange(32, dtype=np.float64)
    row = (js * js).astype(dtype)
    assert _certs(row) == (True,) * 4
    lin = (js * 3.0).astype(dtype)
    assert _certs(lin) == (True,) * 4
    dent = lin.copy()
    dent[7] = np.nextafter(dent[7], dtype(np.inf))
    assert _certs(dent) == (False,) * 4
    down = lin.copy()
    down[7] = np.nextafter(down[7], dtype(-np.inf))
    assert _certs(down) == (False,) * 4     # a dip dents the triple before
    tail = row.copy()
    tail[20:] = np.inf
    assert _certs(tail) == (True,) * 4
    hole = row.copy()
    hole[5] = np.inf
    assert _certs(hole) == (False,) * 4


@pytest.mark.parametrize("dtype", DTYPES)
def test_certificate_equals_reference(dtype):
    """Random and crafted rows, one by one and batched: the port's
    certificate equals the reference's, on the host and on tensors."""
    rng = np.random.default_rng(7)
    rows = []
    for dc1 in (1, 2, 3, 5, 17, 64):
        for kind in KINDS:
            rows.append(_mk_row(kind, rng, dc1, dtype))
        for inf_from in (None, max(dc1 // 2, 1)):
            rows.append(_convex_row(rng, dc1, dtype, inf_from))
            rows.append(_convex_row(rng, dc1, dtype, inf_from, ties=False))
        with np.errstate(over="ignore"):
            big = _convex_row(rng, dc1, np.float64) * 1e307
            rows.append(big.astype(dtype))              # sums overflow
        for poison in (np.nan, -np.inf):
            r = _convex_row(rng, dc1, dtype)
            r[dc1 // 2] = poison
            rows.append(r)
    # ulp dents at random interior points of linear rows
    for _ in range(40):
        dc1 = int(rng.integers(3, 40))
        r = (np.arange(dc1) * rng.random()).astype(dtype)
        k = int(rng.integers(1, dc1 - 1))
        r[k] = np.nextafter(r[k], dtype(np.inf if rng.random() < 0.5
                                        else -np.inf))
        rows.append(r)
    seen = set()
    for row in rows:
        got = _certs(row, device=False)
        assert len(set(got)) == 1, (row, got)
        seen.add(got[0])
    assert seen == {True, False}
    # the reference's device certificate, on one batch of each length
    by_len = {}
    for row in rows:
        by_len.setdefault(row.shape[0], []).append(row)
    for same in by_len.values():
        batch = np.stack(same)
        with jax.enable_x64(True):
            want = np.asarray(_jax_cert(jnp.asarray(batch)))
        assert np.array_equal(
            monotone.convex_certificate(torch.tensor(batch)).numpy(), want)
    batch = np.stack([_convex_row(rng, 17, dtype) for _ in range(8)]
                     + [_mk_row("random", rng, 17, dtype) for _ in range(8)])
    with jax.enable_x64(True):
        want = np.asarray(_jax_cert(jnp.asarray(batch)))
    assert np.array_equal(
        monotone.convex_certificate(torch.tensor(batch)).numpy(), want)
    assert np.array_equal(monotone.convex_certificate_np(batch), want)


# ---------------------------------------------------------------------------
# The D&C step
# ---------------------------------------------------------------------------

def _ref_dnc(row, prev):
    with jax.enable_x64(True):
        new, ovf = _jax_dnc(jnp.asarray(row), jnp.asarray(prev))
        return np.asarray(new), bool(ovf)


def test_dnc_levels_equal_reference():
    for d1 in (1, 2, 7, 33, 129, 1280):
        ours, theirs = monotone._dnc_levels(d1), jm._dnc_levels(d1)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            for x, y in zip(a[:4], b):
                assert np.array_equal(x, y)
            assert np.array_equal((a[4][:, 0] + a[4][:, 1]) // 2, a[0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dc1,d1", DNC_SHAPES)
def test_dnc_step_equals_reference_and_chain(dc1, d1, dtype):
    """Certified rows (ties, +inf suffixes, identity rows) and the
    randomized sweep's arbitrary rows (``tests/test_monotone.py:236-255``):
    values and overflow flag equal the reference's; on certified rows
    without a spill the values equal the chain bit for bit."""
    rng = np.random.default_rng(dc1 * 131 + d1 + (dtype == np.float32))
    cases = []
    for k in range(6):
        inf_from = None if k % 3 == 0 else int(rng.integers(1, dc1 + 1))
        cases.append(_convex_row(rng, dc1, dtype, inf_from, ties=k % 2 == 0))
    ident = np.full(dc1, np.inf, dtype)
    ident[0] = 0.0
    cases.append(ident)
    for _ in range(4):
        nvals = int(rng.integers(1, dc1 + 1))
        row = rng.choice(rng.random(nvals), size=dc1).astype(dtype)
        row[rng.random(dc1) < rng.random() * 0.5] = np.inf
        row[0] = 0.0
        cases.append(row)
    certified = 0
    for row in cases:
        prev = _prev(rng, d1, dtype)
        new, ovf = monotone.monotone_dnc_step(torch.tensor(row),
                                              torch.tensor(prev))
        want, want_ovf = _ref_dnc(row, prev)
        assert ovf == want_ovf
        assert _bits(new.numpy(), want)
        if bool(monotone.convex_certificate_np(row)) and not ovf:
            assert _bits(new.numpy(), _chain(row, prev))
            certified += 1
    assert certified >= 7


def test_dnc_spill_is_flagged_like_the_reference():
    """A tie-driven spill: a linear row against a linear carry makes every
    candidate of a midpoint equal, so no range shrinks and the candidate
    buffer overflows, in both steps; the dispatcher then takes the chain.
    And ``tests/test_monotone.py:221``'s row, flagged as the reference
    flags it."""
    for dtype in DTYPES:
        row = np.arange(17, dtype=dtype)
        prev = np.arange(129, dtype=dtype)
        new, ovf = monotone.monotone_dnc_step(torch.tensor(row),
                                              torch.tensor(prev))
        want, want_ovf = _ref_dnc(row, prev)
        assert ovf and want_ovf
        assert _bits(new.numpy(), want)
        got, path = monotone.monotone_step_with_path(torch.tensor(row),
                                                     torch.tensor(prev))
        assert path == monotone.PATH_CHAIN
        assert monotone.monotone_path_ref(row) == monotone.PATH_DNC
        assert _bits(got.numpy(), _chain(row, prev))
    js = np.arange(24, dtype=np.float64)
    row = js * (js + 3) / 2
    prev = np.random.default_rng(5).random(49)
    new, ovf = monotone.monotone_dnc_step(torch.tensor(row),
                                          torch.tensor(prev))
    want, want_ovf = _ref_dnc(row, prev)
    assert ovf == want_ovf and _bits(new.numpy(), want)
    if not ovf:
        assert _bits(new.numpy(), _chain(row, prev))


# ---------------------------------------------------------------------------
# Dispatcher, sweep, ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_dispatch_paths_equal_reference(dtype):
    """Convex, stair, random and poisoned rows: the path equals
    ``monotone_path_ref`` (the port's and the reference's) and the
    reference dispatcher's, the value the chain's."""
    rng = np.random.default_rng(3)
    rows = {k: _mk_row(k, rng, 48, dtype) for k in KINDS}
    rows["convex_tail"] = _convex_row(rng, 48, dtype, 30)
    for poison in (np.nan, -np.inf):
        r = _mk_row("convex", rng, 48, dtype)
        r[5] = poison
        rows[f"poison_{poison}"] = r
    seen = set()
    for kind, row in rows.items():
        prev = _prev(rng, 97, dtype, 0.2)
        got, path = monotone.monotone_step_with_path(torch.tensor(row),
                                                     torch.tensor(prev))
        with jax.enable_x64(True):
            want, want_path = _jax_dispatch(jnp.asarray(row),
                                            jnp.asarray(prev))
        assert path == int(want_path), kind
        assert path == monotone.monotone_path_ref(row) \
            == jm.monotone_path_ref(row), kind
        if kind.startswith("poison"):      # NaN's sign bit is arbitrary
            assert np.array_equal(got.numpy(), np.asarray(want),
                                  equal_nan=True), kind
            assert np.array_equal(got.numpy(), _chain(row, prev),
                                  equal_nan=True), kind
        else:
            assert _bits(got.numpy(), np.asarray(want)), kind
            assert _bits(got.numpy(), _chain(row, prev)), kind
        seen.add(path)
    assert seen == {monotone.PATH_DNC, monotone.PATH_PLATEAU,
                    monotone.PATH_CHAIN}
    # a poisoned carry refuses the fast paths too
    row = rows["convex"]
    prev = _prev(rng, 97, dtype)
    prev[3] = np.nan
    _, path = monotone.monotone_step_with_path(torch.tensor(row),
                                               torch.tensor(prev))
    assert path == monotone.PATH_CHAIN


def test_monotone_sweep_equals_sweep_cost():
    """tests/test_monotone.py:211 on the port, with convex rows mixed in
    so that every branch runs."""
    rng = np.random.default_rng(8)
    T, dc1, d1 = 40, 13, 57
    rows = np.repeat(rng.random((T, 4)), 4, axis=1)[:, :dc1]
    rows[rng.random((T, dc1)) < 0.2] = np.inf
    rows[:, 0] = 0.0
    for t in range(0, T, 3):
        rows[t] = _convex_row(rng, dc1, np.float64, int(rng.integers(2, dc1)))
    got = monotone.monotone_sweep(torch.tensor(rows), d1 - 1)
    assert _bits(got.numpy(),
                 minplus_sweep_cost(torch.tensor(rows), d1 - 1).numpy())
    with jax.enable_x64(True):
        want = np.asarray(jax_sweep_cost(jnp.asarray(rows), d1 - 1))
        ref = np.asarray(jm.monotone_sweep(jnp.asarray(rows), d1 - 1))
    assert _bits(got.numpy(), want) and _bits(got.numpy(), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ops_minplus_monotone_equals_minplus(dtype):
    """Every branch of the ops entry (D&C, plateau, chain, a spill, a
    poisoned row) equals the plain slot's cost."""
    rng = np.random.default_rng(21)
    rows = [_mk_row(k, rng, 40, np.float64) for k in KINDS]
    rows.append(_convex_row(rng, 40, np.float64, 25))
    rows.append(np.arange(17, dtype=np.float64))         # spills on ties
    poisoned = _mk_row("stair", rng, 40, np.float64)
    poisoned[3] = np.nan
    rows.append(poisoned)
    for row in rows:
        prev = torch.tensor(_prev(rng, 101, np.float64), dtype=dtype)
        if row.shape[0] == 17:
            prev = torch.arange(101, dtype=dtype)
        r = torch.tensor(row, dtype=dtype)
        got = ops.minplus_monotone(r, prev)
        want = ops.minplus(r, prev)[0]
        assert torch.equal(got.isnan(), want.isnan())
        assert _bits(got.nan_to_num(0.0).numpy(),
                     want.nan_to_num(0.0).numpy())


def test_ops_dnc_tile_cpu_is_the_plain_step_chained():
    rng = np.random.default_rng(4)
    dc1, d1, n = 17, 129, 9
    rows = np.stack([_convex_row(rng, dc1, np.float64,
                                 None if i % 2 else 12) for i in range(n)])
    rows[4] = np.arange(dc1)            # a spill: the slot takes the chain
    prev = np.cumsum(rng.random(d1))
    prev[0] = 0.0
    before = kernel.minplus_dnc_cuda.launches
    out = torch.full((n + 2, d1), float("nan"), dtype=torch.float64)
    ops.minplus_dnc_tile(torch.tensor(rows), torch.tensor(prev), out[1:n + 1])
    assert kernel.minplus_dnc_cuda.launches == before
    want = minplus_tile(torch.tensor(rows)[:, None, :],
                        torch.tensor(prev)[None])[1][:, 0]
    assert _bits(out[1:n + 1].numpy(), want.numpy())
    assert out[0].isnan().all() and out[n + 1].isnan().all()


def _kernel_replay(rows, prev):
    """A numpy replay of csrc/minplus_dnc.cu's recursion: the level table
    of ``kernel.dnc_levels`` and one (lo, hi) bound per midpoint, set by
    its parent (left child ``(lo, min(hi, rightmost))``, right child
    ``(max(lo, leftmost), hi)``), each range scanned whole (no buffer)."""
    segs, off = kernel.dnc_levels(prev.shape[0], torch.device("cpu"))
    segs, off = segs.numpy(), off.numpy()
    d1 = prev.shape[0]
    cols = []
    for row in rows:
        fin_r = np.flatnonzero(np.isfinite(row))
        fin_p = np.flatnonzero(np.isfinite(prev))
        mp = fin_r[-1] if len(fin_r) else -1
        pm = fin_p[-1] if len(fin_p) else -1
        lo_b = np.zeros(d1, np.int64)
        hi_b = np.zeros(d1, np.int64)
        lo_b[d1 // 2], hi_b[d1 // 2] = 0, d1 - 1
        new = np.full(d1, np.inf, prev.dtype)
        for lev in range(len(off) - 1):
            for s, e in segs[off[lev]:off[lev + 1]]:
                mid = (s + e) // 2
                lo = max(lo_b[mid], mid - mp, 0)
                hi = min(hi_b[mid], mid, pm)
                i = np.arange(lo, hi + 1)
                c = row[mid - i] + prev[i]
                v = c.min() if len(c) else prev.dtype.type(np.inf)
                new[mid] = v
                if len(c) and np.isfinite(v):
                    al, ar = i[c == v][0], i[c == v][-1]
                else:
                    al, ar = lo, hi
                if s < mid:
                    lo_b[(s + mid) // 2] = lo_b[mid]
                    hi_b[(s + mid) // 2] = min(hi_b[mid], ar)
                if mid + 1 < e:
                    lo_b[(mid + 1 + e) // 2] = max(lo_b[mid], al)
                    hi_b[(mid + 1 + e) // 2] = hi_b[mid]
        cols.append(new)
        prev = new
    return np.stack(cols)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dc1,d1", DNC_SHAPES + [(64, 1280), (1, 7)])
def test_kernel_recursion_replay_equals_chain(dc1, d1, dtype):
    """The kernel's recursion, replayed in numpy over its level table,
    equals the chain bit for bit on certified rows, the tie-driven spill
    included (the kernel keeps no buffer, so it never spills)."""
    rng = np.random.default_rng(dc1 + 7 * d1)
    n = 3 if d1 > 200 else 6
    rows = np.stack([_convex_row(rng, dc1, dtype,
                                 None if i % 2 else max(dc1 // 2, 1))
                     for i in range(n)])
    rows[1] = np.arange(dc1, dtype=dtype)
    rows[2] = np.inf
    rows[2, 0] = 0.0                                    # an identity row
    prev = _prev(rng, d1, dtype)
    got = _kernel_replay(rows, prev)
    want = minplus_tile(torch.tensor(rows)[:, None, :],
                        torch.tensor(prev)[None])[1][:, 0]
    assert _bits(got, want.numpy())
    lin = _kernel_replay(np.arange(dc1, dtype=dtype)[None],
                         np.arange(d1, dtype=dtype))
    assert _bits(lin[0], _chain(np.arange(dc1, dtype=dtype),
                                np.arange(d1, dtype=dtype)))


def test_dnc_plan_places_by_size():
    p = kernel.dnc_plan(64, 1280, torch.float64)
    assert p.shared and p.threads == kernel.DNC_THREADS
    assert p.smem_bytes == 8 * (2 * 1280 + 64 + 16) + 4 * (2 * 1280 + 67)
    assert p.smem_bytes < 32 * 1024                # ~30 KB at d1 = 1280
    assert not kernel.dnc_plan(64, 20480, torch.float64).shared
    assert kernel.dnc_plan(64, 20480, torch.float32).shared is False
    with pytest.raises(ValueError, match="CUDA"):
        kernel.minplus_dnc_cuda(torch.zeros(2, 5), torch.zeros(9))


# ---------------------------------------------------------------------------
# The core at level 2, on shared rows
# ---------------------------------------------------------------------------

def core_parity(job, rjob, state, ref_state, dtype, mono):
    """Run both tiled cores on the port's rows, in ``dtype`` at monotone
    level ``mono``: best slot, payoff, visited tiles, per-branch tile
    counts, every live DP column and the banded backtrack bit for bit.
    Returns the port's (best_t, k0, k_end, paths)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    m_pad, d1 = st._shape_bucket(job)
    T = state.horizon
    T_pad = st._pad_tiles(T)
    psd = st._padded_state(state, dtype, T_pad)
    lane, _ = st._job_arrays_tiled(job, T, T_pad, m_pad)
    jd = st._stack_lanes([lane], T, dtype, state.device)
    out = st._decide_tiled_core(psd, jd, T=T, d1=d1, mono=mono)
    best_t, pay, rows, cost = int(out.best_t[0]), out.payoff[0], \
        out.rows[0], out.cost[0]
    k0, k_end, paths, live = out.k0, out.k_end, out.paths, out.live
    full = torch.cat([st._tile_rows(psd[0], jd, t0)[0]
                      for t0 in range(0, T_pad, TILE)])
    assert torch.equal(rows[k0 * TILE:k_end * TILE],
                       full[k0 * TILE:k_end * TILE])
    with jax.enable_x64(dtype == torch.float64):
        sd = tuple(jnp.asarray(x.numpy()) for x in psd[0])
        rlane, _ = sj._job_arrays_tiled(rjob, ref_state, T, T_pad, m_pad, jdt)
        res = sj._decide_tiled(
            sd, sj._stack_lanes([rlane], jdt),
            sj._dummy_tabs(jnp.dtype(jdt).name),
            jnp.asarray(full.numpy())[None],
            jnp.ones((1, T_pad // TILE), bool), T=T, d1=d1, use_cache=True,
            mono=mono, use_tabs=False)
        j_best_t, j_pay, j_rows, j_cost, j_k0, j_kend, j_paths = \
            jax.device_get(res)
    assert int(j_best_t[0]) == best_t
    assert _bits(np.asarray(j_pay[0]), np.asarray(pay))
    assert (int(j_k0), int(j_kend)) == (k0, k_end)
    assert list(np.asarray(j_paths)) == paths
    lo, hi = max(job.arrival, k0 * TILE), min(T, k_end * TILE)
    assert sum(live) == max(hi - lo, 0)
    assert [n > 0 for n in live] == [n > 0 for n in paths]
    assert _bits(cost[lo:hi].numpy(), j_cost[0, lo:hi])
    if best_t >= 0:
        a, d_tot = job.arrival, job.workload
        with jax.enable_x64(dtype == torch.float64):
            j_total, j_left, j_slots = jax.device_get(sj._backtrack(
                jnp.asarray(j_rows[0]), jnp.asarray(j_cost[0]),
                jnp.int32(best_t), jnp.int32(d_tot), jnp.int32(k0 * TILE)))
        d_left, d_slots = st._backtrack(
            rows[a:best_t + 1].numpy(),
            cost[a:best_t, :d_tot + 1].numpy(), a, best_t, d_tot)
        assert d_left == int(j_left) == 0
        assert np.array_equal(d_slots, np.asarray(j_slots)[:best_t + 1])
        assert _bits(cost[best_t, d_tot].numpy(), np.asarray(j_total))
    return best_t, k0, k_end, paths


def states(cluster, jobs):
    params = price_params_from_jobs(jobs, cluster)
    return (PriceState(compat.cluster(cluster), compat.price_params(params),
                       device="cpu"),
            RefPriceState(cluster, params))


def test_core_level2_equals_jax_on_shared_rows(jax_shims, monkeypatch):
    """Paper-scale jobs decided one after another (each accept committed
    to both states): the port's core at level 2 against the reference's
    ``_decide_tiled(mono=2)`` on the port's rows, and the port's decision
    with the switch on equal to its decision with the switch off."""
    cluster = make_cluster(T=100, H=50, K=50)
    jobs = make_jobs(200, T=100, seed=0, small=True)
    state, ref_state = states(cluster, jobs)
    totals = [0, 0, 0]
    order = sorted(jobs, key=lambda j: (j.arrival, j.jid))
    for rjob in order[:36]:
        rjob = ref_with_quantum(rjob, 0)
        job = compat.job(rjob)
        _, _, _, paths = core_parity(job, rjob, state, ref_state,
                                     torch.float64, mono=2)
        totals = [x + y for x, y in zip(totals, paths)]
        monkeypatch.setenv("REPRO_MONOTONE_DNC", "1")
        got = st.best_schedule_fused(job, state, core="tiled")
        monkeypatch.delenv("REPRO_MONOTONE_DNC")
        off = st.best_schedule_fused(job, state, core="tiled")
        assert (got is None) == (off is None)
        if got is not None:
            assert got.finish == off.finish and got.cost == off.cost
            for t in off.workers:
                assert np.array_equal(got.workers[t], off.workers[t])
            state.commit(job, got.workers, got.ps)
            ref_state.commit(rjob, got.workers, got.ps)
    assert totals[monotone.PATH_DNC] > 0 and totals[monotone.PATH_PLATEAU] > 0


# ---------------------------------------------------------------------------
# Trajectories with the switch on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_dnc_trajectory_equals_fast_paper_scale(seed, monkeypatch):
    want = simulate(make_cluster(T=100, H=50, K=50),
                    make_jobs(200, T=100, seed=seed, small=True),
                    scheduler="oasis", impl="fast", quantum=0)
    monkeypatch.setenv("REPRO_MONOTONE_DNC", "1")
    st.monotone_counters_reset()
    got = engine.run(workload.make_cluster(T=100, H=50, K=50),
                     workload.make_jobs(200, T=100, seed=seed, small=True),
                     device="cpu", quantum=0, core="tiled")
    snap = st.monotone_counters_snapshot()
    assert got.accepted == want.accepted
    assert got.completion == want.completion
    assert got.total_utility == want.total_utility
    assert snap["dnc"] > 0 and snap["dnc_slots"] > 0
    assert snap["decisions"] == 200 + snap["resolves"]


def test_switch_is_read_per_launch(monkeypatch):
    """``REPRO_MONOTONE_DNC`` unset or "0" keeps level 1 (no D&C tile)."""
    cluster = workload.make_cluster(T=40, H=6, K=6)
    jobs = workload.make_jobs(12, T=40, seed=2, small=True)
    for value in (None, "0", "1"):
        if value is None:
            monkeypatch.delenv("REPRO_MONOTONE_DNC", raising=False)
        else:
            monkeypatch.setenv("REPRO_MONOTONE_DNC", value)
        st.monotone_counters_reset()
        engine.run(cluster, jobs, device="cpu", quantum=0, core="tiled")
        snap = st.monotone_counters_snapshot()
        assert (snap["dnc"] > 0) == (value == "1"), value

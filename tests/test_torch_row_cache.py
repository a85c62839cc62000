"""The port's incremental decision state against full rebuilds and the
JAX package: the price state's dirty-slot log, the padded state per
version and the per-job ``RowCache``.

The cases of ``tests/test_row_cache.py``, ported (the window slide is
not ported, so no ``advance``), plus the port's own:

* ``dirty_spans_since``/``patch_spans`` equal the reference
  ``PriceState``'s after the same seeded commits and releases, through a
  trimmed log and mutable ``g``/``v`` access;
* the padded state of each version equals a full re-pad, and a tile's
  prefix tables equal the same slots of tables over the whole horizon,
  bit for bit;
* a re-solve through a synced ``RowCache`` equals a cold solve (rows of
  the visited tiles, cost, decision, placement) bit for bit, also when
  the log cannot name the dirty spans, and the
  reference's cached decision (finish slot and placements; cost to rel
  1e-12: XLA contracts the greedy costs' multiply-adds on this CPU).
"""
import numpy as np
import pytest
import torch

from _torch_parity import jax_shims  # noqa: F401  (fixture)
from repro.core import pricing as ref_pricing
from repro.core import schedule_jax as sj
from repro.core.pricing import PriceState as RefPriceState
from repro.core.pricing import price_params_from_jobs as ref_params
from repro.sim import make_cluster as ref_make_cluster
from repro.sim import make_jobs as ref_make_jobs
from repro_torch import compat
from repro_torch.core import pricing
from repro_torch.core import schedule_torch as st
from repro_torch.core.pricing import PriceState, price_params_from_jobs
from repro_torch.kernels.minplus.tiled import TILE
from repro_torch.sim.workload import make_cluster, make_jobs


def _rand_alloc(rng, T, S, max_count=2):
    """A random slot->counts allocation dict over a contiguous range."""
    t0 = int(rng.integers(0, T))
    t1 = int(rng.integers(t0, min(t0 + 6, T)))
    return {t: rng.integers(0, max_count + 1, size=S).astype(np.int64)
            for t in range(t0, t1 + 1)}


def _apply_random_ops(rng, states, jobs, committed, n_ops):
    """The same random commit/release sequence on every state of
    ``states`` (pairs of (state, job list))."""
    T = states[0][0].horizon
    H, K = states[0][0].cluster.H, states[0][0].cluster.K
    for _ in range(n_ops):
        if rng.integers(0, 2) == 0 or not committed:       # commit
            i = int(rng.integers(0, len(jobs)))
            w = _rand_alloc(rng, T, H)
            z = _rand_alloc(rng, T, K, max_count=1)
            for state, js in states:
                state.commit(js[i], w, z)
            committed.append((i, w, z))
        else:                                              # release
            i, w, z = committed.pop(int(rng.integers(0, len(committed))))
            for state, js in states:
                state.release(js[i], w, z)


def _setup(T, H, K, n, seed, small=True):
    cluster = make_cluster(T=T, H=H, K=K)
    jobs = make_jobs(n, T=T, seed=seed, small=small)
    state = PriceState(cluster, price_params_from_jobs(jobs, cluster),
                       device="cpu")
    return state, jobs


# -- the dirty-slot log ------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("log_max", [4096, 6])
def test_dirty_spans_equal_reference(monkeypatch, seed, log_max):
    monkeypatch.setattr(pricing, "_DIRTY_LOG_MAX", log_max)
    monkeypatch.setattr(ref_pricing, "_DIRTY_LOG_MAX", log_max)
    T = 30
    rcluster = ref_make_cluster(T=T, H=3, K=3)
    rjobs = ref_make_jobs(6, T=T, seed=seed, small=True)
    ref = RefPriceState(rcluster, ref_params(rjobs, rcluster))
    port = compat.price_state(ref, device="cpu")
    jobs = [compat.job(j) for j in rjobs]
    assert port.version == ref.version
    rng = np.random.default_rng(seed)
    committed = []
    for rnd in range(8):
        _apply_random_ops(rng, [(port, jobs), (ref, rjobs)], rjobs,
                          committed, n_ops=int(rng.integers(1, 4)))
        assert port.version == ref.version
        for v in range(-1, port.version + 2):
            assert port.dirty_spans_since(v) == ref.dirty_spans_since(v), v
            for limit in (1, 3, 8):
                assert port.patch_spans(v, limit) == ref.patch_spans(
                    v, limit), (v, limit)
        if rnd == 5:
            _ = port.g, ref.g
            assert port.dirty_spans_since(port.version) is None
        port.device_state()      # the residency does not touch the log


def test_dirty_span_log_semantics():
    """dirty_spans_since: exact spans for commits, None past the floor."""
    state, jobs = _setup(16, 2, 2, 3, 0)
    v0 = state.version
    assert state.dirty_spans_since(v0) == []
    w = {4: np.array([1, 0], np.int64), 6: np.array([0, 1], np.int64)}
    z = {5: np.array([1, 0], np.int64)}
    state.commit(jobs[0], w, z)
    spans = state.dirty_spans_since(v0)
    assert spans is not None and len(spans) == 2
    covered = set()
    for t0, t1 in spans:
        covered.update(range(t0, t1))
    assert {4, 5, 6} <= covered                    # every touched slot dirty
    assert state.dirty_spans_since(state.version) == []
    assert state.patch_spans(v0, limit=1) is None
    # mutable g/v access invalidates even current-version caches
    v1 = state.version
    _ = state.g
    assert state.dirty_spans_since(v1) is None
    state.v = np.zeros_like(state._v_host)
    assert state.dirty_spans_since(state.version) is None


# -- the padded state and the tile tables ------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_padded_state_equals_full_repad(seed):
    """``_padded_state`` is computed once per version, and every version's
    equals ``_pad_state`` from scratch; the prices equal the host
    expression on the full mirror."""
    state, jobs = _setup(150, 4, 3, 6, seed)
    rng = np.random.default_rng(seed)
    committed = []
    T_pad = st._pad_tiles(state.horizon)
    for rnd in range(8):
        got = st._padded_state(state, torch.float64, T_pad)
        assert st._padded_state(state, torch.float64, T_pad) is got
        sd, pr = state.device_state(), state.device_prices()
        want = st._pad_state(sd, pr, T_pad)
        for k, w in zip((0, 1, 8, 9, 10), want):
            assert torch.equal(got[0][k], w), (rnd, k)
        assert np.array_equal(got[1], want[2].numpy())
        full = PriceState(state.cluster, state.params, device="cpu")
        full.g, full.v = state._g_host.copy(), state._v_host.copy()
        for a, b in zip(full.device_prices(), pr):
            assert torch.equal(a, b)
        _apply_random_ops(rng, [(state, jobs)], jobs, committed,
                          n_ops=int(rng.integers(1, 4)))
        assert st._padded_state(state, torch.float64, T_pad) is not got


@pytest.mark.parametrize("T,H,K", [(150, 4, 3), (2 * TILE + 2, 6, 5)])
def test_tile_tables_equal_whole_horizon_slices(T, H, K):
    """``_prefix_tables_b`` is slot-local: over one tile's slots it gives
    the bits of the whole horizon's tables there, for every lane — what
    lets the row cache keep a tile's rows while other tiles change."""
    state, jobs = _setup(T, H, K, 8, T)
    rng = np.random.default_rng(T)
    _apply_random_ops(rng, [(state, jobs)], jobs, [], n_ops=6)
    T_pad = st._pad_tiles(T)
    psd, _ = st._padded_state(state, torch.float64, T_pad)
    g, v, wcaps, scaps = psd[:4]
    demand = torch.tensor(np.stack([j.worker_res for j in jobs[:3]]),
                          dtype=torch.float64)
    whole = st._prefix_tables_b(psd[9], wcaps[None] - g, demand)
    for t0 in range(0, T_pad, TILE):
        sl = slice(t0, t0 + TILE)
        tile = st._prefix_tables_b(psd[9][sl], wcaps[None] - g[sl], demand)
        for a, b in zip(tile, whole):
            assert torch.equal(a, b[:, sl]), t0


def _resolve_roundtrip(seed, n_rounds=4, n_ops=3, drop_residency=False):
    """A job re-solved through its synced ``RowCache`` after each round of
    commits and releases equals a cold solve, bit for bit; when host
    access leaves the delta unknowable, ``sync`` invalidates every tile."""
    state, jobs = _setup(24, 3, 3, 6, seed % 997)
    job = jobs[0]
    cache = st.RowCache.empty(state, job)
    if cache is None:
        pytest.skip("degenerate job")
    rng = np.random.default_rng(seed)
    committed = []
    for rounds in range(n_rounds):
        cache.sync(state)
        got = st.best_schedule_fused(job, state, core="tiled",
                                     row_cache=cache)
        assert cache.version == state.version, (seed, rounds)
        _same(got, st.best_schedule_fused(job, state, core="tiled"))
        _apply_random_ops(rng, [(state, jobs)], jobs, committed, n_ops)
        if drop_residency:
            _ = state.g          # host access: spans unknowable
            cache.sync(state)
            assert not cache.valid.any(), (seed, rounds)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("drop_residency", [False, True])
def test_row_cache_resolve_randomized(seed, drop_residency):
    _resolve_roundtrip(200 + seed, drop_residency=drop_residency)


# -- rows through the RowCache -------------------------------------------------

def _host_roundtrip(seed, n_rounds=6, n_ops=3):
    """Rows kept across versions by recomputing only the tiles the dirty
    spans touch equal rows rebuilt in full, after every round."""
    state, jobs = _setup(150, 3, 3, 6, seed)
    job = jobs[0]
    key = st._shape_bucket(job)
    if key is None:
        pytest.skip("degenerate job")
    T = state.horizon
    T_pad = st._pad_tiles(T)
    lane, _ = st._job_arrays_tiled(job, T, T_pad, key[0])
    jd = st._stack_lanes([lane], T, torch.float64, state.device)

    def tile(k):
        psd = st._padded_state(state, torch.float64, T_pad)
        return st._tile_rows(psd[0], jd, k * TILE)[0]

    n_tiles = T_pad // TILE
    cached = [tile(k) for k in range(n_tiles)]
    version = state.version
    rng = np.random.default_rng(seed)
    committed = []
    for _ in range(n_rounds):
        _apply_random_ops(rng, [(state, jobs)], jobs, committed, n_ops)
        cache = st.RowCache(rows=None, valid=np.ones(n_tiles, bool),
                            version=version, m_pad=key[0], d1=key[1])
        cache.sync(state)
        for k in np.flatnonzero(~cache.valid):
            cached[k] = tile(k)
        version = state.version
        for k in range(n_tiles):
            assert torch.equal(cached[k], tile(k)), (seed, k)


@pytest.mark.parametrize("seed", range(4))
def test_host_row_cache_randomized(seed):
    _host_roundtrip(seed)


def _same(got, want, exact=True):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert got.finish == want.finish
    if exact:
        assert got.cost == want.cost and got.payoff == want.payoff
    else:
        assert got.cost == pytest.approx(want.cost, rel=1e-12, abs=0)
    assert sorted(got.workers) == sorted(want.workers)
    for t in want.workers:
        assert np.array_equal(got.workers[t], want.workers[t])
        assert np.array_equal(got.ps[t], want.ps[t])


@pytest.mark.parametrize("seed", range(3))
def test_device_row_cache_randomized(jax_shims, seed):
    """A re-solve through a synced cache == a cold solve, bit for bit
    (rows of the visited tiles included), and == the reference's cached
    decision, across interleaved commits and releases."""
    import jax
    T = 150
    rcluster = ref_make_cluster(T=T, H=3, K=3)
    rjobs = ref_make_jobs(6, T=T, seed=100 + seed, small=True)
    ref = RefPriceState(rcluster, ref_params(rjobs, rcluster))
    state = compat.price_state(ref, device="cpu")
    jobs = [compat.job(j) for j in rjobs]
    job, rjob = jobs[0], rjobs[0]
    cache = st.RowCache.empty(state, job)
    rcache = sj.RowCache.empty(ref, rjob)
    if cache is None:
        pytest.skip("degenerate job")
    rng = np.random.default_rng(seed)
    committed = []
    for rounds in range(5):
        cache.sync(state)
        rcache.sync(ref)
        got = st.best_schedule_fused(job, state, core="tiled",
                                     row_cache=cache)
        m_pad, d1 = st._shape_bucket(job)
        cold = st._decide_jobs([(0, job)], state, m_pad, d1)[0]
        want = st._materialize(cold, state)
        _same(got, want)
        for k in np.flatnonzero(cold.cache.valid):
            sl = slice(k * TILE, (k + 1) * TILE)
            assert cache.valid[k]
            assert torch.equal(cache.rows[sl], cold.rows_full[0, sl])
        with jax.enable_x64(True):
            rgot = sj.best_schedule_fused(rjob, ref, use_pallas=False,
                                          row_cache=rcache)
        _same(got, rgot, exact=False)
        _apply_random_ops(rng, [(state, jobs), (ref, rjobs)], rjobs,
                          committed, n_ops=3)


@pytest.mark.parametrize("seed", [2, 0])
def test_row_cache_reuses_valid_tiles(seed):
    """After sync, only tiles overlapping the dirty spans are invalid, and
    a re-solve serves the others (seed 0's job visits three tiles)."""
    T = 2 * TILE + 2                               # multi-tile horizon
    state, jobs = _setup(T, 3, 3, 6, seed)
    job = jobs[0]
    cache = st.RowCache.empty(state, job)
    assert cache is not None and len(cache.valid) >= 3
    assert not cache.valid.any()
    st.best_schedule_fused(job, state, core="tiled", row_cache=cache)
    assert cache.valid.any()                       # visited tiles recorded
    valid_before = cache.valid.copy()
    # a commit inside tile 0 dirties only tile 0
    state.commit(jobs[1], {1: np.array([1, 0, 0], np.int64)}, {})
    cache.sync(state)
    assert not cache.valid[0]
    assert np.array_equal(cache.valid[1:], valid_before[1:])
    # the re-solve serves the still-valid visited tiles from the cache
    st.monotone_counters_reset()
    got = st.best_schedule_fused(job, state, core="tiled", row_cache=cache)
    snap = st.monotone_counters_snapshot()
    _same(got, st.best_schedule_fused(job, state, core="tiled"))
    assert snap["resolves"] == 1
    assert snap["cache_tiles"] > 0 or not valid_before[1:].any()
    assert seed or snap["cache_tiles"] > 0
    with pytest.raises(ValueError, match="tiled"):
        st.best_schedule_fused(job, state, row_cache=cache)


# -- hypothesis variant ------------------------------------------------------

try:
    from hypothesis import given, settings, strategies as st_h
    HAVE_HYPOTHESIS = True
except ImportError:                                # pragma: no cover
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    @settings(max_examples=15, deadline=None)
    @given(seed=st_h.integers(0, 2 ** 16), n_rounds=st_h.integers(1, 6),
           n_ops=st_h.integers(1, 5))
    def test_host_row_cache_hypothesis(seed, n_rounds, n_ops):
        _host_roundtrip(seed, n_rounds=n_rounds, n_ops=n_ops)

    @settings(max_examples=10, deadline=None)
    @given(seed=st_h.integers(0, 2 ** 16), n_rounds=st_h.integers(1, 5),
           n_ops=st_h.integers(1, 4), drop_residency=st_h.booleans())
    def test_row_cache_resolve_hypothesis(seed, n_rounds, n_ops,
                                          drop_residency):
        _resolve_roundtrip(seed, n_rounds=n_rounds, n_ops=n_ops,
                           drop_residency=drop_residency)

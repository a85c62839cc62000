"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
(nvcc, sm_90a, at first use, one nvcc per source started together),
holds every kernel against its plain PyTorch version on the card, checks
both decision routes on the card against the port on the CPU at paper
scale, then drives the main paths — ``repro_torch.sim.engine.run`` with
``core="whole"`` and ``core="tiled"`` — at the repo's 10x instance
(T=500, 100+100 servers, 2000 full-size jobs, seed 0, quantum=0), each
with the kernel counts set to 0 just before it and read just after: every
DP decision of the whole route went through the CUDA sweep, every live
slot of the tiled route through the one-slot or the plateau kernel.
Unquantized full-size jobs (d1 up to 20480) then go through both routes.
Exits non-zero on any failure, and without a CUDA device before printing
any result.

Output: one line per phase; then the kernels' JSON line, the card's
name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels.build import library_path  # noqa: E402
from repro_torch.kernels.minplus import kernel as minplus_kernel  # noqa: E402
from repro_torch.kernels.minplus.monotone import (  # noqa: E402
    plateau_step, run_count)
from repro_torch.kernels.minplus.ref import (  # noqa: E402
    minplus_ref, minplus_sweep_ref)
from repro_torch.core import schedule_torch  # noqa: E402
from repro_torch.core.pricing import price_params_from_jobs  # noqa: E402
from repro_torch.core.schedule_torch import _shape_bucket  # noqa: E402
from repro_torch.sim import engine  # noqa: E402
from repro_torch.sim.workload import make_cluster, make_jobs  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): vector (non-tensor)
# rates per dtype and the HBM3 bandwidth
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12

# tests/test_kernels.py's sweep shapes, then the slice's: T in {100, 500},
# d1 = 1280, every m_pad bucket the 10x instance produces
TEST_SHAPES = [(3, 2, 6), (9, 17, 33), (16, 65, 300), (8, 64, 1280),
               (4, 640, 1280)]
M_PADS = (64, 128, 256, 384, 512, 640)
SLICE_SHAPES = [(T, m, 1280) for T in (100, 500) for m in M_PADS]
# unquantized full-size jobs: d1 = 20480 with the narrowest band and the
# widest of the T=100 trace (2688) and of the 10x trace (8960)
WIDE_SHAPES = [(100, m, 20480) for m in (64, 2688, 8960)]
SCALE = {"T": 500, "H": 100, "K": 100, "n": 2000}
# the one-slot kernels: tests/test_kernels.py's and the slice's shapes,
# the 10x buckets, the wide jobs'
SLOT_TEST_SHAPES = [(1, 1), (2, 5), (17, 129), (65, 1281), (641, 1281)]
SLOT_SCALE_SHAPES = [(m, 1280) for m in M_PADS]
SLOT_WIDE_SHAPES = [(64, 20480), (2688, 20480), (8960, 20480)]
R_MAX = 16
# the reference's tiled engine on this 10x instance, on a CPU
# (BENCH_decision.json sim_scale.utility.oasis)
JAX_TILED_UTILITY = 7082.083469185378


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _rows(T, dc1, d1, dtype):
    """Seeded COST-row stand-ins: 40% +inf, column 0 free."""
    rng = np.random.default_rng(T * d1 + dc1)
    rows = rng.random((T, dc1))
    rows[rng.random((T, dc1)) < 0.4] = np.inf
    rows[:, 0] = 0.0
    return torch.tensor(rows, dtype=dtype, device="cuda")


def _time_ms(fn, reps):
    fn()                                        # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(T, dc1, d1, dtype, want_split):
    """(ms over the ops peak, ms over HBM) for one sweep: 2 ops (add,
    min) per candidate at the vector peak; each input read and each output
    written once.  The bound is the larger."""
    size = dtype.itemsize
    ops = 2.0 * T * d1 * dc1
    nbytes = T * dc1 * size + T * d1 * (size + (4 if want_split else 0))
    return ops / PEAK_OPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3


def _device_ms(fn, reps):
    """Device time per launch of ``fn``'s kernel, back to back: the card
    first spins for ~10 ms (``torch.cuda._sleep``) while the host enqueues
    all ``reps`` launches behind it, so the events time the launches as
    the card runs them, not the host's enqueue of microsecond launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _self_device_ms(event):
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0)) / 1e3


def kernel_phase():
    """The sweep == its plain version bitwise, cost and split, f32 and
    f64, at every placement its plan picks; the cost-only sweep (the
    whole route's form) timed against the plain one."""
    t0 = time.perf_counter()
    minplus_kernel.load_libraries()
    print(f"build: {', '.join(p.name for p in minplus_kernel.SOURCES.values())}"
          f" in {time.perf_counter() - t0:.3f} s (one nvcc each, together)")
    for name, src in minplus_kernel.SOURCES.items():
        for line in library_path(src).with_suffix(
                ".log").read_text().splitlines():
            if "registers" in line or "smem" in line:
                print(f"  ptxas {name}:", line.strip())
    max_err = 0.0
    timings = {}
    for T, dc1, d1 in TEST_SHAPES + SLICE_SHAPES + WIDE_SHAPES:
        for dtype in (torch.float32, torch.float64):
            rows = _rows(T, dc1, d1, dtype)
            cost, split = minplus_kernel.minplus_sweep_cuda(rows, d1 - 1)
            cost_only, _ = minplus_kernel.minplus_sweep_cuda(
                rows, d1 - 1, want_split=False)
            ref_cost, ref_split = minplus_sweep_ref(rows, d1 - 1)
            torch.cuda.synchronize()
            same_inf = torch.equal(torch.isinf(cost), torch.isinf(ref_cost))
            bitwise = (torch.equal(cost, ref_cost)
                       and torch.equal(cost_only, ref_cost)
                       and torch.equal(split, ref_split))
            fin = torch.isfinite(ref_cost)
            err = float((cost[fin] - ref_cost[fin]).abs().max()) \
                if fin.any() else 0.0
            max_err = max(max_err, err)
            if not (same_inf and bitwise):
                raise AssertionError(
                    f"minplus_sweep {T}x{dc1}->{d1} {dtype}: kernel differs "
                    f"from the plain version (max abs err {err})")
            if (T, dc1, d1) in SLICE_SHAPES + WIDE_SHAPES:
                wide = (T, dc1, d1) in WIDE_SHAPES
                k_ms = _time_ms(lambda: minplus_kernel.minplus_sweep_cuda(
                    rows, d1 - 1, want_split=False), reps=1 if wide else 5)
                p_ms = _time_ms(lambda: minplus_sweep_ref(rows, d1 - 1),
                                reps=1 if wide else 2)
                op_ms, byte_ms = _bound_ms(T, dc1, d1, dtype,
                                           want_split=False)
                b_ms = max(op_ms, byte_ms)
                timings[(T, dc1, d1, dtype)] = (k_ms, p_ms, b_ms, op_ms,
                                                byte_ms)
                plan = minplus_kernel.sweep_plan(dc1, d1, dtype)
                print(f"sweep T={T} m_pad={dc1} d1={d1} "
                      f"{str(dtype).split('.')[-1]} placement={plan.mode}: "
                      f"kernel_ms={k_ms!r} plain_ms={p_ms!r} "
                      f"bound_ms={b_ms!r} bitwise=True")
    n = len(TEST_SHAPES + SLICE_SHAPES + WIDE_SHAPES) * 2
    print(f"kernel phase ok: {n} sweep shape/dtype cases bitwise equal, "
          f"max_abs_err={max_err!r}")
    return max_err, timings


def _row_prev(dc1, d1, dtype, runs=None):
    """Seeded slot inputs on the card: a row with +inf cells (or exactly
    ``runs`` runs of equal values) and a carry with +inf cells."""
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


def _slot_bounds(row, d1, dtype, plateau):
    """(ms over the ops peak, ms over HBM) for one cost-only slot on these
    inputs.  One-slot kernel: an add and a compare per candidate
    ``j <= min(DC, d)``.  Plateau kernel: the doubling table's minima up
    to the level the longest run needs over the D+1+DC window, then an
    add and two minima per run and output.  Bytes: row and carry read,
    output written, once."""
    dc1 = row.numel()
    size = dtype.itemsize
    if plateau:
        h = row.cpu().numpy()
        starts = np.flatnonzero(np.concatenate([[True], h[1:] != h[:-1]]))
        lengths = np.diff(np.concatenate([starts, [dc1]]))
        levels = int(lengths.max()).bit_length() - 1
        ops = levels * (d1 + dc1) + 3.0 * len(starts) * d1
    else:
        cand = sum(min(dc1, d + 1) for d in range(d1))
        ops = 2.0 * cand
    nbytes = (dc1 + 2 * d1) * size
    return ops / PEAK_OPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3


def slot_phase():
    """The one-slot kernel (cost + argmin, and cost only) and the plateau
    kernel (run counts 1, r_max - 1, r_max) == their plain versions
    bitwise, f32 and f64; at the main path's shapes each timed (device
    time per launch) against its plain version."""
    max_err = {"slot": 0.0, "plateau": 0.0}
    timings = {}
    cases = 0
    for dc1, d1 in SLOT_TEST_SHAPES + SLOT_SCALE_SHAPES + SLOT_WIDE_SHAPES:
        for dtype in (torch.float32, torch.float64):
            row, prev = _row_prev(dc1, d1, dtype)
            new, arg = minplus_kernel.minplus_cuda(row, prev)
            cost_only, _ = minplus_kernel.minplus_cuda(row, prev,
                                                       want_arg=False)
            ref_new, ref_arg = minplus_ref(row, prev)
            torch.cuda.synchronize()
            if not (torch.equal(new, ref_new) and torch.equal(arg, ref_arg)
                    and torch.equal(cost_only, ref_new)):
                raise AssertionError(f"minplus_slot {dc1}->{d1} {dtype}: "
                                     "kernel differs from the plain version")
            cases += 1
            runs_set = sorted({min(r, dc1) for r in (1, R_MAX - 1, R_MAX)})
            for runs in runs_set:
                prow, _ = _row_prev(dc1, d1, dtype, runs=runs)
                got = minplus_kernel.minplus_plateau_cuda(prow, prev,
                                                          r_max=R_MAX)
                want = plateau_step(prow, prev)
                torch.cuda.synchronize()
                if not (int(run_count(prow)) == runs
                        and torch.equal(got, want)
                        and torch.equal(got, minplus_ref(prow, prev)[0])):
                    raise AssertionError(
                        f"minplus_plateau {dc1}->{d1} {dtype} runs={runs}: "
                        "kernel differs from the plain version")
                cases += 1
            if dtype != torch.float64 or (dc1, d1) in SLOT_TEST_SHAPES:
                continue
            out = torch.empty_like(prev)
            prow, _ = _row_prev(dc1, d1, dtype, runs=min(R_MAX, dc1))
            for kind, fn, plain, x_row in (
                    ("slot", lambda: minplus_kernel.minplus_cuda(
                        row, prev, want_arg=False, out=out),
                     lambda: minplus_ref(row, prev), row),
                    ("plateau", lambda: minplus_kernel.minplus_plateau_cuda(
                        prow, prev, r_max=R_MAX, out=out),
                     lambda: plateau_step(prow, prev), prow)):
                wide = (dc1, d1) in SLOT_WIDE_SHAPES
                k_ms = _device_ms(fn, 5 if wide else 50)
                p_ms = _time_ms(plain, reps=1 if wide else 10)
                op_ms, byte_ms = _slot_bounds(x_row, d1, dtype,
                                              kind == "plateau")
                timings[(kind, dc1, d1)] = (k_ms, p_ms, max(op_ms, byte_ms),
                                            op_ms, byte_ms)
                print(f"{kind} m_pad={dc1} d1={d1} float64: "
                      f"kernel_device_ms={k_ms!r} plain_ms={p_ms!r} "
                      f"bound_ms={max(op_ms, byte_ms)!r} ("
                      f"{'operations' if op_ms >= byte_ms else 'bytes'}; "
                      "launch latency floors a launch this small) "
                      "bitwise=True")
    print(f"slot phase ok: {cases} one-slot and plateau shape/dtype/run "
          f"cases bitwise equal, max_abs_err={max_err!r}")
    return max_err, timings


def _counted():
    return (minplus_kernel.minplus_sweep_cuda.launches,
            minplus_kernel.minplus_cuda.launches,
            minplus_kernel.minplus_plateau_cuda.launches)


def _reset_counts():
    minplus_kernel.minplus_sweep_cuda.launches = 0
    minplus_kernel.minplus_cuda.launches = 0
    minplus_kernel.minplus_plateau_cuda.launches = 0
    schedule_torch.monotone_counters_reset()


def paper_phase():
    """Both routes on the card against the port on the CPU, paper scale:
    the whole route on the card == on the CPU, and the tiled route on the
    card == the tiled route on the CPU == the whole route (both are held
    to the reference's impl="fast" there), with the plateau kernel
    firing."""
    for seed in (0, 2):
        cluster = make_cluster(T=100, H=50, K=50)
        jobs = make_jobs(200, T=100, seed=seed, small=True)
        gpu = engine.run(cluster, jobs, quantum=0)
        cpu = engine.run(cluster, jobs, quantum=0, device="cpu")
        same_set = set(gpu.schedules) == set(cpu.schedules)
        rel = abs(gpu.total_utility - cpu.total_utility) / max(
            abs(cpu.total_utility), 1e-300)
        counts_differ = sum(
            1 for j in gpu.schedules if j in cpu.schedules
            and {t: int(y.sum()) for t, y in gpu.schedules[j].workers.items()}
            != {t: int(y.sum()) for t, y in cpu.schedules[j].workers.items()})
        print(f"paper scale seed {seed}: accepted gpu={gpu.accepted} "
              f"cpu={cpu.accepted} same_set={same_set} "
              f"same_completion={gpu.completion == cpu.completion} "
              f"utility gpu={gpu.total_utility!r} cpu={cpu.total_utility!r} "
              f"rel_diff={rel!r} schedules_with_other_slot_counts="
              f"{counts_differ}")
        if not (same_set and gpu.completion == cpu.completion
                and rel <= 1e-9):
            raise AssertionError(f"seed {seed}: the card's trajectory "
                                 "differs from the CPU's")
        _reset_counts()
        tgpu = engine.run(cluster, jobs, quantum=0, core="tiled")
        snap = schedule_torch.monotone_counters_snapshot()
        _, a_n, b_n = _counted()
        tcpu = engine.run(cluster, jobs, quantum=0, core="tiled",
                          device="cpu")
        rels = [abs(tgpu.total_utility - x.total_utility)
                / max(abs(x.total_utility), 1e-300) for x in (tcpu, gpu)]
        print(f"paper scale seed {seed}, tiled: accepted gpu={tgpu.accepted}"
              f" cpu={tcpu.accepted} utility gpu={tgpu.total_utility!r} "
              f"cpu={tcpu.total_utility!r} rel_diff_cpu={rels[0]!r} "
              f"rel_diff_whole_gpu={rels[1]!r} plateau_tiles="
              f"{snap['plateau']} chain_tiles={snap['chain']} "
              f"slot_launches={a_n} plateau_launches={b_n}")
        if not (tgpu.completion == tcpu.completion == gpu.completion
                and max(rels) <= 1e-9 and snap["plateau"] > 0
                and a_n + b_n == snap["slots"] and b_n > 0):
            raise AssertionError(f"seed {seed}: the tiled route on the card "
                                 "differs from the CPU's or the whole "
                                 "route's, or took no plateau tile")


def scale_phase():
    """The whole route at the 10x instance, counting sweep launches."""
    cluster = make_cluster(T=SCALE["T"], H=SCALE["H"], K=SCALE["K"])
    jobs = make_jobs(SCALE["n"], T=SCALE["T"], seed=0)
    live = [engine._with_quantum(j, 0) for j in jobs if j.arrival < cluster.T]
    buckets = [_shape_bucket(j) for j in live]
    dp_decisions = sum(b is not None for b in buckets)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.run(cluster, jobs, quantum=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, a_n, b_n = _counted()
    ds = np.asarray(res.decision_seconds) * 1e3
    print(f"10x instance (T={SCALE['T']}, H=K={SCALE['H']}, "
          f"{SCALE['n']} jobs, seed 0, quantum=0), whole route: "
          f"wall_s={wall!r} "
          f"decisions={len(ds)} decisions_per_s={len(ds) / wall!r} "
          f"decision_p50_ms={float(np.percentile(ds, 50))!r} "
          f"decision_p95_ms={float(np.percentile(ds, 95))!r} "
          f"total_utility={res.total_utility!r} accepted={res.accepted} "
          f"device_uploads={res.device_uploads} "
          f"minplus_sweep_launches={launches} dp_decisions={dp_decisions}")
    if launches != dp_decisions or a_n or b_n:
        raise AssertionError(f"{launches} sweep launches for "
                             f"{dp_decisions} DP decisions ({a_n} + {b_n} "
                             "slot launches)")
    if len(ds) != len(live) or res.device_uploads != 1:
        raise AssertionError("decision count or upload count is off")
    if not (np.isfinite(res.total_utility) and res.total_utility > 0
            and 0 < res.accepted <= len(live)):
        raise AssertionError(f"implausible result: {res.total_utility} "
                             f"utility, {res.accepted} accepted")
    hist = {}
    for b in buckets:
        if b is not None:
            hist[b[0]] = hist.get(b[0], 0) + 1
    print(f"10x sweep shapes (m_pad: launches): {dict(sorted(hist.items()))}")
    return launches, hist, res.total_utility


def tiled_scale_phase(whole_utility):
    """The tiled route at the 10x instance, counting slot launches: one
    launch of the one-slot or the plateau kernel per live visited slot."""
    cluster = make_cluster(T=SCALE["T"], H=SCALE["H"], K=SCALE["K"])
    jobs = make_jobs(SCALE["n"], T=SCALE["T"], seed=0)
    live = [engine._with_quantum(j, 0) for j in jobs if j.arrival < cluster.T]
    dp_decisions = sum(_shape_bucket(j) is not None for j in live)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.run(cluster, jobs, quantum=0, core="tiled", check=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sweeps, a_n, b_n = _counted()
    snap = schedule_torch.monotone_counters_snapshot()
    ds = np.asarray(res.decision_seconds) * 1e3
    tiles = snap["plateau"] + snap["chain"]
    print(f"10x instance, tiled route: wall_s={wall!r} decisions={len(ds)} "
          f"decisions_per_s={len(ds) / wall!r} "
          f"decision_p50_ms={float(np.percentile(ds, 50))!r} "
          f"decision_p95_ms={float(np.percentile(ds, 95))!r} "
          f"total_utility={res.total_utility!r} accepted={res.accepted} "
          f"device_uploads={res.device_uploads} "
          f"minplus_slot_launches={a_n} minplus_plateau_launches={b_n} "
          f"live_slots={snap['slots']} tiles_visited={tiles} "
          f"tiles_per_decision={tiles / max(snap['decisions'], 1)!r} "
          f"slot_launches_per_decision="
          f"{(a_n + b_n) / max(snap['decisions'], 1)!r} "
          f"paths={{'plateau': {snap['plateau']}, 'chain': {snap['chain']}}}")
    print(f"10x utility: tiled route {res.total_utility!r}, whole route "
          f"{whole_utility!r}, reference tiled engine on a CPU "
          f"{JAX_TILED_UTILITY!r}")
    if (a_n + b_n != snap["slots"] or sweeps or a_n == 0
            or snap["decisions"] != dp_decisions):
        raise AssertionError(f"{a_n} + {b_n} slot launches for "
                             f"{snap['slots']} live slots, {sweeps} sweeps, "
                             f"{snap['decisions']} of {dp_decisions} DP "
                             "decisions")
    if len(ds) != len(live) or res.device_uploads != 1:
        raise AssertionError("decision count or upload count is off")
    if not (np.isfinite(res.total_utility) and res.total_utility > 0
            and 0 < res.accepted <= len(live)):
        raise AssertionError(f"implausible result: {res.total_utility} "
                             f"utility, {res.accepted} accepted")
    return a_n, b_n


def wide_phase():
    """Unquantized full-size jobs (d1 up to 20480, m_pad up to 2688)
    through both routes on the card, feasibility checked."""
    cluster = make_cluster(T=100, H=20, K=20)
    jobs = make_jobs(40, T=100, seed=1)
    wide = sum(1 for j in jobs if (_shape_bucket(j) or (0, 0))[1] == 20480)
    for core in ("whole", "tiled"):
        _reset_counts()
        t0 = time.perf_counter()
        res = engine.run(cluster, jobs, core=core, check=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sweeps, a_n, b_n = _counted()
        print(f"wide jobs (T=100, H=K=20, 40 full-size jobs, seed 1, "
              f"quantum=None; {wide} with d1=20480), {core} route: "
              f"wall_s={wall!r} accepted={res.accepted} "
              f"total_utility={res.total_utility!r} sweep_launches={sweeps} "
              f"slot_launches={a_n} plateau_launches={b_n}")
        if not (np.isfinite(res.total_utility) and res.accepted > 0):
            raise AssertionError(f"wide jobs, {core} route: implausible "
                                 "result")


def profile_phase(core, n_jobs=400):
    """Where the time goes: a traced run of the 10x trace's first
    ``n_jobs`` arrivals through ``core`` (same price parameters as the
    full run, so these are the main run's first decisions); device busy =
    the sum of device self time over all traced ops (one stream, so they
    do not overlap).  Returns {kernel: (device ms, launches)}."""
    from torch.profiler import ProfilerActivity, profile
    cluster = make_cluster(T=SCALE["T"], H=SCALE["H"], K=SCALE["K"])
    jobs = make_jobs(SCALE["n"], T=SCALE["T"], seed=0)
    params = price_params_from_jobs(jobs, cluster)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = engine.run(cluster, jobs[:n_jobs], params=params, quantum=0,
                         core=core)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev, calls = {}, {}
    for e in prof.key_averages():
        ms = _self_device_ms(e)
        if ms > 0:
            dev[e.key] = dev.get(e.key, 0.0) + ms
            calls[e.key] = calls.get(e.key, 0) + e.count
    busy = sum(dev.values())
    kernels = {}
    for name in ("minplus_sweep_kernel", "minplus_slot_kernel",
                 "minplus_plateau_kernel"):
        keys = [k for k in dev if name in k]
        if keys:
            kernels[name] = (sum(dev[k] for k in keys),
                             sum(calls[k] for k in keys))
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile ({core} route, 10x trace, first {n_jobs} jobs, traced): "
          f"decisions={len(res.decision_seconds)} wall_ms={wall_ms!r} "
          f"device_busy_ms={busy!r} device_idle_share="
          f"{1.0 - busy / wall_ms!r} " + " ".join(
              f"{k}_ms={v[0]!r} {k}_launches={v[1]} "
              f"{k}_ms_per_launch={v[0] / max(v[1], 1)!r}"
              for k, v in kernels.items()))
    for k, ms in top:
        print(f"  device {ms!r} ms: {k[:90]}")
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = _card()
    print(card, flush=True)
    max_err, timings = kernel_phase()
    slot_err, slot_timings = slot_phase()
    paper_phase()
    launches, hist, whole_utility = scale_phase()
    a_launches, b_launches = tiled_scale_phase(whole_utility)
    wide_phase()
    profile_phase("whole")
    profile_phase("tiled")
    # sweep: launch-weighted means over the whole route's 10x sweep shapes
    # (f64, cost only); one-slot kernel: means over the same m_pad mix at
    # d1 = 1280 (f64, cost only, device time per launch); plateau kernel:
    # its one 10x shape (m_pad 64, d1 1280, r_max runs)
    n = sum(hist.values())
    mean = [sum(hist[m] * timings[(SCALE["T"], m, 1280, torch.float64)][i]
                for m in hist) / n for i in range(5)]
    slot = [sum(hist[m] * slot_timings[("slot", m, 1280)][i]
                for m in hist) / n for i in range(5)]
    plat = slot_timings[("plateau", 64, 1280)]
    src = "src/repro_torch/kernels/minplus/csrc/"
    ref = "src/repro/kernels/minplus/kernel.py:"
    rows = [("minplus_sweep", "minplus_sweep.cu", "125", launches, max_err,
             mean),
            ("minplus_slot", "minplus_slot.cu", "54", a_launches,
             slot_err["slot"], slot),
            ("minplus_plateau", "minplus_plateau.cu", "207", b_launches,
             slot_err["plateau"], plat)]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src + file,
        "replaces": ref + line, "launches": n_launch, "max_abs_err": err,
        "ms": t[0], "plain_ms": t[1], "bound_ms": t[2],
        "bound_by": "operations" if t[3] >= t[4] else "bytes",
        "library_ms": None} for name, file, line, n_launch, err, t in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

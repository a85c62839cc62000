"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
(nvcc, sm_90a, at first use), holds every kernel against its plain
PyTorch version on the card, checks the OASiS slice on the card against
the port on the CPU at paper scale, then drives the slice's main path —
``repro_torch.sim.engine.run`` — at the repo's 10x instance (T=500,
100+100 servers, 2000 full-size jobs, seed 0, quantum=0) and shows that
every DP decision went through the CUDA sweep.  Exits non-zero on any
failure, and without a CUDA device before printing any result.

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
from repro_torch.kernels.minplus.ref import minplus_sweep_ref  # noqa: E402
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
SCALE = {"T": 500, "H": 100, "K": 100, "n": 2000}


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


def kernel_phase():
    """Kernel == plain version bitwise, cost and split, f32 and f64; the
    cost-only sweep (the main path's form) timed against the plain one."""
    t0 = time.perf_counter()
    minplus_kernel.load_library()
    print(f"build: minplus_sweep.cu in {time.perf_counter() - t0:.3f} s")
    for line in library_path(minplus_kernel.SOURCE).with_suffix(
            ".log").read_text().splitlines():
        if "registers" in line or "smem" in line:
            print("  ptxas:", line.strip())
    max_err = 0.0
    timings = {}
    for T, dc1, d1 in TEST_SHAPES + SLICE_SHAPES:
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
            if (T, dc1, d1) in SLICE_SHAPES:
                k_ms = _time_ms(lambda: minplus_kernel.minplus_sweep_cuda(
                    rows, d1 - 1, want_split=False), reps=5)
                p_ms = _time_ms(lambda: minplus_sweep_ref(rows, d1 - 1),
                                reps=2)
                op_ms, byte_ms = _bound_ms(T, dc1, d1, dtype,
                                           want_split=False)
                b_ms = max(op_ms, byte_ms)
                timings[(T, dc1, d1, dtype)] = (k_ms, p_ms, b_ms, op_ms,
                                                byte_ms)
                print(f"sweep T={T} m_pad={dc1} d1={d1} "
                      f"{str(dtype).split('.')[-1]}: kernel_ms={k_ms!r} "
                      f"plain_ms={p_ms!r} bound_ms={b_ms!r} bitwise=True")
    print(f"kernel phase ok: {len(TEST_SHAPES + SLICE_SHAPES) * 2} "
          f"shape/dtype cases bitwise equal, max_abs_err={max_err!r}")
    return max_err, timings


def paper_phase():
    """The slice on the card against the port on the CPU, paper scale."""
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


def scale_phase():
    """The main path at the 10x instance, counting kernel launches."""
    cluster = make_cluster(T=SCALE["T"], H=SCALE["H"], K=SCALE["K"])
    jobs = make_jobs(SCALE["n"], T=SCALE["T"], seed=0)
    live = [engine._with_quantum(j, 0) for j in jobs if j.arrival < cluster.T]
    buckets = [_shape_bucket(j) for j in live]
    dp_decisions = sum(b is not None for b in buckets)
    minplus_kernel.minplus_sweep_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.run(cluster, jobs, quantum=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = minplus_kernel.minplus_sweep_cuda.launches
    ds = np.asarray(res.decision_seconds) * 1e3
    print(f"10x instance (T={SCALE['T']}, H=K={SCALE['H']}, "
          f"{SCALE['n']} jobs, seed 0, quantum=0): wall_s={wall!r} "
          f"decisions={len(ds)} decisions_per_s={len(ds) / wall!r} "
          f"decision_p50_ms={float(np.percentile(ds, 50))!r} "
          f"decision_p95_ms={float(np.percentile(ds, 95))!r} "
          f"total_utility={res.total_utility!r} accepted={res.accepted} "
          f"device_uploads={res.device_uploads} "
          f"minplus_sweep_launches={launches} dp_decisions={dp_decisions}")
    if launches != dp_decisions:
        raise AssertionError(f"{launches} sweep launches for "
                             f"{dp_decisions} DP decisions")
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
    return launches, hist


def profile_phase(n_jobs=400):
    """Where the time goes: a traced run of the 10x trace's first
    ``n_jobs`` arrivals (same price parameters as the full run, so these
    are the main run's first decisions); device busy = the sum of device
    self time over all traced ops (one stream, so they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    cluster = make_cluster(T=SCALE["T"], H=SCALE["H"], K=SCALE["K"])
    jobs = make_jobs(SCALE["n"], T=SCALE["T"], seed=0)
    params = price_params_from_jobs(jobs, cluster)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = engine.run(cluster, jobs[:n_jobs], params=params, quantum=0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = {}
    for e in prof.key_averages():
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        if ms > 0:
            dev[e.key] = dev.get(e.key, 0.0) + ms
    busy = sum(dev.values())
    sweep = sum(ms for k, ms in dev.items() if "minplus_sweep" in k)
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile (10x trace, first {n_jobs} jobs, traced): "
          f"decisions={len(res.decision_seconds)} wall_ms={wall_ms!r} "
          f"device_busy_ms={busy!r} device_idle_share="
          f"{1.0 - busy / wall_ms!r} minplus_sweep_ms={sweep!r}")
    for k, ms in top:
        print(f"  device {ms!r} ms: {k[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = _card()
    print(card, flush=True)
    max_err, timings = kernel_phase()
    paper_phase()
    launches, hist = scale_phase()
    profile_phase()
    # launch-weighted means over the 10x run's sweep shapes (f64, cost only)
    n = sum(hist.values())
    mean = [sum(hist[m] * timings[(SCALE["T"], m, 1280, torch.float64)][i]
                for m in hist) / n for i in range(5)]
    print(json.dumps({"kernels": [{
        "name": "minplus_sweep", "route": "cuda",
        "source": "src/repro_torch/kernels/minplus/csrc/minplus_sweep.cu",
        "replaces": "src/repro/kernels/minplus/kernel.py:125",
        "launches": launches, "max_abs_err": max_err,
        "ms": mean[0], "plain_ms": mean[1], "bound_ms": mean[2],
        "bound_by": "operations" if mean[3] >= mean[4] else "bytes",
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

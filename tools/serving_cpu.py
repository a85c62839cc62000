"""Run the serving and churn instances through the port on the CPU: the
trajectories their card runs are held to, which ``chip_smoke.py`` pins in
``SERVING_CPU``, ``CHURN_CPU`` and ``STREAM_CHURN_CPU``.

    python3 tools/serving_cpu.py [--only serving|churn|stream_churn ...]

``serving``: ``SERVING_DIMS`` in full (H = K = 50, a 64-slot window, a
20,000-slot stream at rate 0.2 of seed 0, full-size jobs, quantum=0)
through ``engine.run_stream``, both routes; ``churn``: ``CHURN_DIMS``
(T = 100, H = K = 40, 120 full-size jobs of seed 0) churn-free and at
``churn_trace(frac=0.05 and 0.20, seed=1)``, both routes;
``stream_churn``: the serving cluster's first 2000 slots under
``churn_trace(frac=0.05, seed=1, T=2000)``, the whole route.  All with
``check=True``.  Prints each run's pin (accepted, total utility,
completion sha256, preempted, dropped) and wall time, then the three
constants as Python literals.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (adds src/ to the path)

PARTS = ("serving", "churn", "stream_churn")


def _timed(label, fn):
    t0 = time.perf_counter()
    res = fn()
    pin = chip_smoke._pin(res)
    print(f"{label}: {pin!r} n_jobs={res.n_jobs} "
          f"wall_s={time.perf_counter() - t0!r}", flush=True)
    return pin


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=PARTS, default=PARTS)
    args = ap.parse_args()
    out = {}
    if "serving" in args.only:
        out["SERVING_CPU"] = {core: _timed(
            f"serving, {core} route",
            lambda: chip_smoke.serving_run(core, device="cpu"))
            for core in ("whole", "tiled")}
    if "churn" in args.only:
        out["CHURN_CPU"] = {(core, frac): _timed(
            f"churn frac={frac}, {core} route",
            lambda: chip_smoke.churn_run(core, frac, device="cpu"))
            for core in ("whole", "tiled")
            for frac in (0.0,) + chip_smoke.CHURN["levels"]}
    if "stream_churn" in args.only:
        sc = chip_smoke.STREAM_CHURN
        out["STREAM_CHURN_CPU"] = _timed(
            "streamed churn, whole route",
            lambda: chip_smoke.serving_run("whole", device="cpu",
                                           slots=sc["slots"],
                                           frac=sc["frac"]))
    for name, value in out.items():
        print(f"{name} = {value!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

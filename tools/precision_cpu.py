"""Run ``chip_smoke.py``'s D&C and float32 runs through the port on the
CPU: the trajectories the card's runs are held to, written to
``tools/precision_cpu.json``.

    python3 tools/precision_cpu.py [--only dnc x32]

``dnc``: the paper-scale instance (T=100, H = K = 50, 200 small jobs of
seed 0, ``quantum=0``) on the tiled route with ``REPRO_MONOTONE_DNC=1``
(``chip_smoke.dnc_run``): its pin (``chip_smoke.dnc_pin``: accepted
count, the sha256 of the accepted set and of the completions, the total
utility, the tiles per branch [dnc, plateau, chain] and the live slots of
D&C and plateau tiles).  ``x32``: the paper-scale and the 10x instance
(``SCALE_DIMS``) on both routes at ``precision="x32"``
(``chip_smoke.precision_run``), each run's ``chip_smoke.run_pin``.
About 4 minutes on one CPU, most of it the two 10x runs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (adds src/ to the path)

RUNS = ("dnc", "x32")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=RUNS, default=RUNS)
    args = ap.parse_args()
    path = chip_smoke.PRECISION_CPU
    pins = {}
    if os.path.exists(path):
        with open(path) as f:
            pins = json.load(f)
    if "dnc" in args.only:
        t0 = time.perf_counter()
        pins["dnc paper tiled"] = chip_smoke.dnc_pin(
            *chip_smoke.dnc_run(device="cpu"))
        print(f"dnc paper tiled: {pins['dnc paper tiled']!r} wall_s="
              f"{time.perf_counter() - t0!r}", flush=True)
    if "x32" in args.only:
        for instance, core in chip_smoke.PRECISION_RUNS:
            key = f"x32 {instance} {core}"
            t0 = time.perf_counter()
            pins[key] = chip_smoke.run_pin(chip_smoke.precision_run(
                instance, core, device="cpu"))
            print(f"{key}: {pins[key]!r} wall_s="
                  f"{time.perf_counter() - t0!r}", flush=True)
    with open(path, "w") as f:
        json.dump(pins, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

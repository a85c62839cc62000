"""What the flight recorder costs when it is on: the 10x instance
(``SCALE_DIMS``: T=500, H = K = 100, 2000 full-size jobs of seed 0,
``quantum=0``) through ``engine.run`` on the card, per route, without a
recorder and with one (``obs=Obs()``), in the order off, on, on, off, so
that a drift of the host's speed over the call weighs on both alike,
after one unrecorded run of the route that builds and loads its kernels
(not counted).

    python3 tools/obs_overhead_probe.py [--cores whole tiled]

Prints the card's name and power limit, each run's wall (host clock,
ending in a synchronize), utility and event count, and per route the
recorded runs' mean wall over the unrecorded runs' mean.  Every run must
give the same completions and utility.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402  (adds src/ to the path)
from repro_torch import obs as obslib  # noqa: E402
from repro_torch.sim import engine  # noqa: E402
from repro_torch.sim.workload import make_cluster, make_jobs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cores", nargs="+", default=["whole", "tiled"])
    args = ap.parse_args()
    print(chip_smoke._card(), flush=True)
    s = chip_smoke.SCALE
    cluster = make_cluster(T=s["T"], H=s["H"], K=s["K"])
    jobs = make_jobs(s["n"], T=s["T"], seed=0)
    for core in args.cores:
        walls = {False: [], True: []}
        first = None
        engine.run(cluster, jobs, quantum=0, core=core)       # warm-up
        for recorded in (False, True, True, False):
            ob = obslib.Obs() if recorded else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = engine.run(cluster, jobs, quantum=0, core=core, obs=ob)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            walls[recorded].append(wall)
            key = (res.completion, res.total_utility)
            if first is None:
                first = key
            elif key != first:
                raise AssertionError(f"{core}: the runs differ")
            print(f"{core} route, recorder {'on' if recorded else 'off'}: "
                  f"wall_s={wall!r} total_utility={res.total_utility!r} "
                  f"events={len(ob.tracer) if ob else 0}", flush=True)
        on = sum(walls[True]) / 2
        off = sum(walls[False]) / 2
        print(f"{core} route: mean wall on {on!r} s, off {off!r} s, "
              f"on/off {on / off!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

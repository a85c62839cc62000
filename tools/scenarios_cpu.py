"""Run the scenario library's rows of ``chip_smoke.py``'s scenario phase
through the port on the CPU: the trajectories the card's rows are held
to, written to ``tools/scenarios_cpu.json``.

    python3 tools/scenarios_cpu.py [--only hetero cancel ...]

Every scenario of ``chip_smoke.SCENARIO_PLAN`` at the reference's full
sizes (``quick=False``, seed 0): hetero, cancel, straggler and misest
with every scheduler they list, OASiS through both routes; scale
(``SCALE_DIMS``), serving (``SERVING_DIMS``) and churn (``CHURN_DIMS`` at
5 % and 20 %) with the reactive baselines.  Prints each row's pin
(accepted, completed, completion sha256, utility, utilization, retention,
preempted) and wall time, and merges the pins into the JSON file by
``chip_smoke._scenario_key``.
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
from repro_torch.sim import scenarios  # noqa: E402


def main() -> int:
    names = [name for name, _ in chip_smoke.SCENARIO_PLAN]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=names, default=names)
    args = ap.parse_args()
    path = chip_smoke.SCENARIOS_CPU
    pins = {}
    if os.path.exists(path):
        with open(path) as f:
            pins = json.load(f)
    for core in ("whole", "tiled"):
        for name, kw in chip_smoke.scenario_plan(core):
            if name not in args.only:
                continue
            t0 = time.perf_counter()
            rows = scenarios.run_scenario(name, device="cpu", core=core,
                                          **kw)
            for row in rows:
                key = chip_smoke._scenario_key(row, core)
                pins[key] = chip_smoke._scenario_pin(row)
                print(f"{key}: {pins[key]!r} wall_s={row.wall_seconds!r}")
            print(f"{name} ({core} route): wall_s="
                  f"{time.perf_counter() - t0!r}", flush=True)
    with open(path, "w") as f:
        f.write("{\n" + ",\n".join(f" {json.dumps(k)}: {json.dumps(v)}"
                                   for k, v in sorted(pins.items()))
                + "\n}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

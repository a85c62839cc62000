"""Run the learned scheduler's runs of ``chip_smoke.py``'s learned phase
through the port on the CPU: the trajectories the card's runs are held
to, written to ``tools/learned_cpu.json``.

    python3 tools/learned_cpu.py [--only scale serving]

``rl.policy.default_policy(cluster, seed=0)`` (greedy, untrained, its
parameters drawn on the CPU) on the 10x instance (``SCALE_DIMS``: T=500,
H = K = 100, 2000 full-size jobs of seed 0, ``engine.run``) and on the
serving stream (``SERVING_DIMS`` in full: H = K = 50, a 64-slot window,
20,000 slots at rate 0.2 of seed 0, ``engine.run_stream``), both with
``check=True``.  Each run's pin (``chip_smoke.learned_pin``: accepted,
completed, utility, the sha256 of its completions and of every answer of
the policy, the decision count) goes to the JSON file beside the
smallest top-two logit margin over both heads of any decision: a margin
well above the card's float32 rounding is what makes an exact pin a fair
test of the card's greedy choices.
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

RUNS = ("scale", "serving")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=RUNS, default=RUNS)
    args = ap.parse_args()
    path = chip_smoke.LEARNED_CPU
    pins = {}
    if os.path.exists(path):
        with open(path) as f:
            pins = json.load(f)
    for which in args.only:
        t0 = time.perf_counter()
        res, dec = chip_smoke.learned_run(which, device="cpu",
                                          track_margins=True)
        margins = dec.decider.margins
        pins[which] = {"pin": chip_smoke.learned_pin(res, dec),
                       "min_margin": min(margins)}
        print(f"{which}: {pins[which]!r} wall_s="
              f"{time.perf_counter() - t0!r}", flush=True)
    with open(path, "w") as f:
        json.dump(pins, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

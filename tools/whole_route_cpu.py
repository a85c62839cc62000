"""Run the whole-horizon route on the CPU, the trajectory its card run is
held to: the results ``chip_smoke.py`` pins in ``SCALE_WHOLE_CPU`` and
``WIDE_WHOLE_CPU``.

    python3 tools/whole_route_cpu.py [--instance 10x|wide]

``10x``: ``make_cluster(T=500, H=100, K=100)``, ``make_jobs(2000, T=500,
seed=0)``, ``quantum=0`` (about 8 minutes on 8 CPU threads); ``wide``:
``make_cluster(T=100, H=20, K=20)``, ``make_jobs(40, T=100, seed=1)``,
``quantum=None`` (about half a minute).  Prints the total utility, the
accepted jobs, the sha256 of the sorted (job, completion slot) pairs as
JSON (``chip_smoke._completion_digest``), the completions themselves for
the wide instance, and the wall time.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (adds src/ to the path)
from repro_torch.sim import engine  # noqa: E402
from repro_torch.sim.workload import make_cluster, make_jobs  # noqa: E402

INSTANCES = {
    "10x": (dict(T=500, H=100, K=100), dict(n_jobs=2000, T=500, seed=0), 0),
    "wide": (dict(T=100, H=20, K=20), dict(n_jobs=40, T=100, seed=1), None),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--instance", choices=sorted(INSTANCES), default="10x")
    args = ap.parse_args()
    ckw, jkw, quantum = INSTANCES[args.instance]
    t0 = time.perf_counter()
    res = engine.run(make_cluster(**ckw), make_jobs(**jkw), quantum=quantum,
                     core="whole", device="cpu")
    print(f"{args.instance}, whole route on the CPU: total_utility="
          f"{res.total_utility!r} accepted={res.accepted} "
          f"completion_sha256={chip_smoke._completion_digest(res.completion)}"
          f" wall_s={time.perf_counter() - t0!r}")
    if args.instance == "wide":
        print(dict(sorted(res.completion.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())

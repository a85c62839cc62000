"""Run ``chip_smoke.py``'s recorded runs through the port on the CPU: the
flight-recorder readings its obs phase holds the card to, written to
``tools/obs_cpu.json``.

    python3 tools/obs_cpu.py

``paper``: paper_phase's instance (``make_cluster(T=100, H=50, K=50)``,
``make_jobs(200, T=100, seed=0, small=True)``, ``quantum=0``) through both
decision routes with a recorder, each run's ``chip_smoke.obs_pin``
(utility, accepted jobs, completions' digest, every counter, the spans
per name, the observations per histogram).  ``cli_rows``: the rows of
``python -m repro_torch.launch.cluster_sim --scenario churn --quick
--device cpu`` (``chip_smoke.cli_rows``).  About half a minute.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (adds src/ to the path)


def main() -> int:
    t0 = time.perf_counter()
    pins = {"paper": {}}
    for core in ("whole", "tiled"):
        res, ob = chip_smoke.obs_paper_run(core, device="cpu")
        pins["paper"][core] = chip_smoke.obs_pin(res, ob)
        print(f"paper, {core} route: {pins['paper'][core]!r}", flush=True)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster_sim",
         *chip_smoke.OBS_CLI, "--device", "cpu"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, check=True)
    pins["cli_rows"] = chip_smoke.cli_rows(out.stdout)
    print(f"cli rows: {pins['cli_rows']!r}")
    with open(chip_smoke.OBS_CPU, "w") as f:
        json.dump(pins, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wall_s={time.perf_counter() - t0!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

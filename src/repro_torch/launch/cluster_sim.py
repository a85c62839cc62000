"""The paper's headline comparison (Figs. 3-4) on the port, at a
configurable scale, with a small ASCII chart; or one scenario of the
scenario library.  OASiS decides on the card unless ``--device cpu``,
through the decision core ``--core`` (``whole`` or ``tiled``); the
reactive baselines run on the host.

    PYTHONPATH=src python -m repro_torch.launch.cluster_sim --jobs 60 --T 100
    PYTHONPATH=src python -m repro_torch.launch.cluster_sim \\
        --scenario churn --quick --device cpu --trace churn.json
    PYTHONPATH=src python -m repro_torch.launch.cluster_sim \\
        --scenario scale10x --scheduler oasis --core tiled --quick --profile

Scenarios: hetero, cancel, straggler, misest, scale (alias ``scale10x``),
serving and churn.  ``--scheduler`` runs one scheduler of the scale or
serving scenario, ``learned`` among them (``--policy-ckpt``: a checkpoint
directory written by ``repro_torch.rl.train``, required for it).

``--trace OUT.json`` records the whole run with the flight recorder
(``repro_torch.obs``) and writes a Chrome-trace / Perfetto JSON with the
metrics snapshot embedded (open it at https://ui.perfetto.dev).
``--profile`` sets ``REPRO_DECIDE_PROFILE=1`` and prints the tiled
route's decision-stage breakdown (row build, DP sweep, backtrack,
placement; the profile re-runs each DP launch, so decisions take about
twice as long).
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from .. import obs as obslib
from ..core.schedule_torch import CORES, decide_profile_snapshot
from ..sim.scenarios import ALL_SCHEDULERS, SCENARIOS, run_scenario
from ..sim.simulator import simulate
from ..sim.workload import make_cluster, make_jobs


def bar(v, vmax, width=40):
    return "#" * int(width * v / max(vmax, 1e-9))


def print_decide_profile() -> None:
    """The stage breakdown accumulated under ``REPRO_DECIDE_PROFILE=1``
    (``core.schedule_torch.decide_profile_snapshot``)."""
    snap = decide_profile_snapshot()
    n = max(snap.get("decisions", 0.0), 1.0)
    print("\n== decision stage breakdown "
          f"({int(n)} tiled-route decisions; REPRO_DECIDE_PROFILE) ==")
    for stage in ("row_build", "dp_sweep", "backtrack", "placement"):
        tot = snap.get(stage, 0.0)
        print(f"{stage:10s} {tot:8.2f}s total  "
              f"{tot / n * 1e3:8.2f}ms/decision")


def run_figs(args) -> None:
    summaries, gaps = {}, {}
    for seed in range(args.seeds):
        cluster = make_cluster(T=args.T, H=args.servers, K=args.servers)
        jobs = make_jobs(args.jobs, T=args.T, seed=seed, small=False)
        for name in ALL_SCHEDULERS:
            kw = dict(quantum=0) if name == "oasis" else {}
            r = simulate(cluster, jobs, scheduler=name, check=False,
                         device=args.device, core=args.core, **kw)
            summaries.setdefault(name, []).append(r.summary())
            if r.target_gap:
                gaps.setdefault(name, []).extend(r.target_gap)

    def mean_of(name, key):
        vals = [s[key] for s in summaries[name] if s[key] is not None]
        return float(np.mean(vals)) if vals else float("nan")

    print(f"== per-scheduler episode summary "
          f"(mean of {args.seeds} seeds; Fig. 3) ==")
    means = {k: mean_of(k, "total_utility") for k in summaries}
    vmax = max(means.values())
    for k, v in sorted(means.items(), key=lambda kv: -kv[1]):
        print(f"{k:6s} {v:9.1f}  acc={mean_of(k, 'accept_rate'):5.2f} "
              f"comp={mean_of(k, 'completion_rate'):5.2f} "
              f"p50-lat={mean_of(k, 'p50_latency'):6.1f} "
              f"p95-lat={mean_of(k, 'p95_latency'):6.1f}  {bar(v, vmax)}")
    print("\n== completion - target time (mean abs; Fig. 4) ==")
    for k in means:
        g = gaps.get(k, [])
        print(f"{k:6s} {np.mean(np.abs(g)) if g else float('nan'):8.2f} "
              f"(n={len(g)})")


def run_one_scenario(args) -> None:
    name = "scale" if args.scenario == "scale10x" else args.scenario
    kw = dict(device=args.device, core=args.core)
    if args.scheduler:
        kw["schedulers"] = (args.scheduler,)
    if args.policy_ckpt:
        kw["policy_ckpt"] = args.policy_ckpt
    rows = run_scenario(name, seed=args.seed, quick=args.quick, **kw)
    print(f"== scenario: {args.scenario} "
          f"(seed={args.seed}{', quick' if args.quick else ''}) ==")
    vmax = max(r.utility for r in rows)
    for r in rows:
        extra = f" canceled={r.canceled}" if r.canceled else ""
        print(f"{r.scheduler:6s} {r.variant:14s} {r.utility:9.1f} "
              f"acc={r.accepted:4d} comp={r.completed:4d} "
              f"util={r.utilization:5.2f} {r.wall_seconds:7.2f}s{extra}  "
              f"{bar(r.utility, vmax, width=24)}")
    decided = [r for r in rows if r.decision_p50 is not None]
    if decided:
        print("\n== per-decision latency (plan-ahead schedulers) ==")
        for r in decided:
            print(f"{r.scheduler:6s} {r.variant:14s} "
                  f"p50={r.decision_p50*1e3:8.2f}ms "
                  f"p95={r.decision_p95*1e3:8.2f}ms "
                  f"mean={r.decision_mean*1e3:8.2f}ms")
    churned = [r for r in rows if r.retention is not None]
    if churned:
        print("\n== utility retention under fleet churn "
              "(churned / churn-free; higher is better) ==")
        for r in churned:
            lf = f" live={r.live_frac:.2f}" if r.live_frac is not None else ""
            print(f"{r.scheduler:6s} {r.variant:14s} ret={r.retention:6.3f} "
                  f"preempted={r.preempted:3d} dropped={r.preempt_dropped:3d}"
                  f"{lf}  {bar(r.retention, 1.0, width=24)}")
    streamed = [r for r in rows if r.decisions_per_sec is not None]
    if streamed:
        print("\n== sustained throughput (streamed trace) ==")
        for r in streamed:
            wb = (f" window={r.window_bytes/1024:.0f}KiB"
                  if r.window_bytes else "")
            print(f"{r.scheduler:6s} {r.decisions_per_sec:10.1f} "
                  f"decisions/sec over {r.n_jobs} jobs{wb}")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.cluster_sim",
        description="OASiS against the reactive baselines on the port")
    ap.add_argument("--jobs", type=int, default=60)
    ap.add_argument("--T", type=int, default=100)
    ap.add_argument("--servers", type=int, default=20)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--scenario", default=None,
                    choices=sorted(SCENARIOS) + ["scale10x"],
                    help="run a scenario instead of the Fig. 3/4 "
                         "comparison (scale10x = alias for scale)")
    ap.add_argument("--scheduler", default=None,
                    choices=list(ALL_SCHEDULERS) + ["learned"],
                    help="scale/serving scenarios only: run this single "
                         "scheduler (learned runs the rl policy scheduler)")
    ap.add_argument("--policy-ckpt", default=None,
                    help="checkpoint directory from repro_torch.rl.train "
                         "(required for --scheduler learned)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="shrink the scenario instance")
    ap.add_argument("--device", default=None,
                    help="where OASiS decides (default: the CUDA card; "
                         "'cpu' only when asked)")
    ap.add_argument("--core", default="whole", choices=CORES,
                    help="OASiS's decision core")
    ap.add_argument("--profile", action="store_true",
                    help="record the tiled route's per-stage decision wall "
                         "clock (row build / DP sweep / backtrack / "
                         "placement) and print the breakdown; roughly "
                         "doubles decision latency")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record the run with the flight recorder "
                         "(repro_torch.obs) and write a Chrome-trace / "
                         "Perfetto JSON with the metrics snapshot embedded")
    args = ap.parse_args(argv)
    if args.profile:
        os.environ["REPRO_DECIDE_PROFILE"] = "1"
    if args.scheduler and args.scenario not in ("scale", "scale10x",
                                                "serving"):
        ap.error("--scheduler only applies to --scenario "
                 f"scale/scale10x/serving (got --scenario {args.scenario})")
    if args.policy_ckpt and args.scheduler != "learned":
        ap.error("--policy-ckpt only applies to --scheduler learned")
    if args.scheduler == "learned" and not args.policy_ckpt:
        ap.error("--scheduler learned requires --policy-ckpt "
                 "(a repro_torch.rl.train checkpoint directory)")
    ob = obslib.enable() if args.trace else None
    try:
        if args.scenario:
            run_one_scenario(args)
        else:
            run_figs(args)
    finally:
        if ob is not None:
            obslib.disable()
    if ob is not None:
        n = ob.export_chrome(args.trace)
        snap = ob.metrics.snapshot()
        print(f"\n== flight recorder ==\n{n} trace events -> {args.trace} "
              f"({len(snap['counters'])} counters, "
              f"{len(snap['histograms'])} histograms embedded)")
    if args.profile:
        print_decide_profile()


if __name__ == "__main__":
    main()

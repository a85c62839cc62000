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
DP decision of the whole route went through the CUDA sweep, and each
tile of the tiled route through one launch from the carry the previous
tile left: a chain tile of the sweep kernel, a plateau tile of the
plateau kernel.  The tiled route decides each arrival burst together
(``OASiS.on_arrivals``: speculative decisions, then re-solves through
the row cache); it runs at one lane a launch and again at eight
(``REPRO_BURST_LANES=8``, one cluster per lane), both held to the
sequential route's completions and utility.  The one-slot kernel is the
one-slot entry's (``ops.minplus``), driven on its own with its count set
to 0.  The convex divide-and-conquer branch (``REPRO_MONOTONE_DNC=1``)
follows: its tile kernel against its plain version and the chain on
certified-convex tiles, then the paper-scale tiled run with the switch
on, its counts set to 0 just before it and read just after (one launch
per D&C tile), held to the switch-off run and to the port on the CPU with
the same tiles per branch, and its own D&C tiles timed.  The float32
route (``precision="x32"``, the reference's TPU precision) runs the
paper-scale and the 10x instance on both routes, each held to the port's
float32 run on the CPU (``tools/precision_cpu.py``).  Unquantized
full-size jobs (d1 up to 20480) then go through both
routes, held to the port on the CPU, as the whole route's 10x run is.
Continuous serving and fleet churn follow, each run with the counts set
to 0 just before it and read just after and held to the port's
trajectory on the CPU (``tools/serving_cpu.py``): the reference's
serving stream in full (SERVING_DIMS: 4,457 full-size jobs over 20,000
slots, a 64-slot rolling window, H = K = 50) through
``engine.run_stream`` on both routes, with one upload and 256,000 window
bytes; its churn instance (CHURN_DIMS) churn-free and at 5 % and 20 %
churn on both routes; the serving cluster's first 2000 slots under
churn (down servers re-blocked after every slide).  The paper's
comparison follows: the scenario library (``repro_torch.sim.scenarios``)
at the reference's full sizes, hetero, cancel, straggler and misest with
every scheduler they list (OASiS through both routes), scale, serving and
churn with the reactive baselines (FIFO, DRF, RRH, Dorm, which run on the
host in numpy and launch no kernel), every OASiS run with the counts set
to 0 just before it and read just after, every row held to the port on
the CPU (``tools/scenarios_cpu.py``).  The learned scheduler follows
(``repro_torch.rl``): OASiS replayed through the engine's decision
points (``engine.decisions``, the rl env) at paper scale on both routes,
held to the card's runs, its DP launches counted into the kernels line;
``default_policy(cluster, seed=0)`` on the 10x instance and on the
serving stream through ``engine.run``/``run_stream(policy=...)``, held
to the port's CPU runs (``tools/learned_cpu.py``); and REINFORCE training
at the reference's ``TrainConfig`` (the behaviour-cloning warm start and
two iterations of lockstep rollouts, autograd and Adam on the card), one
update held to the CPU's and a checkpoint round trip.  The flight
recorder follows (``repro_torch.obs``): both routes recorded at paper
scale, each run equal to its unrecorded run and its readings (counters,
span and histogram counts) to the port's on the CPU
(``tools/obs_cpu.py``); the tiled route recorded at 10x, equal to its
unrecorded run with the same kernel launches, its derived figures and
host ms per span printed; the ``REPRO_DECIDE_PROFILE`` stage breakdown
over the 10x trace's first 200 jobs; and the CLI ``python -m
repro_torch.launch.cluster_sim --scenario churn --quick --trace`` on the
card.  Traced runs of the 10x trace's first 100 jobs show where the
time goes (the whole route; the tiled route one job at a time, and in
bursts at one and at eight lanes).

The model stack's slice follows: the Mamba2 SSD scan (chunks in
parallel across a thread-block cluster, chunk products on the tensor
cores) and both flash attention kernels (both on the tensor cores:
wgmma for bfloat16, TF32 mma.sync in three passes for float32) against
their plain versions (test shapes, a row of several cluster segments
from an initial state, Zamba2-7B's prefill shapes and the float32
consistency prefill's attention, every launch plan, and the dense
family's served attention: Gemma2-9B's local (window 4096) and global
layers soft-capped at 50, StarCoder2-3B's), the Zamba2 and the five
dense smoke models (granite, StarCoder2, pixtral, also with patch
embeddings, both gemma2) on the card against the CPU, a full-width
Zamba2-7B prefill in float32 against its own teacher-forced decode (the
float32 path: 81 SSD and 13 float32 flash launches, each flash launch
also held to the plain versions on its recorded inputs), the same for
Gemma2-9B past its window (a 4200-token prompt into rolled local caches,
8 decode steps, against one prefill of all 4208 tokens; 42 recorded
float32 flash launches), and the serving path ``repro_torch.launch.serve``
at full width in bfloat16: Zamba2-7B (batch 4, prompt 2048), Gemma2-9B
(batch 2, prompt 6144) and StarCoder2-3B (batch 4, prompt 2048), 32 new
tokens each, each with the kernel counts set to 0 just before it and
read just after: every prefill ran 81 SSD and 13 bfloat16 flash launches
(Zamba2-7B) or one bfloat16 flash launch per layer (42, 30), no decode
step ran any.  The MoE family follows: the flash kernels at OLMoE-1B-7B's
prefill attention (FLASH_OLMOE, beside SDPA), the OLMoE and DeepSeek-V3
smoke models on the card against the CPU (DeepSeek-V3's MLA also through
its chunked branch), OLMoE at full width in float32 at a capacity that
drops nothing (600 prompt tokens and 8 teacher-forced decode steps
against one prefill of all 608; its 32 float32 flash launches recorded
and held), OLMoE served at full width and depth (batch 4, prompt 2048:
16 bfloat16 flash launches a prefill, capacities 1280 in prefill and 1
in decode), one MLA layer at DeepSeek-V3's widths (S 4608: the chunked
branch against the dense one, the absorbed decode against the expanded
prefill), and DeepSeek-V3 at full width cut to depth 4 (3 dense MLA
layers, 1 MLA-MoE layer of 256 routed experts and the shared one, the
multi-token-prediction parameters; bfloat16 parameters) served at batch
1 of a 4608-token prompt, no kernel launched.  The enc-dec family and
the batcher follow: both flash kernels non-causal at Whisper-large-v3's
encoder (Sq = Sk = 1500) and cross-attention (Sq 224, Sk 1500) shapes,
beside SDPA and their bounds; Whisper's smoke model on the card against
the CPU (also with 320 frames, where every attention takes the kernel);
one decode step with per-row cache lengths on every family with an
attention cache against the CPU; Whisper-large-v3 at full width and depth
in float32 (the prefill against its teacher-forced decode from
``encdec_prepare``'s cross K/V; 96 recorded float32 flash launches held);
Whisper-large-v3 served at full width and depth (batch 8 clips of 1500
frames, prompt 224, 32 new tokens: 64 bfloat16 flash launches a prefill,
none in decode); and the continuous batcher
(``repro_torch.serve.batcher``) on StarCoder2-3B at full width in
float32, 12 requests over 4 rows, each request held to its solo decode.
Traced prefills and decode steps of Zamba2-7B, Gemma2-9B, OLMoE and
Whisper-large-v3 show where the serving time goes, OLMoE's with its
expert dispatch against its expert products.  The training slice
follows: the flash-attention backward kernel
(``csrc/flash_attention_bwd.cu``, reached on the model path through the
autograd function ``kernel.FlashAttention``) against the plain
version's autograd gradients in both dtypes, every mask case and head
dim, then timed at StarCoder2-3B's training attention, Zamba2-7B's,
Gemma2-9B's local layer and Whisper's cross-attention beside the plain
backward, its bound and SDPA's backward; the reference test's TINY
trained on the card at 512 tokens (its first step's loss and gradients
against the port on the CPU, its loss falling, one float32 flash
forward and one backward launch a layer and step); and StarCoder2-3B
trained at full width and depth through ``repro_torch.launch.train``
(bfloat16 compute, float32 parameters and moments, remat, AdamW, 2 x
2048 tokens from the data pipeline, 4 steps, the counts set to 0 just
before and read just after: 60 wgmma forward and 30 backward launches a
step; step 1's backward launches held to the plain gradients; step
wall, tokens/s, model TFLOP/s and peak memory printed); then its first
four steps at full width and two layers on the card, float32 and
bfloat16, held step by step to the port's float32 run on the host CPU.
Exits non-zero on any failure, and without a CUDA device before printing
any result.

Output: one line per phase; then the kernels' JSON line, the card's
name and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import build_all  # noqa: E402
from repro_torch.kernels.build import library_path  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.minplus import kernel as minplus_kernel  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd_op  # noqa: E402
from repro_torch.kernels.minplus import ops as minplus_ops  # noqa: E402
from repro_torch.kernels.minplus.monotone import (  # noqa: E402
    convex_certificate, convex_certificate_np, monotone_dnc_step,
    plateau_step, run_count)
from repro_torch.kernels.minplus.ref import (  # noqa: E402
    minplus_ref, minplus_sweep_ref)
from repro_torch.kernels.minplus.tiled import TILE, minplus_tile  # noqa: E402
from repro_torch import obs as obslib  # noqa: E402
from repro_torch.core import schedule_torch  # noqa: E402
from repro_torch.core.pricing import price_params_from_jobs  # noqa: E402
from repro_torch.core.schedule_torch import _shape_bucket  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models.attention import _sdpa_chunked  # noqa: E402
from repro_torch.models import mla, moe  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    init_params, param_count, tree_leaves, tree_map)
from repro_torch.models.mamba2 import ssd_chunked_plain  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    decode_step, encdec_prepare, init_cache, init_model, model_specs,
    prefill)
from repro_torch.serve import steps as serve_steps  # noqa: E402
from repro_torch.serve.batcher import ContinuousBatcher, Request  # noqa: E402,E501
from repro_torch.data.pipeline import DataConfig, DataPipeline  # noqa: E402,E501
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt  # noqa: E402
from repro_torch.train.steps import (  # noqa: E402
    TrainHyper, make_train_step, value_and_grad)
from repro_torch.rl import env as rl_env  # noqa: E402
from repro_torch.rl import policy as rl_policy  # noqa: E402
from repro_torch.rl import train as rl_train  # noqa: E402
from repro_torch.sim import engine, scenarios  # noqa: E402
from repro_torch.sim.fleet import churn_trace  # noqa: E402
from repro_torch.sim.workload import (  # noqa: E402
    make_cluster, make_jobs, stream_jobs)

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): vector (non-tensor)
# rates for float32 and float64, the tensor cores' rate for bfloat16, and
# the HBM3 bandwidth
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12,
            torch.bfloat16: 989e12}
PEAK_TF32 = 495e12             # the tensor cores' dense TF32 rate
PEAK_BYTES = 3.35e12

# tests/test_kernels.py's sweep shapes, then the slices': T in {64 (the
# serving window), 100, 500}, d1 = 1280, every m_pad bucket the 10x
# instance produces
TEST_SHAPES = [(3, 2, 6), (9, 17, 33), (16, 65, 300), (8, 64, 1280),
               (4, 640, 1280)]
M_PADS = (64, 128, 256, 384, 512, 640)
SLICE_SHAPES = [(T, m, 1280) for T in (64, 100, 500) for m in M_PADS]
# unquantized full-size jobs: d1 = 20480 with the narrowest band and the
# widest of the T=100 trace (2688) and of the 10x trace (8960)
WIDE_SHAPES = [(100, m, 20480) for m in (64, 2688, 8960)]
SCALE = dict(scenarios.SCALE_DIMS)
# the one-slot kernels: tests/test_kernels.py's and the slice's shapes,
# the 10x buckets, the wide jobs'
SLOT_TEST_SHAPES = [(1, 1), (2, 5), (17, 129), (65, 1281), (641, 1281)]
SLOT_SCALE_SHAPES = [(m, 1280) for m in M_PADS]
SLOT_WIDE_SHAPES = [(64, 20480), (2688, 20480), (8960, 20480)]
# the plateau tile's clusters of 4 and 8 blocks, reached through d1 = 64 C
PLATEAU_CLUSTER_SHAPES = [(64, 256), (64, 512)]
R_MAX = 16
# the reference's tiled engine on this 10x instance, on a CPU
# (BENCH_decision.json sim_scale.utility.oasis)
JAX_TILED_UTILITY = 7082.083469185378
# the whole route on the wide jobs (make_cluster(T=100, H=20, K=20),
# make_jobs(40, T=100, seed=1), quantum=None), run by the port on a CPU
# (tools/whole_route_cpu.py --instance wide): (completion slot by job,
# total utility)
WIDE_WHOLE_CPU = ({0: 30, 2: 48, 4: 40, 6: 51, 7: 56, 9: 61, 10: 72, 11: 75,
                   12: 85, 14: 80, 15: 49, 19: 79, 20: 87, 21: 96},
                  138.62352352300186)
# the whole route on the 10x instance (quantum=0), run by the port on a CPU
# (tools/whole_route_cpu.py): total utility, accepted jobs, and the sha256
# of its completions (_completion_digest)
SCALE_WHOLE_CPU = (7058.477068242661, 367,
                   "2ef1c5a0cfdc39e171695447f8ea9cb8"
                   "0c7716ca5ed7289004116c3ef3a8f1fe")
# the reference's continuous-serving section, never shrunk there
# (sim/scenarios.py::SERVING_DIMS): a 20,000-slot diurnal x bursty stream
# of full-size jobs (seed 0) over a 64-slot rolling window, quantum=0
SERVING = {**scenarios.SERVING_DIMS, "seed": 0}
# its fleet-churn section (CHURN_DIMS): T=100, H=K=40, 120 full-size jobs
# of seed 0, churn_trace(frac, seed=1) at each level, quantum=0
CHURN = {**{k: scenarios.CHURN_DIMS[k] for k in ("T", "H", "K", "n")},
         "seed": 0, "levels": (0.05, 0.20)}
# the serving cluster's first 2000 slots under churn_trace(frac=0.05,
# seed=1, T=2000), the whole route
STREAM_CHURN = {"slots": 2000, "frac": 0.05, "seed": 1}
# the port's trajectories on a CPU (tools/serving_cpu.py): per route
# (accepted, total utility, completion sha256, preempted, dropped); churn
# per (route, frac), frac 0.0 the churn-free run
SERVING_CPU = {
    "whole": (3727, 104019.10259413831, "dc6b15d15581a10a1e90153481c134f3"
              "c23adc4bb21f26b22571a2675c7b61ae", 0, 0),
    "tiled": (3728, 104577.67550848583, "2ce669a78683dc27495cffc489235e6a"
              "7d54bf6c90c49a2e2680e6b5a8908d94", 0, 0)}
CHURN_CPU = {
    ("whole", 0.0): (27, 212.78412045192178, "5c43c91908bfdd4e06716b5998c0"
                     "6c1b5e9ab8bdbe762e7a0b71046bfe875b80", 0, 0),
    ("whole", 0.05): (30, 285.11966916171025, "61753e0ff4bcd31e4062ae145d0"
                      "29640568ce2ab10d0e40c9e0d588a4a189c3f", 8, 2),
    ("whole", 0.2): (22, 170.40504791299696, "47a88dd51967d2b59ca8e9bdccef"
                     "33924d39d969e899dbf4a4e88ccb11d8914f", 55, 7),
    ("tiled", 0.0): (30, 227.87060824874567, "66e4f4c783a1a8a13fbab107c39a"
                     "43cde094ac3b731d5a62770b12585e3969d4", 0, 0),
    ("tiled", 0.05): (33, 266.0969996109676, "11bf0550da093079e654836ce27f"
                      "b67df738257c5dc7f42ae3e16c536c5000cb", 12, 2),
    ("tiled", 0.2): (21, 174.91750162920155, "43c7380fe675e3a808f79d6014ce"
                     "35546dc2cc983e1ac1a7433e54eeb965d6d6", 54, 7)}
STREAM_CHURN_CPU = (381, 10511.304636994175, "33709bc8bbe3da7ea3dd02a922588a"
                    "373627debbed823a81a557605c0f64d860", 2, 1)


# the scenario library at the reference's full sizes (scenario, runner
# arguments): hetero, cancel, straggler and misest with every scheduler they
# list, OASiS through both routes; scale, serving and churn with the
# reactive baselines only (the phases above run OASiS on those instances)
SCENARIO_PLAN = (("hetero", {}), ("cancel", {}), ("straggler", {}),
                 ("misest", {}),
                 ("scale", {"schedulers": scenarios.REACTIVE}),
                 ("serving", {"schedulers": scenarios.REACTIVE}),
                 ("churn", {"schedulers": scenarios.REACTIVE}))
# the plan's rows run by the port on a CPU (tools/scenarios_cpu.py): by
# _scenario_key, the row's _scenario_pin
SCENARIOS_CPU = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tools", "scenarios_cpu.json")


def scenario_plan(core):
    """The (scenario, runner arguments) of :data:`SCENARIO_PLAN` that run
    with OASiS through ``core``: on the tiled route only those with an
    OASiS row."""
    return [(name, kw) for name, kw in SCENARIO_PLAN
            if core == "whole" or "schedulers" not in kw]


def _scenario_key(row, core):
    """A row's name: scenario, variant, scheduler, and for OASiS the
    route."""
    key = f"{row.scenario}|{row.variant}|{row.scheduler}"
    return f"{key}|{core}" if row.scheduler == "oasis" else key


def _scenario_pin(row):
    """[accepted, completed, completion sha256, utility, utilization,
    retention, preempted]."""
    return [row.accepted, row.completed, _completion_digest(row.completion),
            row.utility, row.utilization, row.retention, row.preempted]


def serving_run(core, device=None, slots=None, frac=None):
    """The serving stream through ``engine.run_stream`` with ``check=True``
    on ``device``, cut to ``slots`` and churned by ``churn_trace(frac)``
    when given."""
    cluster = make_cluster(T=SERVING["window"], H=SERVING["H"],
                           K=SERVING["K"])
    slots = slots or SERVING["slots"]
    fl = churn_trace(cluster, frac=frac, seed=STREAM_CHURN["seed"],
                     T=slots) if frac else None
    jobs = stream_jobs(rate=SERVING["rate"], seed=SERVING["seed"],
                       max_slots=slots)
    return engine.run_stream(cluster, jobs, window=SERVING["window"],
                             quantum=0, check=True, fleet=fl, device=device,
                             core=core)


def churn_run(core, frac, device=None):
    """The churn instance through ``engine.run`` with ``check=True``; frac
    0.0 is the churn-free run."""
    cluster = make_cluster(T=CHURN["T"], H=CHURN["H"], K=CHURN["K"])
    jobs = make_jobs(CHURN["n"], T=CHURN["T"], seed=CHURN["seed"])
    fl = churn_trace(cluster, frac=frac, seed=CHURN["seed"] + 1) \
        if frac else None
    return engine.run(cluster, jobs, quantum=0, check=True, fleet=fl,
                      device=device, core=core)


def _pin(res):
    """(accepted, total utility, completion sha256, preempted, dropped)."""
    return (res.accepted, res.total_utility,
            _completion_digest(res.completion), res.preempted,
            res.preempt_dropped)


def _completion_digest(completion) -> str:
    """sha256 of the sorted (job, completion slot) pairs as JSON."""
    import hashlib
    return hashlib.sha256(json.dumps(sorted(
        (int(j), int(t)) for j, t in completion.items())).encode()).hexdigest()


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


def _band_candidates(dc1, d1):
    """Candidates ``j <= min(DC, d)`` of one slot over D+1 outputs:
    (DC+1)(D+1) - DC(DC+1)/2 where D >= DC."""
    n = min(dc1, d1)
    return n * d1 - n * (n - 1) // 2


def _bound_ms(T, dc1, d1, dtype, want_split):
    """(ms over the ops peak, ms over HBM) for one sweep: 2 ops (add,
    min) per candidate of the band at the vector peak; each input read and
    each output written once.  The bound is the larger."""
    size = dtype.itemsize
    ops = 2.0 * T * _band_candidates(dc1, d1)
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


def _device_table(prof):
    """{kernel or device op: (device ms, launches)} from a profile, device
    self time summed by name; ``aten::`` entries are left out, since each
    carries the time of the kernels it launched, which have their own, and
    so are the named ranges of :class:`_MoeStages` and the CUDA runtime's
    calls (``cudaLaunchKernel``, ...), which the
    tracer may credit with a sliver of the device time of the kernels they
    launched and would count every launch twice."""
    table = {}
    for e in prof.key_averages():
        ms = _self_device_ms(e)
        if ms > 0 and not e.key.startswith(("aten::", "cuda",
                                             "moe_stage")):
            t = table.get(e.key, (0.0, 0))
            table[e.key] = (t[0] + ms, t[1] + e.count)
    return table


def _plan_str(plan):
    return (f"C={plan.cluster} k={minplus_kernel.SWEEP_K} w={plan.w} "
            f"jgroups={plan.jgroups} threads={plan.threads}")


def kernel_phase():
    """The sweep == its plain version bitwise, cost and split, f32 and
    f64, under the plan it picks, printed beside each shape's times; the
    cost-only sweep (the whole route's form) timed (device time per
    launch) against the plain one."""
    t0 = time.perf_counter()
    built = build_all()
    print(f"build: {', '.join(p.stem.rsplit('_', 1)[0] for p in built)}"
          f" in {time.perf_counter() - t0:.3f} s (one nvcc each, together)")
    minplus_kernel.load_libraries()
    for name, src in {**minplus_kernel.SOURCES, **ssd_kernel.SOURCES,
                      **flash_kernel.SOURCES}.items():
        # each function's template arguments (flash_wgmma's head dim),
        # its stack and spill bytes, then its registers
        fn = ""
        for line in library_path(src).with_suffix(
                ".log").read_text().splitlines():
            if "Function properties for" in line:
                targs = re.search(r"kernelI(\w+?)EE", line)
                fn = f" <{targs.group(1)}>" if targs else ""
            elif "registers" in line or "smem" in line or "spill" in line:
                print(f"  ptxas {name}{fn}:", line.strip())
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
                k_ms = _device_ms(lambda: minplus_kernel.minplus_sweep_cuda(
                    rows, d1 - 1, want_split=False), reps=2 if wide else 10)
                p_ms = _time_ms(lambda: minplus_sweep_ref(rows, d1 - 1),
                                reps=1 if wide else 2)
                op_ms, byte_ms = _bound_ms(T, dc1, d1, dtype,
                                           want_split=False)
                b_ms = max(op_ms, byte_ms)
                timings[(T, dc1, d1, dtype)] = (k_ms, p_ms, b_ms, op_ms,
                                                byte_ms)
                plan = minplus_kernel.sweep_plan(dc1, d1, dtype)
                print(f"sweep T={T} m_pad={dc1} d1={d1} "
                      f"{str(dtype).split('.')[-1]} plan: {_plan_str(plan)}: "
                      f"kernel_device_ms={k_ms!r} plain_ms={p_ms!r} "
                      f"bound_ms={b_ms!r} bitwise=True")
    n = len(TEST_SHAPES + SLICE_SHAPES + WIDE_SHAPES) * 2
    print(f"kernel phase ok: {n} sweep shape/dtype cases bitwise "
          f"equal, max_abs_err={max_err!r}")
    return max_err, timings


def _row_prev(dc1, d1, dtype):
    """Seeded slot inputs on the card: a row and a carry with +inf
    cells."""
    rng = np.random.default_rng(dc1 * 7 + d1)
    row = rng.random(dc1)
    row[rng.random(dc1) < 0.3] = np.inf
    row[0] = 0.0
    prev = rng.random(d1)
    prev[rng.random(d1) < 0.3] = np.inf
    prev[0] = 0.0
    return (torch.tensor(row, dtype=dtype, device="cuda"),
            torch.tensor(prev, dtype=dtype, device="cuda"))


def _slot_bounds(row, d1, dtype, plateau):
    """(ms over the ops peak, ms over HBM) for one slot on these inputs.
    One-slot kernel (``ops.minplus``: cost and argmin): an add and a
    compare per candidate ``j <= min(DC, d)``.  Plateau kernel (cost
    only): over the row's finite runs (a +inf run never lowers a
    minimum), the doubling table's minima up to the level the longest
    needs over the D+1+DC window, then an add and two minima per run and
    output.  Bytes: row and carry read, outputs (and the int32 argmin)
    written, once."""
    dc1 = row.numel()
    size = dtype.itemsize
    if plateau:
        h = row.cpu().numpy()
        starts = np.flatnonzero(np.concatenate([[True], h[1:] != h[:-1]]))
        lengths = np.diff(np.concatenate([starts, [dc1]]))[
            np.isfinite(h[starts])]
        levels = int(lengths.max(initial=1)).bit_length() - 1
        ops = levels * (d1 + dc1) + 3.0 * lengths.size * d1
    else:
        ops = 2.0 * _band_candidates(dc1, d1)
    nbytes = (dc1 + 2 * d1) * size + (0 if plateau else 4 * d1)
    return ops / PEAK_OPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3


def slot_phase():
    """The one-slot kernel (cost + argmin, and cost only) == its plain
    version bitwise, f32 and f64; at the main path's shapes timed (device
    time per launch) against its plain version through ``ops.minplus``
    (cost and argmin), the entry that runs it."""
    max_err = 0.0
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
            if dtype != torch.float64 or (dc1, d1) in SLOT_TEST_SHAPES:
                continue
            wide = (dc1, d1) in SLOT_WIDE_SHAPES
            k_ms = _device_ms(lambda: minplus_ops.minplus(row, prev),
                              5 if wide else 50)
            p_ms = _time_ms(lambda: minplus_ref(row, prev),
                            reps=1 if wide else 10)
            op_ms, byte_ms = _slot_bounds(row, d1, dtype, False)
            timings[(dc1, d1)] = (k_ms, p_ms, max(op_ms, byte_ms), op_ms,
                                  byte_ms)
            print(f"slot m_pad={dc1} d1={d1} float64: "
                  f"kernel_device_ms={k_ms!r} plain_ms={p_ms!r} "
                  f"bound_ms={max(op_ms, byte_ms)!r} ("
                  f"{'operations' if op_ms >= byte_ms else 'bytes'}; "
                  "launch latency floors a launch this small) bitwise=True")
    print(f"slot phase ok: {cases} one-slot shape/dtype cases bitwise "
          f"equal, max_abs_err={max_err!r}")
    # the one-slot entry's own path: ops.minplus (cost and first-index
    # argmin) chained over a tile's slots at each 10x bucket, counts set
    # to 0 just before and read just after
    chains = []
    for dc1 in M_PADS:
        rows = _rows(TILE, dc1, 1280, torch.float64)
        prev = torch.full((1280,), float("inf"), dtype=torch.float64,
                          device="cuda")
        prev[0] = 0.0
        chains.append((rows, prev))
    _reset_counts()
    outs = []
    for rows, prev in chains:
        for row in rows:
            prev, arg = minplus_ops.minplus(row, prev)
            outs.append((prev, arg))
    torch.cuda.synchronize()
    entry_launches = minplus_kernel.minplus_cuda.launches
    it = iter(outs)
    for rows, prev in chains:
        for row in rows:
            prev, arg = minplus_ref(row, prev)
            got, got_arg = next(it)
            if not (torch.equal(got, prev) and torch.equal(got_arg, arg)):
                raise AssertionError("ops.minplus on the card differs from "
                                     "the plain slot")
    print(f"one-slot entry (ops.minplus over {TILE} slots at each 10x "
          f"bucket, float64): minplus_slot_launches={entry_launches} "
          "bitwise=True")
    if entry_launches != TILE * len(M_PADS):
        raise AssertionError(f"{entry_launches} one-slot launches for "
                             f"{TILE * len(M_PADS)} slots")
    return max_err, timings, entry_launches


def _same_bits(a, b):
    """Equal bit for bit (+0 and -0 differ, +inf equals +inf)."""
    view = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(view), b.contiguous().view(view))


def _identity(d1, dtype):
    prev = torch.full((d1,), float("inf"), dtype=dtype, device="cuda")
    prev[0] = 0.0
    return prev


def _tile_bounds(rows, d1, dtype):
    """(ms over the ops peak, ms over HBM) for one cost-only tile: the
    sum of its slots' operation bounds (an add and a min per candidate
    ``j <= min(DC, d)``); rows and carry read, the tile's columns written,
    once."""
    n, dc1 = rows.shape
    size = dtype.itemsize
    ops = 2.0 * n * _band_candidates(dc1, d1)
    nbytes = (n * dc1 + d1 + n * d1) * size
    return ops / PEAK_OPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3


def tile_phase():
    """The chain tile (``minplus_sweep_cuda`` from a carry-in, one launch
    per tile) == ``minplus_tile`` bitwise at each 10x bucket and the wide
    bands, f32 and f64, tiles of 1, 17 and 64 slots from the identity and
    from a real DP column, written at a row offset of a larger table whose
    other rows stay untouched.  64-slot float64 tiles from a DP column
    timed (device time per launch) against the plain version."""
    max_err, cases = 0.0, 0
    for dc1, d1 in SLOT_SCALE_SHAPES + SLOT_WIDE_SHAPES:
        wide = (dc1, d1) in SLOT_WIDE_SHAPES
        for dtype in (torch.float32, torch.float64):
            rows = _rows(TILE, dc1, d1, dtype)
            carry = minplus_sweep_ref(_rows(3, dc1, d1, dtype) + 1.0,
                                      d1 - 1)[0][-1].contiguous()
            for n in (1, 17, TILE):
                for prev in (_identity(d1, dtype), carry):
                    out = torch.full((n + 4, d1), float("nan"), dtype=dtype,
                                     device="cuda")
                    minplus_kernel.minplus_sweep_cuda(
                        rows[:n], d1 - 1, prev=prev, out=out[2:n + 2])
                    want = minplus_tile(rows[:n, None, :], prev[None])[1][:, 0]
                    torch.cuda.synchronize()
                    got = out[2:n + 2]
                    fin = torch.isfinite(want)
                    if fin.any():
                        max_err = max(max_err, float(
                            (got[fin] - want[fin]).abs().max()))
                    if not (_same_bits(got, want)
                            and bool(torch.isnan(out[:2]).all())
                            and bool(torch.isnan(out[n + 2:]).all())):
                        raise AssertionError(
                            f"minplus_tile {n} slots m_pad={dc1} d1={d1} "
                            f"{dtype}: kernel differs from the plain version "
                            "or wrote outside its rows")
                    cases += 1
            if dtype != torch.float64:
                continue
            out = torch.empty((TILE, d1), dtype=dtype, device="cuda")
            reps = 3 if wide else 50
            plan = minplus_kernel.sweep_plan(dc1, d1, dtype)
            k_ms = _device_ms(lambda: minplus_kernel.minplus_sweep_cuda(
                rows, d1 - 1, prev=carry, out=out), reps)
            p_ms = _time_ms(lambda: minplus_tile(rows[:, None, :],
                                                 carry[None]),
                            reps=1 if wide else 3)
            op_ms, byte_ms = _tile_bounds(rows, d1, dtype)
            print(f"tile {TILE} slots m_pad={dc1} d1={d1} float64 plan: "
                  f"{_plan_str(plan)}: kernel_device_ms={k_ms!r} "
                  f"per_slot_ms={k_ms / TILE!r} plain_ms={p_ms!r} "
                  f"bound_ms={max(op_ms, byte_ms)!r} "
                  f"({'operations' if op_ms >= byte_ms else 'bytes'}) "
                  "bitwise=True")
    print(f"tile phase ok: {cases} tile shape/dtype/length/carry cases "
          f"bitwise equal, max_abs_err={max_err!r}")
    return max_err


def tile_lanes_phase(B=8):
    """The chain tile over ``B`` lanes in one launch (one cluster per
    lane, a grid of (C, B)) == ``minplus_tile`` lane by lane and == B
    one-lane launches, bitwise, at each 10x bucket, f32 and f64, 17 and 64
    slots from real DP columns, each lane's rows, carry and columns rows
    of larger tables (the route's lane strides) whose other rows stay
    untouched.  64-slot float64 launches timed (device time per launch)
    against B one-lane launches and the plain version."""
    max_err, cases = 0.0, 0
    for dc1, d1 in SLOT_SCALE_SHAPES:
        for dtype in (torch.float32, torch.float64):
            rows_all = _rows(B * (TILE + 4), dc1, d1, dtype).view(
                B, TILE + 4, dc1)
            carry = minplus_sweep_ref(_rows(3, dc1, d1, dtype) + 1.0,
                                      d1 - 1)[0][-1]
            table = torch.full((B, TILE + 5, d1), float("nan"), dtype=dtype,
                               device="cuda")
            table[:, 0] = carry + torch.arange(B, dtype=dtype,
                                               device="cuda")[:, None]
            prev = table[:, 0]
            for n in (17, TILE):
                rows = rows_all[:, 2:n + 2]
                table[:, 1:] = float("nan")
                minplus_kernel.minplus_sweep_cuda(rows, d1 - 1, prev=prev,
                                                  out=table[:, 3:n + 3])
                for b in range(B):
                    want = minplus_tile(rows[b][:, None, :],
                                        prev[b][None])[1][:, 0]
                    one = torch.empty((n, d1), dtype=dtype, device="cuda")
                    minplus_kernel.minplus_sweep_cuda(
                        rows[b].contiguous(), d1 - 1,
                        prev=prev[b].contiguous(), out=one)
                    torch.cuda.synchronize()
                    got = table[b, 3:n + 3]
                    fin = torch.isfinite(want)
                    if fin.any():
                        max_err = max(max_err, float(
                            (got[fin] - want[fin]).abs().max()))
                    if not (_same_bits(got, want) and _same_bits(one, want)):
                        raise AssertionError(
                            f"minplus_tile {B} lanes, lane {b}, {n} slots "
                            f"m_pad={dc1} {dtype}: the lane launch differs "
                            "from the plain tile or a one-lane launch")
                if not (bool(torch.isnan(table[:, 1:3]).all())
                        and bool(torch.isnan(table[:, n + 3:]).all())):
                    raise AssertionError(f"minplus_tile {B} lanes m_pad="
                                         f"{dc1}: wrote outside its rows")
                cases += 1
            if dtype != torch.float64:
                continue
            rows = rows_all[:, :TILE]
            out = torch.empty((B, TILE, d1), dtype=dtype, device="cuda")
            k_ms = _device_ms(lambda: minplus_kernel.minplus_sweep_cuda(
                rows, d1 - 1, prev=prev, out=out), 20)
            rows_c = [rows[b].contiguous() for b in range(B)]
            prev_c = [prev[b].contiguous() for b in range(B)]

            def one_lane_each():
                for b in range(B):
                    minplus_kernel.minplus_sweep_cuda(
                        rows_c[b], d1 - 1, prev=prev_c[b], out=out[b])
            o_ms = _device_ms(one_lane_each, 5)
            p_ms = _time_ms(lambda: minplus_tile(rows.transpose(0, 1), prev),
                            reps=1)
            op_ms, byte_ms = _tile_bounds(rows.reshape(B * TILE, dc1), d1,
                                          dtype)
            print(f"tile {B} lanes x {TILE} slots m_pad={dc1} d1={d1} "
                  f"float64: kernel_device_ms={k_ms!r} "
                  f"{B}_one_lane_launches_ms={o_ms!r} "
                  f"per_lane_slot_ms={k_ms / (B * TILE)!r} plain_ms={p_ms!r} "
                  f"bound_ms={max(op_ms, byte_ms)!r} bitwise=True")
    print(f"tile lanes phase ok: {cases} lane-launch shape/dtype/length "
          f"cases bitwise equal to the plain tile and one-lane launches, "
          f"max_abs_err={max_err!r}")
    return max_err


def _plateau_rows(n, dc1, d1, dtype, runs):
    """Seeded run-compressed rows on the card: ``n`` rows of exactly
    ``runs`` runs of equal values each (0 first, the last run +inf in
    every other row, as COST rows end)."""
    rng = np.random.default_rng(dc1 * 7 + d1 + runs)
    rows = np.empty((n, dc1))
    for t in range(n):
        vals = np.concatenate([[0.0], rng.random(runs - 1) + 0.5])
        if t % 2 and runs > 1:
            vals[-1] = np.inf
        cuts = np.sort(rng.choice(np.arange(1, dc1), runs - 1,
                                  replace=False))
        rows[t] = np.repeat(vals, np.diff(np.concatenate([[0], cuts,
                                                          [dc1]])))
    return torch.tensor(rows, dtype=dtype, device="cuda")


def _plain_plateau_tile(rows, prev):
    """The plain tile: ``monotone.plateau_step`` chained over the rows."""
    cols = []
    for row in rows:
        prev = plateau_step(row, prev)
        cols.append(prev)
    return torch.stack(cols)


def _plateau_tile_bounds(rows, d1, dtype):
    """(ms over the ops peak, ms over HBM) for one plateau tile on these
    rows: the operations of :func:`_slot_bounds` slot by slot (the table
    levels each row's longest run needs, an add and two minima per run
    and output); rows and carry read, the tile's columns written, once."""
    n, dc1 = rows.shape
    ops_ms = sum(_slot_bounds(row, d1, dtype, True)[0] for row in rows)
    nbytes = (n * dc1 + d1 + n * d1) * dtype.itemsize
    return ops_ms, nbytes / PEAK_BYTES * 1e3


def _plateau_plan_str(plan):
    return (f"C={plan.cluster} w={plan.w} threads={plan.threads} "
            f"levels={plan.kmax} table="
            f"{'shared' if plan.table_shared else 'global'}")


def plateau_tile_phase():
    """The plateau tile (``minplus_plateau_cuda``, one launch per tile)
    == the plain tile and == the chain (``minplus_sweep_cuda`` given the
    same carry) bitwise: every one-slot shape, d1 = 64 C shapes that take
    clusters of 4 and 8, f32 and f64, rows of 1, r_max - 1, r_max and
    3 r_max runs (the last through the direct loop), tiles of 1, 17 and 64
    slots from the identity and from a real DP column, under the planned
    table placement and the global one, written at a row offset of a
    larger table whose other rows stay untouched."""
    max_err, cases = 0.0, 0
    for dc1, d1 in (SLOT_TEST_SHAPES + SLOT_SCALE_SHAPES + SLOT_WIDE_SHAPES
                    + PLATEAU_CLUSTER_SHAPES):
        for dtype in (torch.float32, torch.float64):
            plans = {minplus_kernel.plateau_plan(dc1, d1, dtype, R_MAX),
                     minplus_kernel.plateau_plan(dc1, d1, dtype, R_MAX,
                                                 table_shared=False)}
            carry = minplus_sweep_ref(_rows(3, dc1, d1, dtype) + 1.0,
                                      d1 - 1)[0][-1].contiguous()
            for runs in sorted({min(r, dc1) for r in
                                (1, R_MAX - 1, R_MAX, 3 * R_MAX)}):
                rows = _plateau_rows(TILE, dc1, d1, dtype, runs)
                if not bool((run_count(rows) == runs).all()):
                    raise AssertionError("plateau rows of the wrong run count")
                for prev in (_identity(d1, dtype), carry):
                    want = _plain_plateau_tile(rows, prev)
                    chain, _ = minplus_kernel.minplus_sweep_cuda(
                        rows, d1 - 1, prev=prev)
                    fin = torch.isfinite(want)
                    for n in (1, 17, TILE):
                        for plan in plans:
                            out = torch.full((n + 4, d1), float("nan"),
                                             dtype=dtype, device="cuda")
                            minplus_kernel.minplus_plateau_cuda(
                                rows[:n], prev, r_max=R_MAX,
                                out=out[2:n + 2], plan=plan)
                            torch.cuda.synchronize()
                            got = out[2:n + 2]
                            if fin[:n].any():
                                max_err = max(max_err, float(
                                    (got[fin[:n]] - want[:n][fin[:n]])
                                    .abs().max()))
                            if not (_same_bits(got, want[:n])
                                    and _same_bits(got, chain[:n])
                                    and bool(torch.isnan(out[:2]).all())
                                    and bool(torch.isnan(out[n + 2:]).all())):
                                raise AssertionError(
                                    f"minplus_plateau {n} slots m_pad={dc1} "
                                    f"d1={d1} {dtype} runs={runs} plan "
                                    f"{_plateau_plan_str(plan)}: kernel "
                                    "differs from the plain tile or the "
                                    "chain, or wrote outside its rows")
                            cases += 1
            if dtype == torch.float64:
                print(f"plateau m_pad={dc1} d1={d1} float64 plans: " + "; ".join(
                    _plateau_plan_str(p) for p in sorted(plans)))
    print(f"plateau tile phase ok: {cases} shape/dtype/runs/carry/length/plan "
          f"cases bitwise equal to the plain tile and the chain, "
          f"max_abs_err={max_err!r}")
    return max_err


# the D&C tile phase's shapes: the reference's randomized set and the
# route's (m_pad 64, d1 1280)
DNC_SHAPES = [(dc1, d1) for dc1 in (5, 17, 64) for d1 in (33, 129, 1280)]


def _dnc_rows(n, dc1, d1, dtype):
    """Seeded certified-convex rows on the card: 0 first, then random
    increasing increments rounded to quarters (linear stretches, so
    ties), a +inf suffix in every third row, an identity row last."""
    rng = np.random.default_rng(dc1 * 31 + d1)
    rows = np.empty((n, dc1))
    for i in range(n):
        inc = np.round(np.sort(rng.random(dc1 - 1)) * 4) / 4.0
        rows[i] = np.concatenate([[0.0], np.cumsum(inc)])
        if i % 3 == 2:
            rows[i, max(dc1 // 2, 1):] = np.inf
    rows[-1, 1:] = np.inf
    return torch.tensor(rows, dtype=dtype, device="cuda")


def _plain_dnc_tile(rows, prev, scanned=None):
    """The plain tile: ``monotone.monotone_dnc_step`` chained over the
    rows (on the host, in numpy; a spilled slot takes the chain, as the
    reference's dispatch does), on the card.  ``scanned`` collects the
    candidates each level scans."""
    cols = []
    for row in rows:
        new, overflow = monotone_dnc_step(row, prev, scanned)
        if overflow:
            new = minplus_tile(row[None, None, :], prev[None])[1][0, 0]
        cols.append(new)
        prev = new
    return torch.stack(cols)


def _dnc_tile_bounds(rows, prev, scanned):
    """(ms over the ops peak, ms over HBM) for one D&C tile: an add and a
    compare per candidate the recursion scans on this tile's data
    (``scanned``, the plain tile's count of each level's ranges, each
    whole, as the kernel scans them); rows and carry read, the tile's
    columns written, once."""
    n, dc1 = rows.shape
    d1 = prev.numel()
    dtype = rows.dtype
    ops = 2.0 * sum(scanned)
    nbytes = (n * dc1 + d1 + n * d1) * dtype.itemsize
    return ops / PEAK_OPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3


def dnc_tile_phase():
    """The D&C tile (``minplus_dnc_cuda``, one launch per tile) == the
    plain tile (``monotone_dnc_step`` chained) and == the chain
    (``minplus_sweep_cuda`` given the same carry) bitwise, on
    certified-convex rows (ties, +inf suffixes, identity rows) at dc1 5,
    17, 64 by d1 33, 129, 1280, f32 and f64, tiles of 1, 17 and 64 slots
    from the identity and from a real DP column, under the planned
    placement and the global one, written at a row offset of a larger
    table.  The certificate on the card against the host's on rows one
    ulp from convex.  64-slot tiles timed (device time per launch)
    against the chain kernel on the same rows and the bound."""
    max_err, cases = 0.0, 0
    # the exact certificate on the card: no contraction, no reassociation
    js = np.arange(32, dtype=np.float64)
    crafted = [js * 3.0, js * js]
    for k in (3, 7, 20):
        for step in (np.inf, -np.inf):
            r = js * 3.0
            r[k] = np.nextafter(r[k], step)
            crafted.append(r)
    for dtype in (torch.float32, torch.float64):
        rows = np.stack([r.astype(str(dtype).split(".")[-1])
                         for r in crafted])
        got = convex_certificate(torch.tensor(rows, device="cuda")).cpu()
        if not np.array_equal(got.numpy(), convex_certificate_np(rows)):
            raise AssertionError(f"convex_certificate on the card differs "
                                 f"from the host's in {dtype}")
    for dc1, d1 in DNC_SHAPES:
        for dtype in (torch.float32, torch.float64):
            rows = _dnc_rows(TILE, dc1, d1, dtype)
            if not bool(convex_certificate(rows).all()):
                raise AssertionError("D&C rows not certified convex")
            carry = minplus_sweep_ref(_rows(3, dc1, d1, dtype) + 1.0,
                                      d1 - 1)[0][-1].contiguous()
            plans = {minplus_kernel.dnc_plan(dc1, d1, dtype),
                     minplus_kernel.DncPlan(
                         minplus_kernel.DNC_THREADS, False,
                         minplus_kernel._dnc_smem(
                             dc1, d1, dtype.itemsize,
                             minplus_kernel.DNC_THREADS, False))}
            for prev in (_identity(d1, dtype), carry):
                scanned = []
                want = _plain_dnc_tile(rows, prev, scanned)
                chain, _ = minplus_kernel.minplus_sweep_cuda(
                    rows, d1 - 1, prev=prev)
                fin = torch.isfinite(want)
                for n in (1, 17, TILE):
                    for plan in plans:
                        out = torch.full((n + 4, d1), float("nan"),
                                         dtype=dtype, device="cuda")
                        minplus_kernel.minplus_dnc_cuda(
                            rows[:n], prev, out=out[2:n + 2], plan=plan)
                        torch.cuda.synchronize()
                        got = out[2:n + 2]
                        if fin[:n].any():
                            max_err = max(max_err, float(
                                (got[fin[:n]] - want[:n][fin[:n]])
                                .abs().max()))
                        if not (_same_bits(got, want[:n])
                                and _same_bits(got, chain[:n])
                                and bool(torch.isnan(out[:2]).all())
                                and bool(torch.isnan(out[n + 2:]).all())):
                            raise AssertionError(
                                f"minplus_dnc {n} slots m_pad={dc1} d1={d1} "
                                f"{dtype} plan {plan}: kernel differs from "
                                "the plain tile or the chain, or wrote "
                                "outside its rows")
                        cases += 1
            out = torch.empty((TILE, d1), dtype=dtype, device="cuda")
            k_ms = _device_ms(lambda: minplus_kernel.minplus_dnc_cuda(
                rows, carry, out=out), 10)
            c_ms = _device_ms(lambda: minplus_kernel.minplus_sweep_cuda(
                rows, d1 - 1, prev=carry, out=out), 10)
            op_ms, byte_ms = _dnc_tile_bounds(rows, carry, scanned)
            print(f"dnc tile {TILE} slots m_pad={dc1} d1={d1} "
                  f"{str(dtype).split('.')[-1]} plan "
                  f"{minplus_kernel.dnc_plan(dc1, d1, dtype)}: "
                  f"kernel_device_ms={k_ms!r} per_slot_ms={k_ms / TILE!r} "
                  f"chain_kernel_ms={c_ms!r} bound_ms={max(op_ms, byte_ms)!r}"
                  f" ({'operations' if op_ms >= byte_ms else 'bytes'}) "
                  "bitwise=True")
    print(f"dnc tile phase ok: {cases} shape/dtype/carry/length/plan cases "
          f"bitwise equal to the plain tile and the chain, "
          f"max_abs_err={max_err!r}")
    return max_err


def _counted():
    """(sweep kernel, one-slot, plateau) launches so far: on the tiled
    route every sweep-kernel launch is a chain tile's and every plateau
    launch a plateau tile's."""
    return (minplus_kernel.minplus_sweep_cuda.launches,
            minplus_kernel.minplus_cuda.launches,
            minplus_kernel.minplus_plateau_cuda.launches)


def _reset_counts():
    minplus_kernel.minplus_sweep_cuda.launches = 0
    minplus_kernel.minplus_cuda.launches = 0
    minplus_kernel.minplus_plateau_cuda.launches = 0
    minplus_kernel.minplus_dnc_cuda.launches = 0
    schedule_torch.monotone_counters_reset()


def _tiled_launches_ok(snap, counts):
    """The tiled route's launches: no one-slot launch, one sweep-kernel
    launch per chain tile and one plateau launch per plateau tile (every
    visited tile has live slots)."""
    c_n, a_n, b_n = counts
    return a_n == 0 and c_n == snap["chain"] and b_n == snap["plateau"]


def paper_phase():
    """Both routes on the card against the port on the CPU, paper scale:
    the whole route on the card == on the CPU, and the tiled route on the
    card == the tiled route on the CPU == the whole route (both are held
    to the reference's impl="fast" there), with the plateau kernel
    firing.  One seed: the CPU tests hold seeds 0..4 to the reference.
    Returns the card's run per route (the learned phase's replays are
    held to them)."""
    for seed in (0,):
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tgpu = engine.run(cluster, jobs, quantum=0, core="tiled")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap = schedule_torch.monotone_counters_snapshot()
        counts = _counted()
        c_n, _, b_n = counts
        tcpu = engine.run(cluster, jobs, quantum=0, core="tiled",
                          device="cpu")
        rels = [abs(tgpu.total_utility - x.total_utility)
                / max(abs(x.total_utility), 1e-300) for x in (tcpu, gpu)]
        print(f"paper scale seed {seed}, tiled: accepted gpu={tgpu.accepted}"
              f" cpu={tcpu.accepted} utility gpu={tgpu.total_utility!r} "
              f"cpu={tcpu.total_utility!r} rel_diff_cpu={rels[0]!r} "
              f"rel_diff_whole_gpu={rels[1]!r} wall_s={wall!r} "
              f"plateau_tiles={snap['plateau']} plateau_slots="
              f"{snap['plateau_slots']} chain_tiles={snap['chain']} "
              f"tile_launches={c_n} plateau_launches={b_n}")
        if not (tgpu.completion == tcpu.completion == gpu.completion
                and max(rels) <= 1e-9 and snap["plateau"] > 0
                and _tiled_launches_ok(snap, counts) and b_n > 0):
            raise AssertionError(f"seed {seed}: the tiled route on the card "
                                 "differs from the CPU's or the whole "
                                 "route's, or took no plateau tile")
    return {"whole": gpu, "tiled": tgpu}


# the CPU pins of the D&C engine run and of the float32 runs, written by
# tools/precision_cpu.py
PRECISION_CPU = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tools", "precision_cpu.json")
# the float32 runs: (instance, route); "paper" is the paper-scale
# instance (T=100, H=K=50, 200 small jobs of seed 0), "scale" the 10x one
# (SCALE_DIMS), quantum=0 both
PRECISION_RUNS = (("paper", "whole"), ("paper", "tiled"), ("scale", "whole"),
                  ("scale", "tiled"))


def _instance(name):
    if name == "paper":
        return (make_cluster(T=100, H=50, K=50),
                make_jobs(200, T=100, seed=0, small=True))
    return (make_cluster(T=SCALE["T"], H=SCALE["H"], K=SCALE["K"]),
            make_jobs(SCALE["n"], T=SCALE["T"], seed=0))


def precision_run(instance, core, device=None):
    """One float32 run (``precision="x32"``) of ``instance`` on ``core``."""
    cluster, jobs = _instance(instance)
    return engine.run(cluster, jobs, quantum=0, core=core, precision="x32",
                      device=device)


def dnc_run(device=None):
    """The paper-scale instance on the tiled route with the D&C branch on
    (``REPRO_MONOTONE_DNC=1``, restored after); (result, the route's
    counters)."""
    cluster, jobs = _instance("paper")
    old = os.environ.get("REPRO_MONOTONE_DNC")
    os.environ["REPRO_MONOTONE_DNC"] = "1"
    try:
        schedule_torch.monotone_counters_reset()
        res = engine.run(cluster, jobs, quantum=0, core="tiled",
                         device=device)
        snap = schedule_torch.monotone_counters_snapshot()
    finally:
        if old is None:
            del os.environ["REPRO_MONOTONE_DNC"]
        else:
            os.environ["REPRO_MONOTONE_DNC"] = old
    return res, snap


def run_pin(res):
    """A run's pin: accepted count, the sha256 of the accepted set and of
    the completions, the total utility (bit for bit through JSON)."""
    import hashlib
    return {"accepted": res.accepted,
            "accepted_sha256": hashlib.sha256(json.dumps(sorted(
                int(j) for j in res.schedules)).encode()).hexdigest(),
            "completion_sha256": _completion_digest(res.completion),
            "total_utility": res.total_utility}


def dnc_pin(res, snap):
    """The D&C run's pin: :func:`run_pin` and its tiles per branch and
    live slots of D&C and plateau tiles."""
    return {**run_pin(res),
            "tiles": [snap["dnc"], snap["plateau"], snap["chain"]],
            "dnc_slots": snap["dnc_slots"],
            "plateau_slots": snap["plateau_slots"]}


def _precision_pins():
    with open(PRECISION_CPU) as f:
        return json.load(f)


def dnc_engine_phase(paper):
    """The D&C branch on the tiled route's main path: the paper-scale
    instance with ``REPRO_MONOTONE_DNC=1``, the kernel counts set to 0
    just before the run and read just after: one D&C-kernel launch per
    D&C tile, one sweep-kernel launch per chain tile, one plateau launch
    per plateau tile; its trajectory equal to the switch-off run's
    (``paper["tiled"]``) and to the port's on the CPU, its tile counts
    per branch the CPU's (``tools/precision_cpu.json``).  Each D&C tile's
    rows and carry are kept (copies on the card) and the tiles timed on
    their own (:func:`dnc_mix_phase`).  Returns (D&C launches, tiles)."""
    want = _precision_pins()["dnc paper tiled"]
    tiles = []
    dnc_tile = schedule_torch.minplus_dnc_tile

    def recorded(rows, prev, out):
        tiles.append((rows.clone(), prev.clone()))
        return dnc_tile(rows, prev, out)

    schedule_torch.minplus_dnc_tile = recorded
    try:
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, snap = dnc_run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counted()
        d_n = minplus_kernel.minplus_dnc_cuda.launches
    finally:
        schedule_torch.minplus_dnc_tile = dnc_tile
    got = dnc_pin(res, snap)
    off = paper["tiled"]
    print(f"paper scale seed 0, tiled, REPRO_MONOTONE_DNC=1: wall_s={wall!r} "
          f"accepted={res.accepted} utility={res.total_utility!r} "
          f"tiles [dnc, plateau, chain]={got['tiles']} dnc_slots="
          f"{got['dnc_slots']} plateau_slots={got['plateau_slots']} "
          f"dnc_launches={d_n} tile_launches={counts[0]} plateau_launches="
          f"{counts[2]} slot_launches={counts[1]} same_as_switch_off="
          f"{res.completion == off.completion} same_as_cpu={got == want}")
    if not (got == want and res.completion == off.completion
            and res.total_utility == off.total_utility
            and d_n == snap["dnc"] > 0 and counts[0] == snap["chain"]
            and counts[2] == snap["plateau"] and counts[1] == 0
            and len(tiles) == d_n):
        raise AssertionError(f"the D&C run on the card: {got} with launches "
                             f"(sweep, slot, plateau, dnc) {counts + (d_n,)}, "
                             f"the CPU's {want}, or another trajectory than "
                             "the switch-off run's")
    return d_n, tiles


def dnc_mix_phase(tiles):
    """The D&C tile on the D&C run's own tiles: each, on its own rows and
    carry, held bitwise to the plain tile and the chain, then timed
    (device time per launch) against the chain kernel on the same inputs
    and the plain tile (its host wall); the bound is each tile's
    (:func:`_dnc_tile_bounds`).  Returns (ms, plain ms, bound ms, ops ms,
    bytes ms), means over the tiles, each tile one launch."""
    total = [0.0] * 6
    slots = 0
    for rows, prev in tiles:
        n, dc1 = rows.shape
        d1 = prev.numel()
        out = torch.empty((n, d1), dtype=rows.dtype, device="cuda")
        minplus_kernel.minplus_dnc_cuda(rows, prev, out=out)
        scanned = []
        t0 = time.perf_counter()
        want = _plain_dnc_tile(rows, prev, scanned)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        chain, _ = minplus_kernel.minplus_sweep_cuda(rows, d1 - 1, prev=prev)
        if not (_same_bits(out, want) and _same_bits(out, chain)):
            raise AssertionError(f"a D&C tile of the route ({n} slots, "
                                 f"m_pad={dc1}, d1={d1}): kernel differs "
                                 "from the plain tile or the chain")
        k_ms = _device_ms(lambda: minplus_kernel.minplus_dnc_cuda(
            rows, prev, out=out), 10)
        c_ms = _device_ms(lambda: minplus_kernel.minplus_sweep_cuda(
            rows, d1 - 1, prev=prev, out=out), 10)
        op_ms, byte_ms = _dnc_tile_bounds(rows, prev, scanned)
        for i, x in enumerate((k_ms, p_ms, max(op_ms, byte_ms), op_ms,
                               byte_ms, c_ms)):
            total[i] += x
        slots += n
    mean = [x / len(tiles) for x in total]
    per = slots / len(tiles)
    shapes = sorted({(r.shape[1], p.numel(), str(r.dtype).split(".")[-1])
                     for r, p in tiles})
    print(f"dnc tile over the D&C run's own tiles ({len(tiles)} tiles, "
          f"{per!r} live slots a tile, shapes {shapes}; each bitwise the "
          f"plain tile and the chain): kernel_device_ms={mean[0]!r} "
          f"per_slot_ms={mean[0] / per!r} chain_kernel_ms={mean[5]!r} "
          f"chain_per_slot_ms={mean[5] / per!r} plain_ms={mean[1]!r} "
          f"bound_ms={mean[2]!r} (ops {mean[3]!r}, bytes {mean[4]!r})")
    return mean[:5]


def precision_phase():
    """The float32 route (``precision="x32"``) on both routes at paper
    scale and at 10x, each run with the kernel counts set to 0 just
    before it and read just after (the whole route one float32 sweep per
    DP decision; the tiled route one launch per chain and per plateau
    tile), each held to its CPU pin (``tools/precision_cpu.json``):
    accepted set, completions and total utility, exactly."""
    pins = _precision_pins()
    for instance, core in PRECISION_RUNS:
        cluster, jobs = _instance(instance)
        live = [engine._with_quantum(j, 0) for j in jobs
                if j.arrival < cluster.T]
        dp_decisions = sum(_shape_bucket(j) is not None for j in live)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = precision_run(instance, core)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counted()
        snap = schedule_torch.monotone_counters_snapshot()
        got, want = run_pin(res), pins[f"x32 {instance} {core}"]
        ds = np.asarray(res.decision_seconds) * 1e3
        print(f"float32 {instance} {core}: wall_s={wall!r} decisions="
              f"{len(ds)} decision_p50_ms={float(np.percentile(ds, 50))!r} "
              f"decision_p95_ms={float(np.percentile(ds, 95))!r} "
              f"accepted={res.accepted} utility={res.total_utility!r} "
              f"launches (sweep, slot, plateau)={counts} tiles [dnc, "
              f"plateau, chain]=[{snap['dnc']}, {snap['plateau']}, "
              f"{snap['chain']}] same_as_cpu={got == want}")
        if core == "whole":
            launched = counts == (dp_decisions, 0, 0)
        else:
            launched = (_tiled_launches_ok(snap, counts)
                        and snap["dnc"] == 0 and counts[0] + counts[2] > 0)
        if not (got == want and launched):
            raise AssertionError(f"float32 {instance} {core}: {got} on the "
                                 f"card, {want} on the CPU, launches "
                                 f"{counts}")


def scale_phase():
    """The whole route at the 10x instance, counting sweep launches, held
    to the port on the CPU (:data:`SCALE_WHOLE_CPU`: utility, accepted
    jobs and completions, exactly)."""
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
    got = (res.total_utility, res.accepted,
           _completion_digest(res.completion))
    same = got == SCALE_WHOLE_CPU
    print(f"10x whole route against the port on the CPU: same utility, "
          f"accepted jobs and completions {same} "
          f"(completion_sha256={got[2]})")
    if got != SCALE_WHOLE_CPU:
        raise AssertionError(f"10x whole route: {got} on the card, "
                             f"{SCALE_WHOLE_CPU} on the CPU")
    hist = {}
    for b in buckets:
        if b is not None:
            hist[b[0]] = hist.get(b[0], 0) + 1
    print(f"10x sweep shapes (m_pad: launches): {dict(sorted(hist.items()))}")
    return launches, hist, res.total_utility


def _tiled_line(label, wall, res, snap, counts, dp_decisions):
    """One line of the tiled route's counts: decisions (speculative ones
    and re-solves among them), tiles served from the row caches, kernel
    launches (each a tile of all its lanes) per DP decision of the trace
    and per decision run."""
    c_n, a_n, b_n = counts
    ds = np.asarray(res.decision_seconds) * 1e3
    tiles = snap["plateau"] + snap["chain"]
    n_dec = max(snap["decisions"], 1)
    print(f"{label}: wall_s={wall!r} decisions={len(ds)} "
          f"decisions_per_s={len(ds) / wall!r} "
          f"decision_p50_ms={float(np.percentile(ds, 50))!r} "
          f"decision_p95_ms={float(np.percentile(ds, 95))!r} "
          f"total_utility={res.total_utility!r} accepted={res.accepted} "
          f"device_uploads={res.device_uploads} "
          f"core_decisions={snap['decisions']} "
          f"speculative={snap['speculative']} resolves={snap['resolves']} "
          f"core_launches={snap['launches']} "
          f"cache_tiles={snap['cache_tiles']} "
          f"minplus_tile_launches={c_n} minplus_plateau_launches={b_n} "
          f"minplus_slot_launches={a_n} live_slots={snap['slots']} "
          f"plateau_slots={snap['plateau_slots']} "
          f"tiles_visited={tiles} tiles_per_core_decision={tiles / n_dec!r} "
          f"dp_launches_per_job={(b_n + c_n) / max(dp_decisions, 1)!r} "
          f"dp_launches_per_core_decision={(b_n + c_n) / n_dec!r} "
          f"paths={{'plateau': {snap['plateau']}, 'chain': {snap['chain']}}}")


def _check_tiled(label, res, snap, counts, dp_decisions, n_live):
    """One launch per chain tile and per plateau tile, none of the
    one-slot kernel; every job of the trace decided once (a burst's
    speculatively), plus the re-solves."""
    if (not _tiled_launches_ok(snap, counts) or counts[0] == 0
            or snap["decisions"] - snap["resolves"] != dp_decisions):
        raise AssertionError(f"{label}: launches (sweep kernel, one-slot, "
                             f"plateau) {counts} for {snap['chain']} chain "
                             f"tiles and {snap['plateau']} plateau tiles, "
                             f"{snap['decisions']} decisions with "
                             f"{snap['resolves']} re-solves for "
                             f"{dp_decisions} DP decisions")
    if len(res.decision_seconds) != n_live or res.device_uploads != 1:
        raise AssertionError(f"{label}: decision count or upload count is "
                             "off")


def tiled_scale_phase(whole_utility):
    """The tiled route at the 10x instance, counting launches: one
    sweep-kernel launch per chain tile, one plateau launch per plateau
    tile, no one-slot launch; the utility held to the reference's tiled
    engine.  The route's ``minplus_chain`` is wrapped to record each chain
    tile's shape (live slots, band, columns, dtype) and its
    ``minplus_plateau_tile`` to keep each plateau tile's rows and carry (a
    copy of each on the card), so the kernels line can time both kernels
    on this run's own mix (:func:`tile_mix_phase`,
    :func:`plateau_mix_phase`).  Returns (tile launches, plateau launches,
    the chain tiles' shapes, the plateau tiles, the run's completions)."""
    cluster = make_cluster(T=SCALE["T"], H=SCALE["H"], K=SCALE["K"])
    jobs = make_jobs(SCALE["n"], T=SCALE["T"], seed=0)
    live = [engine._with_quantum(j, 0) for j in jobs if j.arrival < cluster.T]
    dp_decisions = sum(_shape_bucket(j) is not None for j in live)
    shapes, plateau_tiles = [], []
    chain = schedule_torch.minplus_chain
    plateau = schedule_torch.minplus_plateau_tile

    def recorded(rows, prev, out):
        shapes.append((*rows.shape, prev.shape[-1], rows.dtype))
        return chain(rows, prev, out)

    def recorded_plateau(rows, prev, out, r_max):
        plateau_tiles.append((rows.clone(), prev.clone(), r_max))
        return plateau(rows, prev, out, r_max)

    schedule_torch.minplus_chain = recorded
    schedule_torch.minplus_plateau_tile = recorded_plateau
    try:
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.run(cluster, jobs, quantum=0, core="tiled", check=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counted()
    finally:
        schedule_torch.minplus_chain = chain
        schedule_torch.minplus_plateau_tile = plateau
    c_n, a_n, b_n = counts
    snap = schedule_torch.monotone_counters_snapshot()
    _tiled_line("10x instance, tiled route (bursts, 1 lane a launch)", wall,
                res, snap, counts, dp_decisions)
    rel = abs(res.total_utility - JAX_TILED_UTILITY) / JAX_TILED_UTILITY
    print(f"10x utility: tiled route {res.total_utility!r}, whole route "
          f"{whole_utility!r}, reference tiled engine on a CPU "
          f"{JAX_TILED_UTILITY!r} (rel_diff {rel!r})")
    _check_tiled("10x tiled route", res, snap, counts, dp_decisions,
                 len(live))
    if b_n == 0 or snap["speculative"] == 0 or snap["resolves"] == 0:
        raise AssertionError("10x tiled route: no plateau tile, or no "
                             "burst decided together and re-solved")
    if not (np.isfinite(res.total_utility) and 0 < res.accepted <= len(live)
            and rel <= 1e-9):
        raise AssertionError(f"tiled route: {res.total_utility} utility, "
                             f"{res.accepted} accepted, against the "
                             f"reference's {JAX_TILED_UTILITY}")
    if len(shapes) != c_n or len(plateau_tiles) != b_n:
        raise AssertionError(f"{len(shapes)} chain and {len(plateau_tiles)} "
                             f"plateau tiles recorded for {c_n} and {b_n} "
                             "launches")
    return c_n, b_n, shapes, plateau_tiles, res


def burst_phase(one_lane):
    """The 10x tiled route two more ways, each with the counts set to 0
    just before it and read just after: one job at a time (``on_arrival``
    in the engine's order: no burst, no row cache), and through the engine
    at eight lanes a launch (``REPRO_BURST_LANES=8``: a chain tile steps
    up to eight lanes' slots in one launch, one cluster per lane).  Both
    are held to the one-lane burst run ``one_lane``: the same completions
    and the same utility, exactly.  Returns (the eight-lane run's chain
    launches, its chain launches' shapes (lanes, slots, band, columns,
    dtype))."""
    from repro_torch.core.oasis import OASiS
    cluster = make_cluster(T=SCALE["T"], H=SCALE["H"], K=SCALE["K"])
    jobs = make_jobs(SCALE["n"], T=SCALE["T"], seed=0)
    live = [engine._with_quantum(j, 0) for j in jobs if j.arrival < cluster.T]
    dp_decisions = sum(_shape_bucket(j) is not None for j in live)
    params = price_params_from_jobs(jobs, cluster)
    by_slot, _ = engine._group_events(live, None, cluster.T)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = OASiS(cluster, params, core="tiled")
    for t in sorted(by_slot):
        for job in by_slot[t]:
            seq.on_arrival(job)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = schedule_torch.monotone_counters_snapshot()
    counts = _counted()
    seq_res = engine.SimResult(
        name="oasis", total_utility=seq.total_utility,
        accepted=len(seq.accepted), completed=len(seq.accepted),
        n_jobs=len(jobs),
        completion={j: s.finish for j, s in seq.accepted.items()},
        target_gap=[], decision_seconds=seq.decision_seconds,
        utilization=0.0, device_uploads=seq.state.device_uploads)
    _tiled_line("10x instance, tiled route one job at a time (no bursts)",
                wall, seq_res, snap, counts, dp_decisions)
    _check_tiled("10x sequential tiled route", seq_res, snap, counts,
                 dp_decisions, len(live))
    if snap["speculative"] or snap["resolves"] or snap["cache_tiles"]:
        raise AssertionError("the sequential route decided a burst")
    shapes = []
    chain = schedule_torch.minplus_chain

    def recorded(rows, prev, out):
        shapes.append((*rows.shape, prev.shape[-1], rows.dtype))
        return chain(rows, prev, out)

    schedule_torch.minplus_chain = recorded
    os.environ["REPRO_BURST_LANES"] = "8"
    try:
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.run(cluster, jobs, quantum=0, core="tiled", check=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts8 = _counted()
    finally:
        schedule_torch.minplus_chain = chain
        del os.environ["REPRO_BURST_LANES"]
    snap8 = schedule_torch.monotone_counters_snapshot()
    _tiled_line("10x instance, tiled route (bursts, 8 lanes a launch)",
                wall, res, snap8, counts8, dp_decisions)
    _check_tiled("10x tiled route at 8 lanes", res, snap8, counts8,
                 dp_decisions, len(live))
    lanes = [sh[0] for sh in shapes]
    print(f"8-lane chain launches: {len(shapes)} for {sum(lanes)} lane "
          f"tiles, {sum(lanes) / max(len(shapes), 1)!r} lanes a launch, "
          "lanes histogram "
          f"{dict(sorted(collections.Counter(lanes).items()))}")
    for name, other in (("one job at a time", seq_res), ("8 lanes", res)):
        same = (other.completion == one_lane.completion
                and other.total_utility == one_lane.total_utility)
        print(f"10x tiled route, {name}: completions and utility "
              f"{other.total_utility!r} equal to the 1-lane burst run's: "
              f"{same}")
        if not same:
            raise AssertionError(f"10x tiled route, {name}: the trajectory "
                                 "differs from the one-lane burst run's")
    if len(shapes) != counts8[0] or max(lanes) < 2:
        raise AssertionError(f"{len(shapes)} chain launches recorded for "
                             f"{counts8[0]}, at most {max(lanes)} lanes")
    return counts8[0], shapes


def tile_mix_phase(shapes, label="tiled route's own 10x mix"):
    """The chain tile on a tiled run's own 10x mix: every distinct launch
    shape the route made (lanes, live slots, band, columns, dtype) timed
    once (device time per launch, from DP columns) against the plain tile,
    each weighted by its launches; the bound is each launch's: its lanes'
    slots' operation bounds summed, and its rows, carries and columns
    moved once.  Returns (ms, plain ms, bound ms, ops ms, bytes ms),
    launch-weighted means."""
    mix = collections.Counter(shapes)
    carries = {}
    total = [0.0] * 5
    for (B, n, dc1, d1, dtype), count in mix.items():
        if (dc1, d1, dtype) not in carries:
            carries[(dc1, d1, dtype)] = minplus_sweep_ref(
                _rows(3, dc1, d1, dtype) + 1.0, d1 - 1)[0][-1].contiguous()
        carry = carries[(dc1, d1, dtype)].expand(B, d1).contiguous()
        rows = _rows(B * n, dc1, d1, dtype).view(B, n, dc1)
        out = torch.empty((B, n, d1), dtype=dtype, device="cuda")
        k_ms = _device_ms(lambda: minplus_kernel.minplus_sweep_cuda(
            rows, d1 - 1, prev=carry, out=out), 10)
        p_ms = _time_ms(lambda: minplus_tile(rows.transpose(0, 1), carry),
                        reps=1)
        op_ms, byte_ms = _tile_bounds(rows.reshape(B * n, dc1), d1, dtype)
        byte_ms += (B - 1) * d1 * dtype.itemsize / PEAK_BYTES * 1e3
        for i, x in enumerate((k_ms, p_ms, max(op_ms, byte_ms), op_ms,
                               byte_ms)):
            total[i] += count * x
    mean = [x / len(shapes) for x in total]
    slots = sum(b * n for b, n, *_ in shapes) / len(shapes)
    lanes = sum(b for b, *_ in shapes) / len(shapes)
    print(f"tile over the {label} ({len(shapes)} chain launches, "
          f"{len(mix)} distinct shapes, {lanes!r} lanes and {slots!r} live "
          f"lane slots a launch, m_pad {sorted({k[2] for k in mix})}): "
          f"launch-weighted kernel_device_ms={mean[0]!r} "
          f"per_lane_slot_ms={mean[0] / slots!r} plain_ms={mean[1]!r} "
          f"bound_ms={mean[2]!r}")
    return mean


def plateau_mix_phase(tiles):
    """The plateau tile on the tiled route's own 10x mix: each plateau
    tile the route launched, on its own rows and carry, held bitwise to
    the plain tile and the chain, then timed (device time per launch)
    against, on the same inputs: the chain kernel (the same function:
    the yardstick), one launch of the plateau kernel per slot (the old
    route's pattern), and the plain tile; the bound is each tile's
    (:func:`_plateau_tile_bounds`).  Returns (ms, plain ms, bound ms, ops
    ms, bytes ms), means over the tiles, each tile one launch."""
    total = [0.0] * 7
    slots = 0
    for rows, prev, r_max in tiles:
        n, dc1 = rows.shape
        d1 = prev.numel()
        out = torch.empty((n, d1), dtype=rows.dtype, device="cuda")
        minplus_kernel.minplus_plateau_cuda(rows, prev, r_max=r_max, out=out)
        t0 = time.perf_counter()
        want = _plain_plateau_tile(rows, prev)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        chain, _ = minplus_kernel.minplus_sweep_cuda(rows, d1 - 1, prev=prev)
        if not (_same_bits(out, want) and _same_bits(out, chain)):
            raise AssertionError(f"a plateau tile of the 10x route ({n} "
                                 f"slots, m_pad={dc1}, d1={d1}): kernel "
                                 "differs from the plain tile or the chain")
        k_ms = _device_ms(lambda: minplus_kernel.minplus_plateau_cuda(
            rows, prev, r_max=r_max, out=out), 10)
        c_ms = _device_ms(lambda: minplus_kernel.minplus_sweep_cuda(
            rows, d1 - 1, prev=prev, out=out), 10)

        def per_slot():
            col = prev
            for i in range(n):
                minplus_kernel.minplus_plateau_cuda(
                    rows[i:i + 1], col, r_max=r_max, out=out[i:i + 1])
                col = out[i]
        # few repeats: the host's n wrapper calls a repeat must stay inside
        # _device_ms's head start, or the host's rate is timed
        s_ms = _device_ms(per_slot, 2)
        op_ms, byte_ms = _plateau_tile_bounds(rows, d1, rows.dtype)
        for i, x in enumerate((k_ms, p_ms, max(op_ms, byte_ms), op_ms,
                               byte_ms, c_ms, s_ms)):
            total[i] += x
        slots += n
    mean = [x / len(tiles) for x in total]
    per = slots / len(tiles)
    shapes = sorted({(r.shape[1], p.numel(), str(r.dtype).split(".")[-1])
                     for r, p, _ in tiles})
    print(f"plateau tile over the tiled route's own 10x mix ({len(tiles)} "
          f"plateau tiles, {per!r} live slots a tile, shapes {shapes}; "
          f"each bitwise the plain tile and the chain): "
          f"kernel_device_ms={mean[0]!r} per_slot_ms={mean[0] / per!r} "
          f"chain_kernel_ms={mean[5]!r} chain_per_slot_ms={mean[5] / per!r} "
          f"one_launch_per_slot_ms={mean[6]!r} plain_ms={mean[1]!r} "
          f"bound_ms={mean[2]!r} (ops {mean[3]!r}, bytes {mean[4]!r})")
    return mean[:5]


def wide_phase():
    """Unquantized full-size jobs (d1 up to 20480, m_pad up to 2688)
    through both routes on the card, feasibility checked, each held to the
    port on the CPU: the tiled route run on the CPU here, completions
    equal and utility within rel 1e-9; the whole route against its CPU
    result pinned in :data:`WIDE_WHOLE_CPU` (tools/whole_route_cpu.py),
    the same completions and utility within rel 1e-9.  The whole route's
    backtrack takes the exact first-index split, as the reference's does,
    so its completions hold only because the card decides on the CPU's
    prices (priced on the host) and sums left to right as the CPU does."""
    cluster = make_cluster(T=100, H=20, K=20)
    jobs = make_jobs(40, T=100, seed=1)
    wide = sum(1 for j in jobs if (_shape_bucket(j) or (0, 0))[1] == 20480)
    for core in ("whole", "tiled"):
        _reset_counts()
        t0 = time.perf_counter()
        res = engine.run(cluster, jobs, core=core, check=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counted()
        snap = schedule_torch.monotone_counters_snapshot()
        sweeps, a_n, b_n = counts
        if core == "whole":
            cpu_completion, cpu_utility = WIDE_WHOLE_CPU
        else:
            cpu = engine.run(cluster, jobs, core=core, device="cpu")
            cpu_completion, cpu_utility = cpu.completion, cpu.total_utility
        rel = abs(res.total_utility - cpu_utility) / abs(cpu_utility)
        moved = {j: (res.completion[j], cpu_completion[j])
                 for j in res.completion
                 if res.completion[j] != cpu_completion.get(j)}
        print(f"wide jobs (T=100, H=K=20, 40 full-size jobs, seed 1, "
              f"quantum=None; {wide} with d1=20480), {core} route: "
              f"wall_s={wall!r} accepted={res.accepted} "
              f"total_utility={res.total_utility!r} cpu={cpu_utility!r} "
              f"rel_diff={rel!r} "
              f"same_accepted={set(res.completion) == set(cpu_completion)} "
              f"finish_slots_moved(gpu, cpu)={moved} "
              f"sweep_kernel_launches={sweeps} plateau_launches={b_n} "
              f"plateau_tiles={snap['plateau']} slot_launches={a_n}")
        if not (set(res.completion) == set(cpu_completion) and rel <= 1e-9
                and res.accepted > 0 and not moved):
            raise AssertionError(f"wide jobs, {core} route: the card's "
                                 "trajectory differs from the CPU's")
        if core == "tiled" and not _tiled_launches_ok(snap, counts):
            raise AssertionError(f"wide jobs, tiled route: launches {counts} "
                                 f"for {snap['chain']} chain and "
                                 f"{snap['plateau']} plateau tiles")


def _held(label, core, res, want):
    """``res`` against its CPU pin ``want``: the whole route exactly
    (accepted, utility, completions, preemptions); the tiled route with
    the same completions and counts and its utility within rel 1e-9."""
    got = _pin(res)
    rel = abs(got[1] - want[1]) / max(abs(want[1]), 1e-300)
    same = got == want if core == "whole" else (
        (got[0],) + got[2:] == (want[0],) + want[2:] and rel <= 1e-9)
    print(f"{label} against the port on the CPU: held={same} "
          f"rel_diff={rel!r} completion_sha256={got[2]}")
    if not same:
        raise AssertionError(f"{label}: {got} on the card, {want} on the "
                             "CPU")


def _run_line(res, wall, counts):
    """The common part of a driver run's line: outcome, time, decision
    latency, the state's upload and window bytes, DP launches."""
    sweeps, a_n, b_n = counts
    ds = np.asarray(res.decision_seconds) * 1e3
    return (f"n_jobs={res.n_jobs} accepted={res.accepted} "
            f"preempted={res.preempted} dropped={res.preempt_dropped} "
            f"total_utility={res.total_utility!r} wall_s={wall!r} "
            f"decisions={len(ds)} decisions_per_s={len(ds) / wall!r} "
            f"decision_p50_ms={float(np.percentile(ds, 50))!r} "
            f"decision_p95_ms={float(np.percentile(ds, 95))!r} "
            f"window_bytes={res.window_bytes} "
            f"device_uploads={res.device_uploads} sweep_launches={sweeps} "
            f"plateau_launches={b_n} slot_launches={a_n} "
            f"dp_launches_per_decision={(sweeps + b_n) / max(len(ds), 1)!r}")


def _timed_run(fn):
    """``fn()`` with the counts set to 0 just before and read just after:
    (result, wall seconds, (sweep, one-slot, plateau) launches, tiled
    counters)."""
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, _counted(), schedule_torch.monotone_counters_snapshot()


def _check_launches(label, core, res, counts, snap, dp_decisions=None):
    """Whole route: one sweep per DP decision (all of them when
    ``dp_decisions`` is given), nothing else; tiled route: one launch per
    chain and per plateau tile (``_check_tiled`` when ``dp_decisions`` is
    given: every job decided once, plus the re-solves)."""
    sweeps, a_n, b_n = counts
    if core == "whole":
        ok = (a_n == b_n == 0 and 0 < sweeps <= len(res.decision_seconds)
              and (dp_decisions is None or sweeps == dp_decisions))
        if not ok:
            raise AssertionError(f"{label}: launches {counts} for "
                                 f"{len(res.decision_seconds)} decisions")
    elif dp_decisions is not None:
        _check_tiled(label, res, snap, counts, dp_decisions, res.n_jobs)
    elif not (_tiled_launches_ok(snap, counts) and sweeps > 0):
        raise AssertionError(f"{label}: launches {counts} for "
                             f"{snap['chain']} chain and {snap['plateau']} "
                             "plateau tiles")


def serving_phase():
    """The serving stream (:data:`SERVING`, the reference's SERVING_DIMS in
    full) through ``engine.run_stream`` on both routes, each with the
    counts set to 0 just before it and read just after: 64-slot window of
    256,000 host bytes, one upload over the whole stream, every DP
    decision through the kernels, no capacity violation (``check=True``),
    and the trajectory held to the port's on the CPU
    (:data:`SERVING_CPU`)."""
    live = [engine._with_quantum(j, 0) for j in stream_jobs(
        rate=SERVING["rate"], seed=SERVING["seed"],
        max_slots=SERVING["slots"])]
    dp_decisions = sum(_shape_bucket(j) is not None for j in live)
    for core in ("whole", "tiled"):
        res, wall, counts, snap = _timed_run(lambda: serving_run(core))
        label = f"serving, {core} route"
        print(f"serving (SERVING_DIMS: H=K={SERVING['H']}, window "
              f"{SERVING['window']}, {SERVING['slots']} slots, rate "
              f"{SERVING['rate']}, seed {SERVING['seed']}, full-size jobs, "
              f"quantum=0, check=True), {core} route: "
              + _run_line(res, wall, counts))
        if core == "tiled":
            _tiled_line("serving, tiled route", wall, res, snap, counts,
                        dp_decisions)
        if (res.n_jobs != len(live) or res.window_bytes != 256000
                or res.device_uploads != 1):
            raise AssertionError(f"{label}: {res.n_jobs} jobs, "
                                 f"{res.window_bytes} window bytes, "
                                 f"{res.device_uploads} uploads")
        _check_launches(label, core, res, counts, snap, dp_decisions)
        _held(label, core, res, SERVING_CPU[core])


def churn_phase():
    """The churn instance (:data:`CHURN`, the reference's CHURN_DIMS)
    churn-free and at each level on both routes, ``check=True``, each run
    with the counts set to 0 just before it and read just after, held to
    the port on the CPU (:data:`CHURN_CPU`); retention is the churned
    run's utility over the churn-free run's."""
    for core in ("whole", "tiled"):
        for frac in (0.0,) + CHURN["levels"]:
            res, wall, counts, snap = _timed_run(
                lambda: churn_run(core, frac))
            if frac == 0.0:
                base = res.total_utility
            label = f"churn frac={frac}, {core} route"
            print(f"churn (CHURN_DIMS: T={CHURN['T']}, H=K={CHURN['H']}, "
                  f"{CHURN['n']} full-size jobs, seed {CHURN['seed']}, "
                  f"churn_trace(frac={frac}, seed={CHURN['seed'] + 1}), "
                  f"quantum=0, check=True), {core} route: "
                  f"retention={res.total_utility / base!r} "
                  f"live_frac={res.live_frac!r} "
                  + _run_line(res, wall, counts))
            _check_launches(label, core, res, counts, snap)
            _held(label, core, res, CHURN_CPU[(core, frac)])


def stream_churn_phase():
    """The serving cluster's first 2000 slots under churn
    (:data:`STREAM_CHURN`) on the whole route: down servers re-blocked
    after every window slide on the card; held to the CPU
    (:data:`STREAM_CHURN_CPU`)."""
    sc = STREAM_CHURN
    res, wall, counts, snap = _timed_run(lambda: serving_run(
        "whole", slots=sc["slots"], frac=sc["frac"]))
    label = "streamed churn, whole route"
    print(f"streamed churn (the serving cluster, its first {sc['slots']} "
          f"slots, churn_trace(frac={sc['frac']}, seed={sc['seed']}, "
          f"T={sc['slots']}), check=True), whole route: "
          f"live_frac={res.live_frac!r} " + _run_line(res, wall, counts))
    if res.window_bytes != 256000 or res.device_uploads != 1 \
            or res.preempted == 0:
        raise AssertionError(f"{label}: {res.window_bytes} window bytes, "
                             f"{res.device_uploads} uploads, "
                             f"{res.preempted} preemptions")
    _check_launches(label, "whole", res, counts, snap)
    _held(label, "whole", res, STREAM_CHURN_CPU)


def _dp_decisions(jobs, cluster, quantum):
    """The DP decisions of an episodic OASiS run of ``jobs``: arrivals
    before T whose DP has a shape bucket."""
    return sum(_shape_bucket(engine._with_quantum(j, quantum)) is not None
               for j in jobs if j.arrival < cluster.T)


# the learned scheduler's runs (tools/learned_cpu.py writes their CPU
# pins): rl.policy.default_policy(cluster, seed=0) on the 10x instance
# (SCALE_DIMS, engine.run) and on the serving stream (SERVING_DIMS in full,
# engine.run_stream), check=True
LEARNED_CPU = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tools", "learned_cpu.json")


class _Recorded:
    """A decider that records its answers, (job, counts or None) each."""

    def __init__(self, decider):
        self.decider = decider
        self.answers = []

    def __call__(self, dp):
        a = self.decider(dp)
        self.answers.append((int(dp.job.jid),
                             None if a is None else [int(x) for x in a]))
        return a


def learned_run(which, device=None, track_margins=False):
    """(result, recorded decider) of the learned scheduler with
    ``default_policy(cluster, seed=0)`` on ``which``: ``"scale"`` (the 10x
    instance) or ``"serving"`` (the serving stream)."""
    if which == "scale":
        cluster = make_cluster(T=SCALE["T"], H=SCALE["H"], K=SCALE["K"])
        jobs = make_jobs(SCALE["n"], T=SCALE["T"], seed=0)
    else:
        cluster = make_cluster(T=SERVING["window"], H=SERVING["H"],
                               K=SERVING["K"])
        jobs = stream_jobs(rate=SERVING["rate"], seed=SERVING["seed"],
                           max_slots=SERVING["slots"])
    dec = _Recorded(rl_policy.default_policy(cluster, seed=0, device=device,
                                             track_margins=track_margins))
    if which == "scale":
        res = engine.run(cluster, jobs, scheduler="learned", policy=dec,
                         check=True, device=device)
    else:
        res = engine.run_stream(cluster, jobs, scheduler="learned",
                                window=SERVING["window"], check=True,
                                policy=dec, device=device)
    return res, dec


def learned_pin(res, dec):
    """A learned run's pin: counts, utility, and the sha256 of its
    completions and of every answer of its policy."""
    import hashlib
    return {"accepted": res.accepted, "completed": res.completed,
            "total_utility": res.total_utility,
            "completion_sha256": _completion_digest(res.completion),
            "decisions": len(dec.answers),
            "answers_sha256": hashlib.sha256(json.dumps(
                dec.answers).encode()).hexdigest()}


def _grads_on(params, pcfg, cfg, batch, device):
    """(loss, gradient leaves) of the REINFORCE loss on ``device``."""
    p = rl_train._trainable(rl_policy.params_to(params, torch.device(device)))
    loss, _, _ = rl_train.reinforce_loss(
        p, pcfg, cfg, *rl_train._batch(torch.device(device), *batch),
        cfg.entropy_coef)
    loss.backward()
    return float(loss.detach()), [x.grad.cpu().numpy()
                                  for x in rl_train._leaves(p)]


def learned_phase(paper):
    """The learned-scheduler slice on the card, each run with the counts
    set to 0 just before it and read just after:

    1. OASiS replayed through ``engine.decisions`` (the rl env and
       ``ReplayPolicy``) at paper scale, seed 0, both routes, held to the
       card's runs of the paper phase (``paper``): the same completions
       and accepted jobs, utility within rel 1e-9; every DP decision
       through the kernels;
    2. the learned scheduler, ``default_policy(cluster, seed=0)``, on the
       10x instance (2000 decisions) and the serving stream (4,457), each
       held exactly to its CPU pin (:data:`LEARNED_CPU`: counts, utility,
       completions, every answer);
    3. training at ``TrainConfig``'s defaults (T 100, H = K = 50, 200
       full-size jobs, batch 8, d_model 64): the behaviour-cloning warm
       start (8 episodes, 30 steps), then 2 REINFORCE iterations with
       ``val_every=0``; losses finite; one update's loss and gradients on
       a fixed batch on the card within rel 1e-4 of the CPU's (a
       gradient leaf relative to its largest magnitude); a checkpoint
       round trip evaluating identically.

    Returns each replay's (sweep, one-slot, plateau) launches by route."""
    t_phase = time.perf_counter()
    cluster = make_cluster(T=100, H=50, K=50)
    jobs = make_jobs(200, T=100, seed=0, small=True)
    launches = {}
    for core in ("whole", "tiled"):
        want = paper[core]
        env = rl_env.ClusterSchedulingEnv(
            instance_fn=lambda s: (cluster, jobs), scheduler="oasis",
            check=True, quantum=0, core=core)
        res, wall, counts, snap = _timed_run(
            lambda: rl_env.run_episode(env, rl_env.ReplayPolicy()))
        label = f"learned phase: OASiS replayed through decisions, {core}"
        rel = abs(res.total_utility - want.total_utility) / max(
            abs(want.total_utility), 1e-300)
        print(f"{label}: accepted={res.accepted} utility="
              f"{res.total_utility!r} rel_diff_run={rel!r} wall_s={wall!r} "
              f"decisions={len(res.decision_seconds)} sweeps={counts[0]} "
              f"chain_tiles={snap['chain']} plateau_tiles={snap['plateau']}"
              f" plateau_launches={counts[2]}", flush=True)
        if not (res.accepted == want.accepted and res.completion
                == want.completion and rel <= 1e-9):
            raise AssertionError(f"{label}: differs from the card's run")
        if core == "whole":
            _check_launches(label, core, res, counts, snap)
        elif not (_tiled_launches_ok(snap, counts) and sum(counts) > 0):
            # paper scale's tiles are all plateau tiles on this route
            raise AssertionError(f"{label}: launches {counts} for "
                                 f"{snap['chain']} chain and "
                                 f"{snap['plateau']} plateau tiles")
        launches[core] = counts
    with open(LEARNED_CPU) as f:
        pins = json.load(f)
    for which in ("scale", "serving"):
        (res, dec), wall, counts, _ = _timed_run(lambda: learned_run(which))
        got = learned_pin(res, dec)
        ds = np.asarray(res.decision_seconds) * 1e3
        print(f"learned scheduler, default_policy seed 0, {which}: "
              f"total_utility={res.total_utility!r} accepted={res.accepted} "
              f"completed={res.completed} decisions={len(ds)} "
              f"policy_p50_ms={float(np.percentile(ds, 50))!r} "
              f"policy_p95_ms={float(np.percentile(ds, 95))!r} "
              f"wall_s={wall!r} decisions_per_s={len(ds) / wall!r} "
              f"minplus_launches={sum(counts)} cpu_min_top2_margin="
              f"{pins[which]['min_margin']!r} held={got == pins[which]['pin']}",
              flush=True)
        if got != pins[which]["pin"] or sum(counts):
            raise AssertionError(f"learned {which}: {got} on the card, "
                                 f"{pins[which]['pin']} on the CPU")
    cfg = rl_train.TrainConfig(iterations=2, val_every=0)
    pcfg = rl_policy.PolicyConfig()
    dev = torch.device("cuda")
    init = rl_policy.params_to(rl_policy.policy_init(
        torch.Generator().manual_seed(cfg.seed), pcfg), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bc = rl_train.behavior_clone(init, pcfg, cfg, log=None, device=dev)
    torch.cuda.synchronize()
    print(f"training: behaviour cloning ({cfg.bc_episodes} episodes, "
          f"{cfg.bc_steps} steps) wall_s={time.perf_counter() - t0!r}",
          flush=True)
    params, history = rl_train.train(cfg, pcfg, params=bc, log=None,
                                     device=dev)
    for row in history:
        print(f"training: iteration {row['iteration']} (batch {cfg.batch}, "
              f"T {cfg.T}, H = K = {cfg.H}, {cfg.n_jobs} jobs) wall_s="
              f"{row['iteration_seconds']!r} rollout_decisions="
              f"{row['decisions']} rollout_decisions_per_s="
              f"{row['decisions'] / row['rollout_seconds']!r} "
              f"loss={row['loss']!r} mean_utility={row['mean_utility']!r}",
              flush=True)
    if len(history) != 2 or not all(np.isfinite(r["loss"])
                                    for r in history):
        raise AssertionError(f"training: {history}")
    host = rl_policy.params_to(params, torch.device("cpu"))
    envs = [rl_train._make_env(cfg, "cpu") for _ in range(cfg.batch)]
    obs, act, credit, mask, expert, _ = rl_train.rollout_batch(
        host, pcfg, cfg, envs, [cfg.train_seeds[0]] * cfg.batch,
        torch.Generator().manual_seed(1),
        rl_train.explore_sampler(pcfg, cfg.explore_eps), "cpu")
    batch = (obs, act, rl_train._advantages(credit, mask, cfg.rtg_window),
             mask, expert)
    (l_gpu, g_gpu), (l_cpu, g_cpu) = (_grads_on(host, pcfg, cfg, batch, d)
                                      for d in (dev, "cpu"))
    worst = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                for a, b in zip(g_gpu, g_cpu))
    rel_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    print(f"training: one update on a fixed batch ({int(mask.sum())} "
          f"decisions), card against CPU: loss {l_gpu!r} / {l_cpu!r} "
          f"rel_diff={rel_loss!r}, gradients max abs diff over the leaf's "
          f"largest magnitude={worst!r}", flush=True)
    if not (rel_loss <= 1e-4 and worst <= 1e-4):
        raise AssertionError("training: the card's update differs from the "
                             "CPU's")
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        rl_policy.save_policy(d, params, pcfg, step=len(history))
        re_params, re_cfg, _ = rl_policy.load_policy(d, device=dev)
        a = rl_train.evaluate(params, pcfg, (5,), cfg=cfg,
                              schedulers=("learned",), device=dev)
        b = rl_train.evaluate(re_params, re_cfg, (5,), cfg=cfg,
                              schedulers=("learned",), device=dev)
    print(f"training: checkpoint round trip, greedy evaluation on seed 5 "
          f"{a['learned']['per_seed']} / {b['learned']['per_seed']} "
          f"identical={a == b and re_cfg == pcfg}", flush=True)
    if a != b or re_cfg != pcfg:
        raise AssertionError("training: the checkpoint round trip changed "
                             "the evaluation")
    print(f"learned phase ok: wall_s={time.perf_counter() - t_phase!r}",
          flush=True)
    return launches


def scenario_phase():
    """The scenario library (:data:`SCENARIO_PLAN`) at the reference's full
    sizes: every OASiS run through each route with the counts set to 0
    just before it and read just after (``engine.run`` and
    ``engine.run_stream`` wrapped for the phase), every DP decision
    through the kernels; every reactive run on the host with no kernel
    launched.  Each row is held to the port on the CPU
    (:data:`SCENARIOS_CPU`): reactive and whole-route rows exactly,
    tiled-route rows with the same accepted and completed jobs and
    completions and the utility within rel 1e-9.  Returns the phase's
    (sweep, one-slot, plateau) launches per route."""
    with open(SCENARIOS_CPU) as f:
        pins = json.load(f)
    runs = []
    run, run_stream = engine.run, engine.run_stream

    def counted(fn):
        def wrapped(cluster, jobs, **kw):
            res, wall, counts, snap = _timed_run(
                lambda: fn(cluster, jobs, **kw))
            dp = None
            if kw.get("scheduler", "oasis") == "oasis" and fn is run:
                dp = _dp_decisions(jobs, cluster, kw.get("quantum"))
            runs.append((res, wall, counts, snap, dp))
            return res
        return wrapped

    launches = {"whole": [0, 0, 0], "tiled": [0, 0, 0]}
    keys = set()
    t_phase = time.perf_counter()
    engine.run, engine.run_stream = counted(run), counted(run_stream)
    try:
        for core in ("whole", "tiled"):
            for name, kw in scenario_plan(core):
                runs.clear()
                t0 = time.perf_counter()
                rows = scenarios.run_scenario(name, core=core, **kw)
                wall_s = time.perf_counter() - t0
                if len(rows) != len(runs):
                    raise AssertionError(f"{name}: {len(rows)} rows for "
                                         f"{len(runs)} engine runs")
                for row, (res, wall, counts, snap, dp) in zip(rows, runs):
                    key = _scenario_key(row, core)
                    label = f"scenario {key}"
                    oasis = row.scheduler == "oasis"
                    if oasis:
                        _check_launches(label, core, res, counts, snap, dp)
                        launches[core] = [a + b for a, b in
                                          zip(launches[core], counts)]
                    elif counts != (0, 0, 0):
                        raise AssertionError(f"{label}: a reactive run "
                                             f"launched {counts}")
                    got, want = _scenario_pin(row), pins[key]
                    rel = abs(got[3] - want[3]) / max(abs(want[3]), 1e-300)
                    same = got == want if not (oasis and core == "tiled") \
                        else got[:3] == want[:3] and rel <= 1e-9
                    ds = np.asarray(res.decision_seconds) * 1e3
                    what = "decision" if oasis else "repack"
                    pct = (f"{what}_p50_ms={float(np.percentile(ds, 50))!r} "
                           f"{what}_p95_ms={float(np.percentile(ds, 95))!r}"
                           if ds.size else f"{what}s=0")
                    print(f"{label}: wall_s={wall!r} accepted={got[0]} "
                          f"completed={got[1]} utility={got[3]!r} "
                          f"utilization={got[4]!r} retention={got[5]!r} "
                          f"preempted={got[6]!r} {what}s={ds.size} {pct} "
                          f"sweep_launches={counts[0]} "
                          f"plateau_launches={counts[2]} "
                          f"slot_launches={counts[1]} held={same} "
                          f"rel_diff={rel!r}")
                    if not same:
                        raise AssertionError(f"{label}: {got} on the card, "
                                             f"{want} on the CPU")
                    keys.add(key)
                print(f"scenario {name} ({core} route): rows={len(rows)} "
                      f"wall_s={wall_s!r}", flush=True)
    finally:
        engine.run, engine.run_stream = run, run_stream
    print(f"scenario phase: {len(keys)} distinct rows held of {len(pins)} "
          f"pins, wall_s={time.perf_counter() - t_phase!r}, DP launches "
          f"(sweep, one-slot, plateau) whole={launches['whole']} "
          f"tiled={launches['tiled']}")
    if keys != set(pins):
        raise AssertionError(f"rows {sorted(keys ^ set(pins))} not both run "
                             "and pinned")
    return launches


# the flight recorder's pins: the deterministic readings (counters, span
# and histogram counts) of the paper-scale runs on both routes and the
# quick churn CLI's rows, from the port on the CPU (tools/obs_cpu.py)
OBS_CPU = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "tools", "obs_cpu.json")
OBS_CLI = ("--scenario", "churn", "--quick")


def obs_paper_run(core, device=None):
    """(result, recorder) of paper_phase's instance (T=100, H = K = 50,
    200 small jobs of seed 0, quantum 0) through ``core`` with a flight
    recorder."""
    ob = obslib.Obs()
    res = engine.run(make_cluster(T=100, H=50, K=50),
                     make_jobs(200, T=100, seed=0, small=True), quantum=0,
                     core=core, device=device, obs=ob)
    return res, ob


def obs_pin(res, ob):
    """A recorded run's deterministic readings: utility, accepted jobs,
    completions' digest, every counter, the spans per name and the
    observations per histogram."""
    snap = ob.metrics.snapshot()
    spans = collections.Counter(e["name"] for e in ob.tracer.events())
    return {"total_utility": res.total_utility, "accepted": res.accepted,
            "completion_sha256": _completion_digest(res.completion),
            "counters": dict(sorted(snap["counters"].items())),
            "spans": dict(sorted(spans.items())),
            "histogram_counts": {k: h["count"] for k, h in
                                 sorted(snap["histograms"].items())}}


def cli_rows(text):
    """The scenario rows a ``cluster_sim`` run printed: each row up to its
    utilization (scheduler, variant, utility to one decimal, accepted and
    completed jobs), its wall time left out."""
    return [" ".join(ln[:ln.index(" util=") + 11].split())
            for ln in text.splitlines() if " util=" in ln]


def _span_ms(ob):
    """Host milliseconds per span name over a recording (nested spans
    count in their parents too)."""
    tot = collections.defaultdict(float)
    for e in ob.tracer.events():
        if e["dur_us"] is not None:
            tot[e["name"]] += e["dur_us"] / 1e3
    return dict(sorted(tot.items(), key=lambda kv: -kv[1]))


def obs_phase(paper, one_lane, tile_launches):
    """The flight recorder (``repro_torch.obs``) on the card:

    1. paper scale, both routes, recorded (``engine.run(..., obs=)``):
       the same completions and utility as the paper phase's unrecorded
       card runs (``paper``), and every counter, span count and histogram
       count equal to the port's CPU run (:data:`OBS_CPU`), one upload;
    2. the 10x instance, tiled route, recorded: the same completions,
       utility and kernel launches as the unrecorded run (``one_lane``,
       ``tile_launches``: its sweep-kernel and plateau launches);
       ``decide.launches`` equal to the core's own count; the derived
       figures (row-cache hit rate, early-exit tile fraction, device
       uploads) and the host ms per span name;
    3. the decision-stage profile (``REPRO_DECIDE_PROFILE=1``) over the
       10x trace's first 200 arrivals, tiled route: the decisions equal an unprofiled run's, every stage's
       time positive;
    4. the CLI, ``python -m repro_torch.launch.cluster_sim --scenario
       churn --quick --trace`` on the card: the trace parses, its
       decisions, arrivals and preemptions are positive, and its rows
       equal the CPU's (:data:`OBS_CPU`).

    Prints its wall."""
    t_phase = time.perf_counter()
    with open(OBS_CPU) as f:
        pins = json.load(f)
    for core in ("whole", "tiled"):
        res, ob = obs_paper_run(core)
        got, want = obs_pin(res, ob), pins["paper"][core]
        same_run = (res.completion == paper[core].completion
                    and res.total_utility == paper[core].total_utility)
        print(f"obs paper scale, {core} route: same run as unrecorded "
              f"{same_run} same readings as the CPU {got == want} "
              f"counters={got['counters']} spans={got['spans']}",
              flush=True)
        if not same_run or got != want:
            raise AssertionError(f"obs paper {core}: {got} on the card, "
                                 f"{want} on the CPU, or the recorded run "
                                 "differs from the unrecorded one")
        if got["counters"]["price.device_uploads"] != 1:
            raise AssertionError(f"obs paper {core}: device uploads")
    cluster = make_cluster(T=SCALE["T"], H=SCALE["H"], K=SCALE["K"])
    jobs = make_jobs(SCALE["n"], T=SCALE["T"], seed=0)
    ob = obslib.Obs()
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.run(cluster, jobs, quantum=0, core="tiled", check=True,
                     obs=ob)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counted()
    snap = schedule_torch.monotone_counters_snapshot()
    c = ob.metrics.snapshot()["counters"]
    hit = c.get("decide.cache_tiles_valid", 0) / max(
        c.get("decide.cache_tiles_total", 0), 1)
    frac = c["decide.tiles_visited"] / max(c["decide.tiles_horizon"], 1)
    same = (res.completion == one_lane.completion
            and res.total_utility == one_lane.total_utility
            and (counts[0], counts[2]) == tile_launches)
    print(f"obs 10x tiled route: wall_s={wall!r} row_cache_hit_rate={hit!r}"
          f" early_exit_frac={frac!r} device_uploads="
          f"{c['price.device_uploads']} launches={c['decide.launches']} "
          f"core_launches={snap['launches']} spans={len(ob.tracer)} "
          f"dropped={ob.tracer.dropped} same_run_and_kernel_launches_as_"
          f"unrecorded={same} counters={dict(sorted(c.items()))}")
    print("obs 10x tiled route, host ms per span: " + " ".join(
        f"{k}={v!r}" for k, v in _span_ms(ob).items()), flush=True)
    if not (same and c["decide.launches"] == snap["launches"]
            and c["price.device_uploads"] == 1 and ob.tracer.dropped == 0):
        raise AssertionError("obs 10x tiled route: the recorded run differs "
                             "from the unrecorded one, or its counts are "
                             "off")
    params = price_params_from_jobs(jobs, cluster)
    first = jobs[:200]
    ob = obslib.Obs()
    base = engine.run(cluster, first, params=params, quantum=0,
                      core="tiled", obs=ob)
    schedule_torch.decide_profile_reset()
    os.environ["REPRO_DECIDE_PROFILE"] = "1"
    try:
        prof = engine.run(cluster, first, params=params, quantum=0,
                          core="tiled")
    finally:
        del os.environ["REPRO_DECIDE_PROFILE"]
    stages = schedule_torch.decide_profile_snapshot()
    n = max(stages["decisions"], 1.0)
    print("obs stage profile (REPRO_DECIDE_PROFILE, tiled route, 10x trace, "
          "first 200 jobs): " + " ".join(
              f"{k}_ms={v * 1e3!r} {k}_ms_per_decision={v * 1e3 / n!r}"
              for k, v in stages.items() if k != "decisions")
          + f" decisions={stages['decisions']!r}; unprofiled, host ms per "
          "span: " + " ".join(f"{k}={v!r}" for k, v in _span_ms(ob).items()),
          flush=True)
    if not (prof.completion == base.completion
            and prof.total_utility == base.total_utility
            and min(stages.values()) > 0):
        raise AssertionError(f"stage profile: {stages}, or the profiled "
                             "run's decisions differ")
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "churn.json")
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.cluster_sim",
             *OBS_CLI, "--trace", trace], cwd=root, env=env,
            capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"cluster_sim: {out.stderr[-2000:]}")
        with open(trace) as f:
            doc = json.load(f)
    c = doc["metrics"]["counters"]
    rows = cli_rows(out.stdout)
    print(f"obs CLI (cluster_sim {' '.join(OBS_CLI)} --trace, on the card):"
          f" wall_s={cli_s!r} events={len(doc['traceEvents'])} "
          f"rows_equal_cpu={rows == pins['cli_rows']} counters={c}")
    if not (rows == pins["cli_rows"] and all(
            c.get(k, 0) > 0 for k in ("decide.decisions", "engine.arrivals",
                                      "engine.preemptions"))):
        raise AssertionError(f"cluster_sim rows {rows} against the CPU's "
                             f"{pins['cli_rows']}, or counters {c}")
    print(f"obs phase: wall_s={time.perf_counter() - t_phase!r}")


def profile_phase(core, n_jobs=100, lanes=1, sequential=False):
    """Where the time goes: a traced run of the 10x trace's first
    ``n_jobs`` arrivals through ``core`` (same price parameters as the
    full run, so these are the main run's first decisions); on the tiled
    route through the engine's bursts at ``lanes`` lanes a launch, or
    with ``sequential`` one job at a time (no burst, no row cache).
    Device busy = the sum of device self time over the traced kernels and
    device copies, each counted once (``_device_table``; one stream, so
    they do not overlap).  Returns {kernel: (device ms, launches)}."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.oasis import OASiS
    cluster = make_cluster(T=SCALE["T"], H=SCALE["H"], K=SCALE["K"])
    jobs = make_jobs(SCALE["n"], T=SCALE["T"], seed=0)
    params = price_params_from_jobs(jobs, cluster)
    route = core + (" one job at a time" if sequential else
                    f" bursts at {lanes} lanes" if core == "tiled" else "")
    os.environ["REPRO_BURST_LANES"] = str(lanes)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if sequential:
                res = OASiS(cluster, params, core=core)
                for job in sorted(jobs[:n_jobs], key=lambda j: j.arrival):
                    res.on_arrival(engine._with_quantum(job, 0))
            else:
                res = engine.run(cluster, jobs[:n_jobs], params=params,
                                 quantum=0, core=core)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del os.environ["REPRO_BURST_LANES"]
    dev = _device_table(prof)
    busy = sum(ms for ms, _ in dev.values())
    kernels = {}
    # the tiled route's chain tiles run the sweep kernel from a carry-in
    sweep = "minplus_tile" if core == "tiled" else "minplus_sweep"
    for label, name in ((sweep, "minplus_sweep_kernel"),
                        ("minplus_slot", "minplus_slot_kernel"),
                        ("minplus_plateau", "minplus_plateau_kernel")):
        keys = [k for k in dev if name in k]
        if keys:
            kernels[label] = (sum(dev[k][0] for k in keys),
                              sum(dev[k][1] for k in keys))
    top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"profile ({route} route, 10x trace, first {n_jobs} jobs, "
          f"traced): "
          f"decisions={len(res.decision_seconds)} wall_ms={wall_ms!r} "
          f"device_busy_ms={busy!r} device_idle_share="
          f"{1.0 - busy / wall_ms!r} " + " ".join(
              f"{k}_ms={v[0]!r} {k}_launches={v[1]} "
              f"{k}_ms_per_launch={v[0] / max(v[1], 1)!r}"
              for k, v in kernels.items()))
    for k, (ms, n) in top:
        print(f"  device {ms!r} ms ({n} launches): {k[:90]}")
    # where the host's time goes: device launches per decision, and the
    # host-side entries with the most self time (CUDA runtime calls, such
    # as launches and the syncs that wait for the device, and aten ops)
    launches = sum(n for _, n in dev.values())
    dp = sum(n for _, n in kernels.values())
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)
    n_dec = max(len(res.decision_seconds), 1)
    print(f"  device launches={launches} per_decision="
          f"{launches / n_dec!r} dp_kernel_launches_per_decision="
          f"{dp / n_dec!r} other_launches_per_decision (row build, "
          f"payoff reads, copies)={(launches - dp) / n_dec!r} "
          f"host_ops_self_ms={sum(h[0] for h in host)!r} (the rest of the "
          "wall is Python outside any traced op)")
    for ms, n, k in host[:6]:
        print(f"  host self {ms!r} ms ({n} calls): {k[:90]}")
    return kernels


# ---------------------------------------------------------------------------
# The model stack: Mamba2 SSD scan and flash attention, Zamba2-7B serving
# ---------------------------------------------------------------------------

# (b, L, H, P, G, N, chunk): tests/test_kernels.py's SSD shapes, Zamba2's
# per-head shape at a short ragged L and at one ragged chunk, and
# Zamba2-7B's prefill shape (batch 4, prompt 2048: 448 rows of L 2048,
# P = N = 64, Q 128); the plans take clusters of 1, 2, 4 and 8 blocks
SSD_TEST_SHAPES = [(1, 32, 2, 16, 1, 16, 16), (2, 64, 4, 32, 2, 32, 32),
                   (1, 100, 4, 64, 1, 64, 64), (2, 256, 8, 64, 4, 128, 128),
                   (1, 300, 4, 64, 1, 64, 128), (2, 40, 4, 64, 2, 64, 128)]
SSD_ZAMBA = (4, 2048, 112, 64, 1, 64, 128)
# a row of more chunks than one cluster holds (65 kernel chunks of 64:
# nine segments of 8), G > 1, run from an initial state
SSD_SEGMENTED = (2, 4133, 8, 64, 2, 64, 128)
# (B, Sq, Sk, H, KV, D): tests/test_kernels.py's sweep plus D = 112, then
# Zamba2-7B's shared attention at the prefill (causal; bf16 as served, and
# float32, where 2e-5 holds every key block of the 32 query blocks)
FLASH_TEST_SHAPES = [(1, 64, 64, 2, 2, 64), (2, 128, 128, 4, 2, 64),
                     (1, 130, 130, 4, 1, 128), (2, 96, 96, 8, 4, 256),
                     (2, 200, 200, 4, 2, 112)]
FLASH_MASKS = [(True, 0, 0.0), (True, 32, 0.0), (True, 0, 50.0),
               (False, 0, 0.0)]
# float32 only, every mask: the smoke configs' D = 16 on a small grid
# (one row tile a warp, as the test shapes above and the consistency
# prefill), then grids of 1.5x an H100's 132 SMs or more of 256-row
# blocks, where the plan takes two, at every D up to 128
FLASH_F32_SHAPES = [(2, 100, 100, 4, 2, 16), (2, 300, 300, 64, 16, 16),
                    (2, 530, 530, 40, 8, 64), (1, 700, 700, 80, 16, 112),
                    (3, 260, 260, 40, 40, 128)]
FLASH_ZAMBA = (4, 2048, 2048, 32, 32, 112)
# the float32 consistency prefill's attention (one request of
# CONSISTENCY_LEN tokens at Zamba2-7B's width): float32 only, causal
FLASH_CONSISTENCY = (1, 320, 320, 32, 32, 112)
# the tensor-core kernel's ||got - want|| / ||want|| against the float32
# plain version: bf16 output rounding alone gives ~1.6e-3; a key tile
# dropped or read late moves long rows by ~1e-1 of their norm while each
# element may stay under 2e-2 (tests/test_torch_model_cuda.py)
WGMMA_REL_NORM = 5e-3
SERVE = {"batch": 4, "prompt": 2048, "gen": 32}
# Zamba2-7B: 81 Mamba2 layers, 13 calls of the shared attention block
ZAMBA_SSD, ZAMBA_FLASH = 81, 13
CONSISTENCY_LEN = 320          # 320 * 320 > 256 * 256: the chunked branch
# the dense family: Gemma2-9B served at batch 2 of 6144-token prompts (its
# 21 local layers' window of 4096 bites) and StarCoder2-3B at batch 4 of
# 2048, one flash launch per layer; the attention at those prompts:
# Gemma2-9B's local (window 4096) and global layers, both soft-capped at
# 50 (16 heads, 8 KV heads, D 256), StarCoder2-3B's plain causal one (24
# heads, 2 KV heads, D 128)
GEMMA_SERVE = {"batch": 2, "prompt": 6144, "gen": 32}
STARCODER_SERVE = {"batch": 4, "prompt": 2048, "gen": 32}
GEMMA_LAYERS, STARCODER_LAYERS = 42, 30
FLASH_GEMMA = (2, 6144, 6144, 16, 8, 256)
FLASH_GEMMA_MASKS = [(True, 4096, 50.0), (True, 0, 50.0)]
FLASH_STARCODER = (4, 2048, 2048, 24, 2, 128)
# the float32 window consistency: one Gemma2-9B request of 4200 prompt
# tokens (past the 4096 window), 8 teacher-forced decode steps after it
WINDOW_PROMPT, WINDOW_STEPS = 4200, 8
# the dense smoke configs held on the card to the port on the CPU
DENSE_SMOKE = ("granite_34b", "starcoder2_3b", "pixtral_12b", "gemma2_9b",
               "gemma2_27b")
# the MoE family: OLMoE-1B-7B served at full width and depth at batch 4
# of 2048-token prompts (16 layers of qk-norm attention, H = KV = 16, D
# 128: one flash launch a layer; 64 experts top-8 at capacity factor
# 1.25: 1280 slots an expert in prefill, 1 in decode); its float32
# consistency at a capacity that drops nothing; one MLA layer at
# DeepSeek-V3's widths past FLASH_THRESHOLD; DeepSeek-V3 at depth 4
OLMOE_SERVE = {"batch": 4, "prompt": 2048, "gen": 32}
OLMOE_LAYERS = 16
OLMOE_CAPS = {"prefill": 1280, "decode": 1}
FLASH_OLMOE = (4, 2048, 2048, 16, 16, 128)
OLMOE_PROMPT, OLMOE_STEPS = 600, 8
MLA_LEN, MLA_DECODE = 4608, 8
DEEPSEEK_SERVE = {"batch": 1, "prompt": 4608, "gen": 16}
DEEPSEEK_DEPTH = 4
DEEPSEEK_DEPTH4_PARAMS = 15_797_359_616
MOE_SMOKE = ("olmoe_1b_7b", "deepseek_v3_671b")
# the enc-dec family: Whisper-large-v3 served at full width and depth,
# batch 8 clips of 1500 frames, decoder prompt 224, 32 new tokens (max_len
# 256, inside its 448 text positions): a prefill's 32 non-causal encoder
# self-attentions (Sq = Sk = 1500) and 32 cross-attentions (Sq 224, Sk
# 1500) take the flash kernel, its decoder's causal 224 x 224 the naive
# branch; its float32 consistency at one clip and a 64-token prompt
WHISPER_SERVE = {"batch": 8, "prompt": 224, "gen": 32}
WHISPER_FLASH = 64
WHISPER_PARAMS = 1_534_937_600
FLASH_WHISPER_ENC = (8, 1500, 1500, 20, 20, 64)
FLASH_WHISPER_CROSS = (8, 224, 1500, 20, 20, 64)
WHISPER_PROMPT = 64
# the continuous batcher at full width on StarCoder2-3B (the JAX package's
# batcher test's architecture), float32: 12 requests over 4 rows
BATCHER_ROWS, BATCHER_REQUESTS, BATCHER_MAX_LEN = 4, 12, 64
BATCHER_PROMPT, BATCHER_NEW = (4, 32), (4, 16)
# one decode step with per-row cache lengths on every family with an
# attention cache, smoke size (gemma2_9b's 40 past its 32-slot local
# cache; OLMoE at a capacity that drops nothing)
PER_ROW = (("starcoder2_3b", {}, (3, 29, 11)),
           ("gemma2_9b", {}, (5, 40, 31)),
           ("olmoe_1b_7b", {"capacity_factor": 8.0}, (0, 17, 6)),
           ("deepseek_v3_671b", {}, (11, 2, 40)),
           ("zamba2_7b", {}, (7, 30, 1)))


# the training slice: the flash-attention backward against the plain
# version's autograd gradients, each gradient's relative norm error
# bounded per dtype (float32: the kernel sums in float32 in another order
# from the TF32 x 3 forward's O, 3.9e-6 seen; bfloat16: the gradients are
# rounded to bfloat16, 1.7e-3 seen on random inputs and on StarCoder2-3B's
# activations, the bound tightened from 1e-2 after the first run);
# (label, (B, Sq, Sk, H, KV), causal, window, cap), at every head dim
FLASH_BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
FLASH_BWD_CASES = [("causal", (2, 256, 256, 4, 2), True, 0, 0.0),
                   ("window 64", (1, 300, 300, 4, 2), True, 64, 0.0),
                   ("soft-cap 50", (1, 260, 260, 4, 4), True, 0, 50.0),
                   ("GQA 24/2", (1, 256, 256, 24, 2), True, 0, 0.0),
                   ("non-causal Sq 224 x Sk 1500", (1, 224, 1500, 4, 4),
                    False, 0, 0.0),
                   ("ragged S 77", (1, 77, 77, 2, 1), True, 0, 0.0)]
# the backward timed at StarCoder2-3B's training attention (batch 2 of
# 2048 tokens), Zamba2-7B's prefill shape (D 112), Gemma2-9B's local
# layer (window 4096, cap 50, D 256) and Whisper-large-v3's
# cross-attention: (model, shape, causal, window, cap, dtypes)
FLASH_STARCODER_TRAIN = (2, 2048, 2048, 24, 2, 128)
FLASH_BWD_TIMED = [
    ("StarCoder2-3B", FLASH_STARCODER_TRAIN, True, 0, 0.0,
     (torch.bfloat16, torch.float32)),
    ("Zamba2-7B", FLASH_ZAMBA, True, 0, 0.0, (torch.bfloat16,)),
    ("Gemma2-9B local", FLASH_GEMMA, True, 4096, 50.0, (torch.bfloat16,)),
    ("Whisper-large-v3 cross", FLASH_WHISPER_CROSS, False, 0, 0.0,
     (torch.bfloat16,))]
# the reference test's TINY (tests/test_train.py), float32, at 512 tokens
# (512 * 512 > 256 * 256: flash forward and backward), batch 8, 40 steps
# at the test's OptConfig; its CE over the last 5 steps under 0.8 x the
# first 5, the test's bar; the first step's loss (relative 1e-5) and each
# gradient leaf (relative max-abs 1e-4, the JAX parity tests' bound) held
# to the port's own CPU run of the same step
TINY = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                   vocab_size=256, dtype="float32", param_dtype="float32",
                   remat=False)
TINY_TRAIN = {"batch": 8, "seq": 512, "steps": 40}
TINY_OPT = OptConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                     weight_decay=0.0)
# StarCoder2-3B trained at full width and depth through the launcher
# (repro_torch.launch.train): bfloat16 compute, float32 parameters and
# moments, remat, batch 2 x 2048 tokens from the data pipeline, 4 steps;
# per step 30 wgmma forward launches, 30 more in the remat recomputes and
# 30 backward launches
STARCODER_TRAIN = {"batch": 2, "seq": 2048, "steps": 4}
# steps 2-4 held, not step 1 alone: StarCoder2-3B at full width and 2
# layers, batch 2 x 512 tokens (the chunked branch), 4 steps under the
# launcher's AdamW, against the port's own float32 run on the host CPU
# from the same parameters and batches.  Card float32: each step's CE
# within relative 1e-5 and each parameter after step 4 within relative
# norm 1e-4 (2.7e-07 and 3.6e-06 seen, tools/train_curve_probe.py);
# card bfloat16: each step's CE within relative 1e-2 of the float32
# CPU's (1.9e-03 seen)
STARCODER_STEPS = {"layers": 2, "batch": 2, "seq": 512, "steps": 4}
TRAIN_STEPS_REL = {"ce_float32": 1e-5, "param_float32": 1e-4,
                   "ce_bfloat16": 1e-2}


def _ssd_inputs(b, L, H, P, G, N, dtype, seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + b * L + H * P + N)

    def rnd(shape, scale):
        return torch.randn(shape, generator=g, device="cuda") * scale
    x = rnd((b, L, H, P), 0.5).to(dtype)
    dt = torch.nn.functional.softplus(rnd((b, L, H), 1.0))
    A = -torch.exp(rnd((H,), 0.3))
    return (x, dt, A, rnd((b, L, G, N), 0.3).to(dtype),
            rnd((b, L, G, N), 0.3).to(dtype))


def _ssd_bounds(b, L, H, P, G, N, Q, dtype):
    """(ms over the float32 CUDA-core peak, ms over the tensor cores' peak
    at the precision the kernel takes, ms over HBM) for one scan at the
    chunk the kernel computes at (``ssd_plan``'s steps, not the model's
    Q: the scan is the same function at any chunk, and a shorter chunk
    has fewer causal pairs): the multiply-adds of the four chunk products
    over each chunk's real steps q (C B^T and scores x over the q(q+1)/2
    causal pairs, C state and the state update over q P N each), two
    operations apiece; float32 inputs take three TF32 passes, bfloat16
    ones are counted at the bf16 rate; x, dt, A, B, C read and y, the
    final state written once."""
    steps = ssd_kernel.ssd_plan(L, P, N, Q).steps
    macs = 0
    for c0 in range(0, L, steps):
        q = min(steps, L - c0)
        macs += q * (q + 1) // 2 * (N + P) + 2 * q * P * N
    ops = 2.0 * b * H * macs
    tc = (3 * ops / PEAK_TF32 if dtype == torch.float32
          else ops / PEAK_OPS[torch.bfloat16])
    size = dtype.itemsize
    nbytes = (b * L * H * P * size + b * L * H * 4 + H * 4
              + 2 * b * L * G * N * size + b * L * H * P * 4
              + b * H * P * N * 4)
    return (ops / PEAK_OPS[torch.float32] * 1e3, tc * 1e3,
            nbytes / PEAK_BYTES * 1e3)


def ssd_phase():
    """The SSD kernel == its plain versions (the chunked model version and
    the sequential oracle) within 1e-3, y and final state, f32 and bf16,
    at every cluster size the plan takes, also over a row of several
    cluster segments from an initial state; at Zamba2-7B's prefill shape in
    float32 (the serving path's type: its causal conv, with float32
    weights, hands the scan float32 x, B and C) timed against the chunked
    plain version."""
    max_err, cases, timing = 0.0, 0, None
    for shape in SSD_TEST_SHAPES + [SSD_SEGMENTED, SSD_ZAMBA]:
        b, L, H, P, G, N, Q = shape
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, A, B, C = _ssd_inputs(b, L, H, P, G, N, dtype)
            init = None
            if shape == SSD_SEGMENTED:
                g = torch.Generator(device="cuda")
                g.manual_seed(L)
                init = torch.randn((b, H, P, N), generator=g,
                                   device="cuda") * 0.2
            want_y, want_s = ssd_chunked_plain(x, dt, A, B, C, Q, init)
            if shape in SSD_TEST_SHAPES:    # the sequential oracle too
                seq = ssd_op(x.float(), dt, A, B.float(), C.float())
                torch.testing.assert_close(seq, want_y, atol=1e-3,
                                           rtol=1e-3)
            plan = ssd_kernel.ssd_plan(L, P, N, Q)
            y, fin = ssd_kernel.ssd_cuda(x, dt, A, B, C, chunk=Q,
                                         init_state=init)
            torch.cuda.synchronize()
            err = max(float((y - want_y).abs().max()),
                      float((fin - want_s).abs().max()))
            max_err = max(max_err, err)
            torch.testing.assert_close(
                y, want_y, atol=1e-3, rtol=1e-3,
                msg=lambda m: f"ssd {shape} {dtype} {plan}: {m}")
            torch.testing.assert_close(
                fin, want_s, atol=1e-3, rtol=1e-3,
                msg=lambda m: f"ssd {shape} {dtype} {plan}: {m}")
            cases += 1
            if shape == SSD_ZAMBA and dtype == torch.float32:
                k_ms = _device_ms(lambda: ssd_kernel.ssd_cuda(
                    x, dt, A, B, C, chunk=Q), 10)
                p_ms = _time_ms(lambda: ssd_chunked_plain(x, dt, A, B, C, Q),
                                reps=2)
                cc_ms, tc_ms, byte_ms = _ssd_bounds(*shape, dtype)
                timing = (k_ms, p_ms, max(tc_ms, byte_ms), tc_ms, byte_ms)
                print(f"ssd_mma Zamba2-7B prefill (b={b}, L={L}, H={H}, "
                      f"P={P}, N={N}, Q={Q}) float32 plan={tuple(plan)}: "
                      f"kernel_device_ms={k_ms!r} plain_ms={p_ms!r} "
                      f"bound_ms={timing[2]!r} (tensor-core operations, "
                      f"TF32 x 3 at the kernel's chunk of {plan.steps}, "
                      f"{tc_ms!r} ms at {PEAK_TF32:.3g} op/s; "
                      f"bytes {byte_ms!r} ms at {PEAK_BYTES:.3g} B/s; "
                      f"float32 CUDA-core operations {cc_ms!r} ms at "
                      f"{PEAK_OPS[torch.float32]:.3g} op/s)")
            del x, dt, A, B, C, want_y, want_s
    print(f"ssd phase ok: {cases} shape/dtype cases within 1e-3 of the "
          f"plain versions, max_abs_err={max_err!r}")
    return max_err, timing


def _flash_inputs(B, Sq, Sk, H, KV, D, dtype):
    g = torch.Generator(device="cuda")
    g.manual_seed(B * Sq + H * D + KV)
    return tuple(torch.randn(s, generator=g, device="cuda").to(dtype)
                 for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))


def _flash_bounds(B, Sq, Sk, H, KV, D, causal, window, dtype):
    """(ms over the float32 CUDA-core peak, ms over the tensor cores' peak
    at the precision the kernel takes, ms over HBM): q k^T and p v over
    the visible (query, key) pairs of this mask, two operations per
    multiply-add; float32 inputs take three TF32 passes on the tensor
    cores (the card's fastest route at float32's accuracy), bfloat16 ones
    are counted at the bf16 rate; q, k, v read and the output written
    once."""
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis &= qp >= kp
    if window > 0:
        vis &= qp - kp < window
    ops = 2.0 * 2 * B * H * int(vis.sum()) * D
    tc = (3 * ops / PEAK_TF32 if dtype == torch.float32
          else ops / PEAK_OPS[torch.bfloat16])
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KV * D) * dtype.itemsize
    return (ops / PEAK_OPS[torch.float32] * 1e3, tc * 1e3,
            nbytes / PEAK_BYTES * 1e3)


def _time_flash(shape, dtype, q, k, v, kernel, reps, window=0, cap=0.0,
                causal=True):
    """(kernel ms, plain ms, bound ms, tensor-core ops ms, bytes ms,
    library ms, CUDA-core ops ms) at ``shape`` (Sq and Sk may differ),
    ``causal`` or not, with ``window`` and soft-cap ``cap``: device time
    per launch of ``kernel``, the model's chunked plain version, and
    torch's scaled_dot_product_attention as a yardstick the port never
    calls (K and V repeated to every head outside the timing where KV <
    H; a window as a boolean mask; it has no soft-cap, so with ``cap`` it
    is a guide, not the same function)."""
    B, Sq, Sk, H, KV, D = shape
    k_ms = _device_ms(lambda: kernel(q, k, v, causal=causal, window=window,
                                     softcap=cap), reps)
    qg = q.reshape(B, Sq, KV, H // KV, D)
    qpos = torch.arange(Sq, device="cuda")
    kpos = torch.arange(Sk, device="cuda")
    p_ms = _time_ms(lambda: _sdpa_chunked(qg, k, v, qpos, kpos, causal,
                                          window, cap, None, 1024), reps=2)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if KV < H:
        kt, vt = (t.repeat_interleave(H // KV, dim=1) for t in (kt, vt))
    if window:
        qp = torch.arange(Sq, device="cuda")[:, None]
        kp = torch.arange(Sk, device="cuda")[None, :]
        mask = (qp >= kp) & (qp - kp < window)
        lib = {"attn_mask": mask}
    else:
        lib = {"is_causal": causal}
    lib_ms = _device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, **lib), 5)
    del qt, kt, vt
    cc_ms, tc_ms, byte_ms = _flash_bounds(*shape, causal, window, dtype)
    return k_ms, p_ms, max(tc_ms, byte_ms), tc_ms, byte_ms, lib_ms, cc_ms


def _check_flash(q, k, v, causal, window, cap, kernel, case):
    """One launch of ``kernel`` on (q, k, v) held to the model's chunked
    plain version and the naive oracle (which agree first): float32 within
    2e-5 of both; bf16 within 2e-2 of the chunked one and within
    WGMMA_REL_NORM on the relative norm of the whole error against the
    naive one.  Returns (max abs error, that relative norm or None)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    f32 = q.dtype == torch.float32
    tol = 2e-5 if f32 else 2e-2
    want = _sdpa_chunked(q.reshape(B, Sq, KV, H // KV, D), k, v,
                         torch.arange(Sq, device="cuda"),
                         torch.arange(Sk, device="cuda"), causal, window, cap,
                         None, 1024).reshape(B, Sq, H, D)
    naive = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                          window=window, softcap=cap)
    torch.testing.assert_close(want, naive, atol=tol, rtol=tol)
    got = kernel(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    e = float((got.float() - want).abs().max())
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol,
                               msg=lambda m: f"flash {case}: {m}")
    if f32:
        e = max(e, float((got - naive).abs().max()))
        torch.testing.assert_close(
            got, naive, atol=tol, rtol=tol,
            msg=lambda m: f"flash {case} against the naive oracle: {m}")
        return e, None
    rel = float((got.float() - naive).norm() / naive.norm())
    assert rel <= WGMMA_REL_NORM, (
        f"flash {case}: rel_norm_err {rel!r} > {WGMMA_REL_NORM}")
    return e, rel


DENSE_FLASH_CASES = ((FLASH_GEMMA, FLASH_GEMMA_MASKS, "Gemma2-9B"),
                     (FLASH_STARCODER, [(True, 0, 0.0)], "StarCoder2-3B"),
                     (FLASH_OLMOE, [(True, 0, 0.0)], "OLMoE-1B-7B"))


def _flash_served(err, cases=DENSE_FLASH_CASES):
    """The flash kernels at served shapes (``cases``: (shape, masks,
    model); by default the dense and MoE families': Gemma2-9B's local and
    global layers at its serve phase's prompt (FLASH_GEMMA,
    FLASH_GEMMA_MASKS), StarCoder2-3B's causal attention at its own
    (FLASH_STARCODER) and OLMoE-1B-7B's (FLASH_OLMOE, where SDPA computes
    the same function)), bf16 on the wgmma kernel and float32 on the
    mma.sync kernel (:func:`_check_flash`), each timed against the chunked
    plain version, SDPA and its bound.  Raises the worst errors in
    ``err``; returns {(model, shape, window, dtype): _time_flash's
    tuple}."""
    timing = {}
    for shape, masks, model in cases:
        B, Sq, Sk, H, KV, D = shape
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            kernel, name, kind = (
                (flash_kernel.flash_attention_cuda, "flash_attention_mma",
                 "f32") if f32 else
                (flash_kernel.flash_attention_wgmma, "flash_attention_wgmma",
                 "wgmma"))
            q, k, v = _flash_inputs(*shape, dtype)
            for causal, window, cap in masks:
                seq = f"S={Sq}" if Sq == Sk else f"Sq={Sq}, Sk={Sk}"
                case = (f"{model} (B={B}, {seq}, H={H}, KV={KV}, D={D}, "
                        f"{'causal' if causal else 'non-causal'}, "
                        f"window={window}, cap={cap}) "
                        f"{str(dtype).split('.')[-1]}")
                e, rel = _check_flash(q, k, v, causal, window, cap, kernel,
                                      f"{case} {name}")
                err[kind] = max(err[kind], e)
                held = ("bound 2e-5; chunked and naive plain" if f32 else
                        f"bound 2e-2; chunked plain; rel_norm_err={rel!r} "
                        f"against the naive oracle, bound {WGMMA_REL_NORM}")
                t = _time_flash(shape, dtype, q, k, v, kernel,
                                5 if f32 else 10, window, cap, causal)
                timing[(model, shape, window, dtype)] = t
                lib = ("uncapped SDPA, a guide, not the same function"
                       + (", the window as a boolean mask" if window else "")
                       if cap else "torch scaled_dot_product_attention")
                print(f"{name} {case}: max_abs_err={e!r} ({held}) "
                      f"kernel_device_ms={t[0]!r} plain_ms={t[1]!r} "
                      f"bound_ms={t[2]!r} (tensor-core operations {t[3]!r} "
                      "ms, " + ("TF32 x 3 at " + f"{PEAK_TF32:.3g}" if f32
                                else f"at {PEAK_OPS[dtype]:.3g}")
                      + f" op/s; bytes {t[4]!r} ms at {PEAK_BYTES:.3g} B/s) "
                      f"library_ms ({lib})={t[5]!r}")
            del q, k, v
    return timing


def flash_phase():
    """Both flash kernels == their plain versions (the model's chunked
    recurrence and the naive oracle) over every mask case, Zamba2-7B's
    prefill shape included (causal), and f32 only the FLASH_F32_SHAPES
    shapes (every mask) and the consistency prefill's shape: the TF32
    mma.sync kernel (f32) within 2e-5 of both in every plan
    ``mma_plan`` gives (one and two row tiles a warp, reached through
    the shapes' grids; checked), the wgmma kernel (bf16) within
    2e-2 and within WGMMA_REL_NORM on the relative norm of the whole
    error against the float32 oracle.  At the prefill shape, bf16 on the
    wgmma kernel and f32 on the mma.sync kernel are timed against the
    chunked plain version, torch's scaled_dot_product_attention and the
    bound, and f32 also at the consistency prefill's shape; then the
    dense family's served shapes (:func:`_flash_served`).  Returns (max
    err, timing at the prefill shape) of the f32 kernel over its f32
    cases and of the bf16 kernel, and the dense shapes' timings."""
    err = {"f32": 0.0, "wgmma": 0.0}
    cases, timing, worst_rel = 0, {}, 0.0
    plans = set()
    for shape in (FLASH_TEST_SHAPES + FLASH_F32_SHAPES
                  + [FLASH_ZAMBA, FLASH_CONSISTENCY]):
        B, Sq, Sk, H, KV, D = shape
        masks = (FLASH_MASKS if shape in FLASH_TEST_SHAPES + FLASH_F32_SHAPES
                 else [(True, 0, 0.0)])
        dtypes = ((torch.float32, torch.bfloat16)
                  if shape in FLASH_TEST_SHAPES + [FLASH_ZAMBA]
                  else (torch.float32,))
        for dtype in dtypes:
            q, k, v = _flash_inputs(*shape, dtype)
            for causal, window, cap in masks:
                if dtype == torch.float32:
                    plan = flash_kernel.mma_plan(
                        D, B * H, Sq, flash_kernel._sms(q.device))
                    plans.add((D, plan))
                    kind, label = "f32", f"mma {plan}"
                    kernel = flash_kernel.flash_attention_cuda
                else:
                    kind = "wgmma"
                    label = f"wgmma {flash_kernel.wgmma_plan(D)}"
                    kernel = flash_kernel.flash_attention_wgmma
                e, rel = _check_flash(
                    q, k, v, causal, window, cap, kernel,
                    f"{shape} {dtype} causal={causal} window={window} "
                    f"cap={cap} {label}")
                err[kind] = max(err[kind], e)
                cases += 1
                if kind == "wgmma":
                    worst_rel = max(worst_rel, rel)
                    if shape == FLASH_ZAMBA:
                        print(f"flash_attention_wgmma at Zamba2-7B's "
                              f"prefill shape (B={B}, S={Sq}, H=KV={H}, "
                              f"D={D}, causal): max_abs_err={e!r} "
                              f"(bound 2e-2), rel_norm_err={rel!r} "
                              f"(bound {WGMMA_REL_NORM})")
                elif shape in (FLASH_ZAMBA, FLASH_CONSISTENCY):
                    where = ("Zamba2-7B's prefill shape"
                             if shape == FLASH_ZAMBA else
                             "the float32 consistency prefill's shape")
                    print(f"flash_attention_mma float32 at {where} "
                          f"(B={B}, S={Sq}, H=KV={H}, D={D}, causal), "
                          f"{label}: max_abs_err={e!r} (bound 2e-5; "
                          "chunked and naive plain)")
            if shape in (FLASH_ZAMBA, FLASH_CONSISTENCY):
                kernel, name = ((flash_kernel.flash_attention_wgmma,
                                 "flash_attention_wgmma") if dtype ==
                                torch.bfloat16 else
                                (flash_kernel.flash_attention_cuda,
                                 "flash_attention_mma"))
                t = _time_flash(shape, dtype, q, k, v, kernel,
                                5 if shape == FLASH_ZAMBA and dtype ==
                                torch.float32 else 20)
                if shape == FLASH_ZAMBA:
                    timing[dtype] = t
                where = ("Zamba2-7B prefill" if shape == FLASH_ZAMBA else
                         "float32 consistency prefill")
                print(f"{name} {where} (B={B}, S={Sq}, H=KV={H}, "
                      f"D={D}, causal) {str(dtype).split('.')[-1]}: "
                      f"kernel_device_ms={t[0]!r} plain_ms={t[1]!r} "
                      f"library_ms (torch scaled_dot_product_attention)="
                      f"{t[5]!r} bound_ms={t[2]!r} (tensor-core "
                      f"operations {t[3]!r} ms, "
                      + ("TF32 x 3 at " + f"{PEAK_TF32:.3g}"
                         if dtype == torch.float32 else
                         f"at {PEAK_OPS[dtype]:.3g}")
                      + f" op/s; bytes {t[4]!r} ms at {PEAK_BYTES:.3g} B/s; "
                      f"float32 CUDA-core operations {t[6]!r} ms at "
                      f"{PEAK_OPS[torch.float32]:.3g} op/s)")
            del q, k, v
    dense = _flash_served(err)
    every_plan = {(D, flash_kernel.mma_plan(D, bh, 320))
                  for D in flash_kernel.WGMMA_HEAD_DIMS for bh in (1, 1024)}
    assert plans == every_plan, (
        f"float32 plans not reached: {sorted(every_plan - plans)}")
    print(f"flash phase ok: {cases} shape/dtype/mask/kernel/plan cases "
          f"within tolerance of the plain versions, max_abs_err mma.sync "
          f"TF32 x 3 f32={err['f32']!r}, wgmma bf16={err['wgmma']!r} "
          f"(rel_norm_err max {worst_rel!r}, bound {WGMMA_REL_NORM})")
    return ((err["f32"], timing[torch.float32]),
            (err["wgmma"], timing[torch.bfloat16]), dense)


def _routed_to(recorded):
    """``ops.forward_kernel`` with ``recorded`` in the float32 kernel's
    place: a phase's stand-in that records each float32 flash launch the
    model path makes (the kernel itself, and its count, stay as they
    are)."""
    def forward_kernel(dtype):
        return (recorded if dtype == torch.float32
                else flash_kernel.forward_kernel(dtype))
    return forward_kernel


def _model_counts():
    """(SSD, float32 flash, bfloat16 flash) launches so far."""
    return (ssd_kernel.ssd_cuda.launches,
            flash_kernel.flash_attention_cuda.launches,
            flash_kernel.flash_attention_wgmma.launches)


def _reset_model_counts():
    ssd_kernel.ssd_cuda.launches = 0
    flash_kernel.flash_attention_cuda.launches = 0
    flash_kernel.flash_attention_wgmma.launches = 0


def _rel(got, want):
    return float((got.float() - want.float().to(got.device)).abs().max()) / (
        float(want.float().abs().max()) + 1e-9)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


class _RouterMargins:
    """While active, wraps ``moe._router_probs`` to record the smallest
    margin between the k-th and the (k+1)-th router score of any token:
    where the card and the CPU choose different experts, it says whether
    a near-tie made them."""

    def __enter__(self):
        self.min, self._orig = float("inf"), moe._router_probs

        def probs(cfg, logits):
            scores = (torch.sigmoid(logits) if cfg.router_type == "sigmoid"
                      else torch.softmax(logits, dim=-1))
            top = torch.topk(scores, cfg.top_k + 1, dim=-1).values
            self.min = min(self.min, float(
                (top[:, -2] - top[:, -1]).min()))
            return self._orig(cfg, logits)
        moe._router_probs = probs
        return self

    def __exit__(self, *exc):
        moe._router_probs = self._orig


class _Capacities:
    """While active, records every capacity ``moe_block`` computes."""

    def __enter__(self):
        self.seen, self._orig = collections.Counter(), moe.capacity

        def capacity(cfg, T):
            c = self._orig(cfg, T)
            self.seen[c] += 1
            return c
        moe.capacity = capacity
        return self

    def __exit__(self, *exc):
        moe.capacity = self._orig


def _parity_run(arch, patches=False, **changes):
    """One smoke model in float32: the port on the card (its kernels)
    against the port on the CPU (their plain versions): prefill logits and
    every cache leaf, then 8 decode steps from ``prefill_into_cache`` (a
    gemma2 local cache of 32 slots rolled), logits each step and every
    cache leaf after the last, rel 1e-4; the prefill's (SSD, float32
    flash, bf16 flash) launches expected for the family, none in decode.
    ``patches``: pixtral's prompt starts with seeded patch embeddings.
    An MoE model runs at its default capacity; the smallest router top-k
    margin of the CPU's run is printed beside the result.  Whisper reads
    seeded frame embeddings; with ``encoder_seq`` 320 among ``changes``
    its encoder (320 x 320) and cross-attention (300 x 320) take the
    kernel too, beside the decoder's self-attention (300 x 300)."""
    cfg = get_smoke(arch).scaled(dtype="float32", param_dtype="float32",
                                 **changes)
    cpu_params = init_model(cfg, seed=3, device="cpu")
    gpu_params = tree_map(lambda t: t.cuda(), cpu_params,
                          lambda t: isinstance(t, torch.Tensor))
    B, S, steps = 2, 300, 8
    g = torch.Generator()
    g.manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=g)
    pe = (torch.randn((B, cfg.n_patches, cfg.d_model), generator=g) * 0.1
          if patches else None)
    fr = (torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=g) * 0.1
          if cfg.family == "encdec" else None)
    cpu_batch = {"tokens": toks[:, :S]}
    gpu_batch = {"tokens": toks[:, :S].cuda()}
    if patches:
        cpu_batch["patch_embeds"], gpu_batch["patch_embeds"] = pe, pe.cuda()
    if fr is not None:
        cpu_batch["frames"], gpu_batch["frames"] = fr, fr.cuda()
    _reset_model_counts()
    margins = _RouterMargins()
    with torch.inference_mode():
        with margins:
            lg_cpu, c_cpu = prefill(cpu_params, cfg, cpu_batch, S)
        lg_gpu, c_gpu = prefill(gpu_params, cfg, gpu_batch, S)
    torch.cuda.synchronize()
    pre = _model_counts()
    rels = [_rel(lg_gpu, lg_cpu)] + [
        _rel(a, b) for a, b in zip(_leaves(c_gpu), _leaves(c_cpu))]
    with margins:
        _, d_cpu = serve_steps.prefill_into_cache(
            cpu_params, cfg, toks[:, :S], S + steps, patch_embeds=pe,
            frames=fr)
    _, d_gpu = serve_steps.prefill_into_cache(
        gpu_params, cfg, toks[:, :S].cuda(), S + steps,
        patch_embeds=None if pe is None else pe.cuda(),
        frames=None if fr is None else fr.cuda())
    before = _model_counts()
    dec = []
    with torch.inference_mode():
        for i in range(steps):
            t = toks[:, S + i:S + i + 1]
            with margins:
                a, d_cpu = decode_step(cpu_params, cfg, t, d_cpu, S + i)
            b, d_gpu = decode_step(gpu_params, cfg, t.cuda(), d_gpu, S + i)
            dec.append(_rel(b, a))
    torch.cuda.synchronize()
    dec_launches = tuple(x - y for x, y in zip(_model_counts(), before))
    cache_rel = max(_rel(a, b) for a, b in zip(_leaves(d_gpu),
                                               _leaves(d_cpu)))
    if cfg.family == "hybrid":
        want = (cfg.n_layers, cfg.n_layers // cfg.hybrid_period, 0)
    elif cfg.use_mla:                  # MLA: plain PyTorch, no kernel
        want = (0, 0, 0)
    elif cfg.family == "encdec":       # the attentions past 256 x 256
        Se = cfg.encoder_seq
        want = (0, (S * S > 256 * 256) * cfg.n_layers
                + (Se * Se > 256 * 256) * cfg.n_encoder_layers
                + (S * Se > 256 * 256) * cfg.n_layers, 0)
    else:
        want = (0, cfg.n_layers, 0)
    label = cfg.name + (" with patch embeddings" if patches else "")
    if cfg.family == "encdec":
        label += f", encoder_seq {cfg.encoder_seq}"
    if cfg.use_mla:
        label += (f", MLA threshold {mla.FLASH_THRESHOLD}: the "
                  + ("chunked" if S > mla.FLASH_THRESHOLD else "dense")
                  + " branch")
    if cfg.n_experts:
        label += (f", default capacity, smallest router top-k margin "
                  f"{margins.min!r}")
    print(f"model parity ({label}, float32, B={B}, S={S}): prefill logits "
          f"rel={rels[0]!r}, max cache-leaf rel={max(rels[1:])!r} over "
          f"{len(rels) - 1} leaves, {steps} decode steps max rel="
          f"{max(dec)!r}, decode cache rel={cache_rel!r}; prefill launches "
          f"(ssd, flash, flash_wgmma)={pre} (expected {want}), decode "
          f"launches {dec_launches}")
    if not (max(rels + dec + [cache_rel]) <= 1e-4 and pre == want
            and dec_launches == (0, 0, 0)):
        raise AssertionError(f"the {label} model on the card differs from "
                             "the CPU, or the kernels were not taken")


def model_parity_phase():
    """The Zamba2 smoke model, the five dense and the two MoE smoke
    configs (pixtral also with patch embeddings, DeepSeek-V3 also with
    ``mla.FLASH_THRESHOLD`` at 64) on the card against the CPU
    (:func:`_parity_run`)."""
    for arch in ("zamba2_7b",) + DENSE_SMOKE + MOE_SMOKE:
        _parity_run(arch)
    _parity_run("pixtral_12b", patches=True)
    saved, mla.FLASH_THRESHOLD = mla.FLASH_THRESHOLD, 64
    try:
        _parity_run("deepseek_v3_671b")
    finally:
        mla.FLASH_THRESHOLD = saved


def _recorded_flash_err(seen):
    """Max abs error of the float32 flash kernel's recorded launches
    (q, k, v, keywords, output) against the model's chunked plain version
    and the naive oracle on the same inputs; raises past 2e-5."""
    err = 0.0
    for q, k, v, kw, got in seen:
        B, S, H, D = q.shape
        KV = k.shape[2]
        chunked = _sdpa_chunked(q.reshape(B, S, KV, H // KV, D), k, v,
                                torch.arange(S, device="cuda"),
                                torch.arange(k.shape[1], device="cuda"),
                                kw["causal"], kw["window"], kw["softcap"],
                                None, 1024).reshape(B, S, H, D)
        naive = attention_ref(q, k, v, **kw)
        errs = [float((got - want).abs().max()) for want in (chunked, naive)]
        err = max(err, *errs)
        for want, label in ((chunked, "chunked"), (naive, "naive")):
            torch.testing.assert_close(
                got, want, atol=2e-5, rtol=2e-5,
                msg=lambda m: f"float32 flash kernel in the consistency "
                f"prefill {tuple(q.shape)} {kw} against the {label} plain "
                f"version (plain versions apart by "
                f"{float((chunked - naive).abs().max())!r}): {m}")
    return err


def consistency_phase():
    """Zamba2-7B at full width in float32 compute, one request: the
    prefill of 320 prompt tokens (the SSD and the float32 flash kernel)
    against the teacher-forced decode of the same tokens (no kernel),
    last-position logits within relative 2e-2 (the JAX package's bound
    for decode against a full forward).  Those logits need not see the
    flash kernel's last digits, so every float32 flash launch of the
    prefill is recorded (inputs and output) and held within 2e-5 of the
    chunked plain version and the naive oracle on its own inputs.
    Counts set to 0 just before the prefill and read just after; returns
    the float32 flash kernel's launches there (the float32 path's)."""
    cfg = get_config("zamba2_7b").scaled(dtype="float32")
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    n = CONSISTENCY_LEN
    toks = torch.randint(0, cfg.vocab_size, (1, n), generator=g,
                         device="cuda")
    seen, kernel = [], flash_kernel.flash_attention_cuda

    def recorded(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        seen.append((q.clone(), k.clone(), v.clone(), kw, out.clone()))
        return out

    flash_ops.forward_kernel = _routed_to(recorded)
    _reset_model_counts()
    try:
        with torch.inference_mode():
            lg_pre, _ = prefill(params, cfg, {"tokens": toks}, n)
            torch.cuda.synchronize()
            pre = _model_counts()
    finally:
        flash_ops.forward_kernel = flash_kernel.forward_kernel
    with torch.inference_mode():
        n_seen, flash_err = len(seen), _recorded_flash_err(seen)
        del seen
        cache = init_cache(cfg, 1, n, dtype=torch.float32)
        t0 = time.perf_counter()
        for i in range(n):
            lg_dec, cache = decode_step(params, cfg, toks[:, i:i + 1], cache,
                                        i)
        torch.cuda.synchronize()
        tf_s = time.perf_counter() - t0
    dec = tuple(x - y for x, y in zip(_model_counts(), pre))
    rel = _rel(lg_pre[:, -1], lg_dec[:, -1])
    same = bool(torch.equal(lg_pre[:, -1, :cfg.vocab_size].argmax(-1),
                            lg_dec[:, -1, :cfg.vocab_size].argmax(-1)))
    print(f"full-width consistency (Zamba2-7B, float32 compute, 1 x {n} "
          f"tokens): init_s={init_s!r} prefill launches ssd={pre[0]} flash="
          f"{pre[1]} flash_wgmma={pre[2]}; teacher-forced decode {tf_s!r} "
          f"s, launches {dec}; last-logits rel={rel!r} same_argmax={same}; "
          f"float32 flash kernel on its {n_seen} recorded prefill launches: "
          f"max_abs_err={flash_err!r} (bound 2e-5; chunked and naive plain)")
    if not (rel <= 2e-2 and pre == (ZAMBA_SSD, ZAMBA_FLASH, 0)
            and n_seen == ZAMBA_FLASH and dec == (0, 0, 0)
            and bool(torch.isfinite(lg_pre).all())):
        raise AssertionError("full-width prefill and teacher-forced decode "
                             "disagree, or the kernels were not taken")
    del params, cache
    return pre[1]


def window_consistency_phase():
    """Gemma2-9B at full width in float32 compute, one request: the
    prefill of WINDOW_PROMPT prompt tokens (past the 4096 window) through
    ``prefill_into_cache`` into a decode cache of WINDOW_PROMPT +
    WINDOW_STEPS (its 21 local caches, 4096 slots each, rolled), then
    WINDOW_STEPS teacher-forced decode steps (the local caches wrap on),
    the last step's logits against the last logits of one prefill over
    all WINDOW_PROMPT + WINDOW_STEPS tokens, within relative 2e-2 (the
    JAX package's bound for decode against a full forward).  Every float32
    flash launch of the first prefill is recorded and held within 2e-5 of
    the chunked plain version and the naive oracle on its own inputs (42:
    21 local layers at window 4096, 21 global ones, all soft-capped).
    Counts set to 0 just before the first prefill and read after each
    step; returns the float32 flash kernel's launches over both
    prefills."""
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    cfg = get_config("gemma2_9b").scaled(dtype="float32")
    params = init_model(cfg, seed=0)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    P, n = WINDOW_PROMPT, WINDOW_STEPS
    toks = torch.randint(0, cfg.vocab_size, (1, P + n), generator=g,
                         device="cuda")
    seen, kernel = [], flash_kernel.flash_attention_cuda

    def recorded(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        seen.append((q.clone(), k.clone(), v.clone(), kw, out.clone()))
        return out

    flash_ops.forward_kernel = _routed_to(recorded)
    _reset_model_counts()
    try:
        t0 = time.perf_counter()
        _, cache = serve_steps.prefill_into_cache(params, cfg, toks[:, :P],
                                                  P + n)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre = _model_counts()
    finally:
        flash_ops.forward_kernel = flash_kernel.forward_kernel
    windows = collections.Counter((kw["window"], kw["softcap"])
                                  for _, _, _, kw, _ in seen)
    with torch.inference_mode():
        n_seen, flash_err = len(seen), _recorded_flash_err(seen)
    del seen
    local_len = cache["pairs"]["local"]["k"].shape[2]
    with torch.inference_mode():
        t0 = time.perf_counter()
        for i in range(P, P + n):
            lg_dec, cache = decode_step(params, cfg, toks[:, i:i + 1], cache,
                                        i)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        dec = tuple(x - y for x, y in zip(_model_counts(), pre))
        del cache
        lg_full, _ = prefill(params, cfg, {"tokens": toks}, P + n)
        torch.cuda.synchronize()
    full = tuple(x - y - z for x, y, z in zip(_model_counts(), pre, dec))
    rel = _rel(lg_dec[:, -1], lg_full[:, -1])
    same = bool(torch.equal(lg_dec[:, -1, :cfg.vocab_size].argmax(-1),
                            lg_full[:, -1, :cfg.vocab_size].argmax(-1)))
    want = (0, GEMMA_LAYERS, 0)
    print(f"window consistency (Gemma2-9B, float32 compute, 1 x {P} prompt "
          f"tokens into {P + n} slots, local caches {local_len} slots, "
          f"{n} teacher-forced steps): resident_before_bytes={resident} "
          f"prefill_s={prefill_s!r} decode_s={decode_s!r} launches "
          f"(ssd, flash, flash_wgmma) prefill={pre} decode={dec} full "
          f"prefill={full}; last-step logits against the {P + n}-token "
          f"prefill rel={rel!r} (bound 2e-2) same_argmax={same}; float32 "
          f"flash kernel on its {n_seen} recorded prefill launches "
          f"(window, cap): {dict(windows)}, max_abs_err={flash_err!r} "
          "(bound 2e-5; chunked and naive plain)")
    half = GEMMA_LAYERS // 2
    if not (rel <= 2e-2 and pre == want and full == want
            and dec == (0, 0, 0) and n_seen == GEMMA_LAYERS
            and windows == {(cfg.sliding_window, 50.0): half, (0, 50.0): half}
            and local_len == cfg.sliding_window < P
            and bool(torch.isfinite(lg_full).all())):
        raise AssertionError("Gemma2-9B's rolled decode and its full prefill "
                             "disagree, or the kernels were not taken")
    del params
    return pre[1] + full[1]


def _serve_run(arch, dims, n_ssd, n_flash, caps=None):
    """``repro_torch.launch.serve`` at full width, bf16 compute (``dims``:
    batch, prompt, new tokens; one untimed warm-up run of the same batch
    first), counts set to 0 just before and read just after: every
    prefill ran ``n_ssd`` SSD and ``n_flash`` tensor-core flash launches,
    no decode step any; tokens in the vocabulary, peak memory under 80
    GB; for an MoE model the capacities of its expert buffers are
    ``caps`` ({"prefill": ..., "decode": ...}).  The parameters live
    inside the launcher's call: one copy at a time.  Returns the (SSD,
    float32 flash, bf16 flash) launches of the two runs."""
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    cfg = get_config(arch)
    _reset_model_counts()
    with _Capacities() as seen_caps:
        res = serve_launch.main(["--arch", arch, "--batch",
                                 str(dims["batch"]), "--prompt-len",
                                 str(dims["prompt"]), "--gen",
                                 str(dims["gen"])])
    torch.cuda.synchronize()
    counts = _model_counts()
    runs = 2                                    # warm-up + timed
    print(f"serve ({cfg.name}, bf16, batch {dims['batch']}, prompt "
          f"{dims['prompt']}, {dims['gen']} new tokens): prefill_s="
          f"{res['prefill_s']!r} prompt_tokens_per_s="
          f"{res['prompt_tokens_per_s']!r} "
          + (f"frames_per_s={res['frames_per_s']!r} "
             if res["frames_per_s"] is not None else "")
          + f"decode_ms_p50="
          f"{res['decode_ms_p50']!r} decode_ms_p95={res['decode_ms_p95']!r} "
          f"generated_tokens_per_s={res['generated_tokens_per_s']!r} "
          f"launches_per_prefill={res['prefill_launches']} "
          f"launches_in_decode={res['decode_launches']} "
          f"peak_memory_bytes={res['peak_memory_bytes']} "
          f"resident_before_bytes={resident} run_launches (ssd, flash, "
          f"flash_wgmma)={counts}"
          + (f" expert capacities (slots per expert: calls)="
             f"{dict(seen_caps.seen)}" if cfg.n_experts else ""))
    print(f"  decode ms per token: {res['decode_ms']}")
    if cfg.n_experts and set(seen_caps.seen) != {caps["prefill"],
                                                 caps["decode"]}:
        raise AssertionError(f"{cfg.name}: expert capacities "
                             f"{dict(seen_caps.seen)}, expected {caps}")
    if not (res["prefill_launches"] == {"ssd": n_ssd, "flash": n_flash}
            and res["decode_launches"] == {"ssd": 0, "flash": 0}
            and counts == (runs * n_ssd, 0, runs * n_flash)):
        raise AssertionError(f"the {cfg.name} serving path did not run "
                             f"{n_ssd} SSD and {n_flash} tensor-core flash "
                             "launches per prefill and none in decode")
    toks = res["tokens"]
    if not (toks.shape == (dims["batch"], dims["gen"])
            and bool(torch.isfinite(res["logits"]).all())
            and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
            and res["peak_memory_bytes"] < 80e9):
        raise AssertionError(f"implausible {cfg.name} serving output")
    return counts


def serve_phase():
    """The main path: Zamba2-7B served at full width (batch 4, prompt
    2048, 32 new tokens; :func:`_serve_run`): 81 SSD and 13 tensor-core
    flash launches per prefill.  Returns (ssd launches, tensor-core flash
    launches) of the run."""
    n_ssd, _, n_wgmma = _serve_run("zamba2_7b", SERVE, ZAMBA_SSD,
                                   ZAMBA_FLASH)
    return n_ssd, n_wgmma


def dense_serve_phase(arch):
    """The dense family's main path (:func:`_serve_run`): Gemma2-9B at
    batch 2 of 6144-token prompts (its local layers' window bites; the
    soft-cap on every layer), StarCoder2-3B at batch 4 of 2048 (LayerNorm,
    the non-gated GELU MLP, KV = 2), 32 new tokens each, one tensor-core
    flash launch per layer a prefill.  Returns those launches."""
    dims, layers = {"gemma2_9b": (GEMMA_SERVE, GEMMA_LAYERS),
                    "starcoder2_3b": (STARCODER_SERVE,
                                      STARCODER_LAYERS)}[arch]
    return _serve_run(arch, dims, 0, layers)[2]


def olmoe_serve_phase():
    """The MoE family's main path (:func:`_serve_run`): OLMoE-1B-7B at
    full width and depth (27.3 GB of float32 parameters), batch 4 of
    2048-token prompts, 32 new tokens: 16 tensor-core flash launches a
    prefill (its qk-norm attention), none in decode, capacities 1280 in
    prefill and 1 in decode.  Returns those launches."""
    return _serve_run("olmoe_1b_7b", OLMOE_SERVE, 0, OLMOE_LAYERS,
                      OLMOE_CAPS)[2]


def moe_consistency_phase():
    """OLMoE-1B-7B at full width in float32 compute, one request, at
    ``capacity_factor = n_experts`` (no assignment dropped, as the JAX
    package's decode test: at the default capacity a prefill and one-token
    steps drop different assignments): OLMOE_PROMPT prompt tokens through
    ``prefill_into_cache``, OLMOE_STEPS teacher-forced decode steps, the
    last step's logits against the last logits of one prefill over all
    OLMOE_PROMPT + OLMOE_STEPS tokens, within relative 2e-2 (the JAX
    package's bound for decode against a full forward).  Every float32
    flash launch of both prefills (16 each) is recorded and held within
    2e-5 of the chunked plain version and the naive oracle on its own
    inputs.  Counts set to 0 just before the first prefill and read after
    each step; returns the float32 flash launches of both prefills."""
    torch.cuda.empty_cache()
    cfg = get_config("olmoe_1b_7b").scaled(
        dtype="float32", capacity_factor=float(get_config(
            "olmoe_1b_7b").n_experts))
    params = init_model(cfg, seed=0)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    P, n = OLMOE_PROMPT, OLMOE_STEPS
    toks = torch.randint(0, cfg.vocab_size, (1, P + n), generator=g,
                         device="cuda")
    seen, kernel = [], flash_kernel.flash_attention_cuda

    def recorded(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        seen.append((q.clone(), k.clone(), v.clone(), kw, out.clone()))
        return out

    flash_ops.forward_kernel = _routed_to(recorded)
    _reset_model_counts()
    try:
        t0 = time.perf_counter()
        _, cache = serve_steps.prefill_into_cache(params, cfg, toks[:, :P],
                                                  P + n)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre = _model_counts()
        with torch.inference_mode():
            for i in range(P, P + n):
                lg_dec, cache = decode_step(params, cfg, toks[:, i:i + 1],
                                            cache, i)
            torch.cuda.synchronize()
            dec = tuple(x - y for x, y in zip(_model_counts(), pre))
            del cache
            lg_full, _ = prefill(params, cfg, {"tokens": toks}, P + n)
            torch.cuda.synchronize()
    finally:
        flash_ops.forward_kernel = flash_kernel.forward_kernel
    full = tuple(x - y - z for x, y, z in zip(_model_counts(), pre, dec))
    with torch.inference_mode():
        n_seen, flash_err = len(seen), _recorded_flash_err(seen)
    del seen
    rel = _rel(lg_dec[:, -1], lg_full[:, -1])
    same = bool(torch.equal(lg_dec[:, -1, :cfg.vocab_size].argmax(-1),
                            lg_full[:, -1, :cfg.vocab_size].argmax(-1)))
    want = (0, OLMOE_LAYERS, 0)
    print(f"MoE consistency (OLMoE-1B-7B, float32 compute, capacity factor "
          f"{cfg.capacity_factor}: no drops, 1 x {P} prompt tokens, {n} "
          f"teacher-forced steps): prefill_s={prefill_s!r} launches (ssd, "
          f"flash, flash_wgmma) prefill={pre} decode={dec} full prefill="
          f"{full}; last-step logits against the {P + n}-token prefill "
          f"rel={rel!r} (bound 2e-2) same_argmax={same}; float32 flash "
          f"kernel on its {n_seen} recorded prefill launches: max_abs_err="
          f"{flash_err!r} (bound 2e-5; chunked and naive plain)")
    if not (rel <= 2e-2 and pre == want and full == want
            and dec == (0, 0, 0) and n_seen == 2 * OLMOE_LAYERS
            and bool(torch.isfinite(lg_full).all())):
        raise AssertionError("OLMoE's teacher-forced decode and its full "
                             "prefill disagree, or the kernels were not "
                             "taken")
    del params
    return pre[1] + full[1]


def mla_full_phase():
    """One MLA layer at DeepSeek-V3's widths (d 7168, 128 heads, q rank
    1536, kv rank 512, nope 128, rope 64, v 128), float32, seeded
    parameters and input, B 1, S MLA_LEN (past FLASH_THRESHOLD): the
    chunked branch (``_mla_flash``) against the dense one (the threshold
    raised for that call), and the absorbed decode of the last MLA_DECODE
    positions, one at a time from a latent cache of the first MLA_LEN -
    MLA_DECODE, against the dense branch's output there; each within
    relative 1e-4.  Plain PyTorch: no kernel of the port runs."""
    torch.cuda.empty_cache()
    cfg = get_config("deepseek_v3_671b").scaled(dtype="float32",
                                                param_dtype="float32")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    params = init_params(g, mla.mla_specs(cfg))
    S, n = MLA_LEN, MLA_DECODE
    x = torch.randn((1, S, cfg.d_model), generator=g, device="cuda")
    pos = torch.arange(S, device="cuda")
    saved = mla.FLASH_THRESHOLD
    torch.cuda.reset_peak_memory_stats()
    _reset_model_counts()
    with torch.inference_mode():
        try:
            mla.FLASH_THRESHOLD = S
            dense_ms = _time_ms(lambda: mla.mla_attention(params, cfg, x,
                                                          pos), reps=2)
            want, _ = mla.mla_attention(params, cfg, x, pos)
        finally:
            mla.FLASH_THRESHOLD = saved
        assert S > mla.FLASH_THRESHOLD
        flash_ms = _time_ms(lambda: mla.mla_attention(params, cfg, x, pos),
                            reps=2)
        got, _ = mla.mla_attention(params, cfg, x, pos)
        chunked_rel = _rel(got, want)
        del got
        P = S - n
        _, pc = mla.mla_attention(params, cfg, x[:, :P], pos[:P],
                                  return_cache=True)
        cache = {k: torch.zeros((1, S) + v.shape[2:], device="cuda")
                 for k, v in pc.items()}
        for k in cache:
            cache[k][:, :P] = pc[k]
        del pc
        outs = []
        t0 = time.perf_counter()
        for i in range(P, S):
            o, cache = mla.mla_attention(params, cfg, x[:, i:i + 1],
                                         pos[i:i + 1], cache=cache,
                                         cache_len=i)
            outs.append(o)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n
        decode_rel = _rel(torch.cat(outs, 1), want[:, P:])
    peak = torch.cuda.max_memory_allocated()
    print(f"MLA at DeepSeek-V3's widths (one layer, float32, B 1, S {S}, "
          f"FLASH_THRESHOLD {saved}): dense_branch_ms={dense_ms!r} "
          f"chunked_branch_ms={flash_ms!r} chunked-vs-dense rel="
          f"{chunked_rel!r} (bound 1e-4); absorbed decode of the last {n} "
          f"positions from a latent cache of {P}: ms_per_step={step_ms!r} "
          f"rel={decode_rel!r} against the dense branch (bound 1e-4); "
          f"peak_memory_bytes={peak} launches {_model_counts()}")
    if not (chunked_rel <= 1e-4 and decode_rel <= 1e-4
            and _model_counts() == (0, 0, 0)
            and bool(torch.isfinite(want).all())):
        raise AssertionError("MLA's branches disagree at full width")
    del params, x, want, cache, outs
    return dense_ms, flash_ms


def deepseek_serve_phase():
    """DeepSeek-V3 at full width, its depth cut to DEEPSEEK_DEPTH (3 dense
    MLA layers, 1 MLA-MoE layer with all 256 routed experts and the shared
    one, and the multi-token-prediction module's parameters: 15.8 billion
    bfloat16 parameters, as its config stores them; 671.7 billion, 1.34
    TB, do not fit one card), served through ``launch/serve.py::serve``
    (the launcher has no depth flag): batch 1 of a DEEPSEEK_SERVE prompt
    (past FLASH_THRESHOLD: the chunked MLA branch), one untimed warm-up
    run first; counts set to 0 just before and read just after: no kernel
    launched (MLA and the experts are plain PyTorch); tokens in the
    vocabulary, peak memory under 80 GB, capacities 144 in prefill and 1
    in decode."""
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    full = get_config("deepseek_v3_671b")
    cfg = full.scaled(n_layers=DEEPSEEK_DEPTH)
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(params)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    B, S, gen = (DEEPSEEK_SERVE[k] for k in ("batch", "prompt", "gen"))
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                         device="cuda")
    _reset_model_counts()
    with _Capacities() as caps:
        serve_launch.serve(cfg, params, toks, gen)
        torch.cuda.reset_peak_memory_stats()
        res = serve_launch.serve(cfg, params, toks, gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = _model_counts()
    want_caps = {moe.capacity(cfg, B * S), moe.capacity(cfg, B)}
    print(f"serve ({cfg.name} at depth {DEEPSEEK_DEPTH}, bf16 parameters "
          f"and compute, batch {B}, prompt {S}, {gen} new tokens): "
          f"params={n_params} init_s={init_s!r} prefill_s="
          f"{res['prefill_s']!r} prompt_tokens_per_s="
          f"{res['prompt_tokens_per_s']!r} decode_ms_p50="
          f"{res['decode_ms_p50']!r} decode_ms_p95={res['decode_ms_p95']!r} "
          f"generated_tokens_per_s={res['generated_tokens_per_s']!r} "
          f"launches_per_prefill={res['prefill_launches']} "
          f"launches_in_decode={res['decode_launches']} run_launches (ssd, "
          f"flash, flash_wgmma)={counts} peak_memory_bytes={peak} "
          f"resident_before_bytes={resident} expert capacities (slots per "
          f"expert: calls)={dict(caps.seen)}")
    print(f"  reduced: n_layers {full.n_layers} -> {DEEPSEEK_DEPTH} (1.34 TB "
          "of parameters do not fit one card)")
    print(f"  decode ms per token: {res['decode_ms']}")
    toks_out = res["tokens"]
    if not (n_params == DEEPSEEK_DEPTH4_PARAMS and counts == (0, 0, 0)
            and set(caps.seen) == want_caps == {144, 1}
            and toks_out.shape == (B, gen)
            and bool(torch.isfinite(res["logits"]).all())
            and int(toks_out.min()) >= 0
            and int(toks_out.max()) < cfg.vocab_size and peak < 80e9):
        raise AssertionError("implausible DeepSeek-V3 serving output")
    del params, res


def flash_whisper_phase():
    """Both flash kernels at Whisper-large-v3's served attention, both
    non-causal with H = KV = 20 and D 64 (:func:`_flash_served`): the
    encoder's self-attention (FLASH_WHISPER_ENC, Sq = Sk = 1500, a last
    key tile of 92 keys) and the decoder's cross-attention over it
    (FLASH_WHISPER_CROSS, Sq 224, Sk 1500), SDPA (no mask) computing the
    same function; then float32 at one clip (one row tile a warp) with V
    coherent along the keys (mean 2, as the encoder's values run), where
    the kernel's per-8-key partials of P V hold 2e-5 and truncated sums
    taken straight into O drifted past it.  Returns {kind: max abs
    error}."""
    err = {"f32": 0.0, "wgmma": 0.0}
    _flash_served(err, ((FLASH_WHISPER_ENC, [(False, 0, 0.0)],
                         "Whisper-large-v3 encoder"),
                        (FLASH_WHISPER_CROSS, [(False, 0, 0.0)],
                         "Whisper-large-v3 cross-attention")))
    q, k, v = _flash_inputs(1, 1500, 1500, 20, 20, 64, torch.float32)
    e, _ = _check_flash(q, k, 2.0 + 0.5 * v, False, 0, 0.0,
                        flash_kernel.flash_attention_cuda,
                        "float32 (1, 1500, 1500, 20, 20, 64), coherent V")
    err["f32"] = max(err["f32"], e)
    print(f"flash_attention_mma float32 (B=1, Sq=Sk=1500, H=KV=20, D=64, "
          f"non-causal), V of mean 2: max_abs_err={e!r} (bound 2e-5; "
          "chunked and naive plain)")
    return err


def encdec_smoke_phase():
    """Whisper's smoke config on the card against the port on the CPU
    (:func:`_parity_run`): at its 16 frames (the decoder's self-attention
    takes the kernel at S 300), and at 320 frames, where the encoder and
    the cross-attention take it too."""
    _parity_run("whisper_large_v3")
    _parity_run("whisper_large_v3", encoder_seq=320)


def _spec_count(cfg):
    """Parameters of ``cfg``'s full tree, from its specs (no allocation)."""
    return sum(int(np.prod(p.shape)) for p in tree_leaves(model_specs(cfg)))


def whisper_consistency_phase():
    """Whisper-large-v3 at full width and depth in float32 compute, one
    clip of 1500 seeded frames and WHISPER_PROMPT prompt tokens: the
    prefill's last-position logits against the last of WHISPER_PROMPT
    teacher-forced decode steps from an empty self cache with
    ``encdec_prepare``'s cross K/V, within relative 2e-2 (the JAX
    package's bound for decode against a full forward); those cross K/V
    against the prefill's cross cache within 1e-5.  Every float32 flash
    launch (the prefill's 32 encoder and 32 cross-attention launches,
    ``encdec_prepare``'s 32 encoder launches) is recorded and held within
    2e-5 of the chunked plain version and the naive oracle on its own
    inputs.  Counts set to 0 just before the prefill; returns the float32
    flash launches."""
    torch.cuda.empty_cache()
    cfg = get_config("whisper_large_v3").scaled(dtype="float32")
    params = init_model(cfg, seed=0)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    P = WHISPER_PROMPT
    toks = torch.randint(0, cfg.vocab_size, (1, P), generator=g,
                         device="cuda")
    frames = torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=g,
                         device="cuda") * 0.1
    seen, kernel = [], flash_kernel.flash_attention_cuda

    def recorded(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        seen.append((q.clone(), k.clone(), v.clone(), kw, out.clone()))
        return out

    flash_ops.forward_kernel = _routed_to(recorded)
    _reset_model_counts()
    try:
        with torch.inference_mode():
            t0 = time.perf_counter()
            lg_pre, pcache = prefill(params, cfg, {"tokens": toks,
                                                   "frames": frames}, P)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            pre = _model_counts()
            enc, cross = encdec_prepare(params, cfg, frames)
            torch.cuda.synchronize()
            prep = tuple(x - y for x, y in zip(_model_counts(), pre))
    finally:
        flash_ops.forward_kernel = flash_kernel.forward_kernel
    with torch.inference_mode():
        n_seen, flash_err = len(seen), _recorded_flash_err(seen)
        del seen
        cross_rel = max(_rel(cross[w], pcache["decoder"]["cross"][w])
                        for w in ("k", "v"))
        cross_same = all(torch.equal(cross[w], pcache["decoder"]["cross"][w])
                         for w in ("k", "v"))
        del pcache
        cache = init_cache(cfg, 1, P, dtype=torch.float32)
        cache["decoder"]["cross"] = cross
        before = _model_counts()
        t0 = time.perf_counter()
        for i in range(P):
            lg_dec, cache = decode_step(params, cfg, toks[:, i:i + 1], cache,
                                        i, {"enc": enc})
        torch.cuda.synchronize()
        tf_s = time.perf_counter() - t0
    dec = tuple(x - y for x, y in zip(_model_counts(), before))
    rel = _rel(lg_pre[:, -1], lg_dec[:, -1])
    same = bool(torch.equal(lg_pre[:, -1, :cfg.vocab_size].argmax(-1),
                            lg_dec[:, -1, :cfg.vocab_size].argmax(-1)))
    L, E = cfg.n_layers, cfg.n_encoder_layers
    print(f"Whisper consistency (Whisper-large-v3, float32 compute, "
          f"{_spec_count(cfg)} parameters, 1 clip x {cfg.encoder_seq} "
          f"frames, {P} prompt tokens): prefill_s={prefill_s!r} launches "
          f"(ssd, flash, flash_wgmma) prefill={pre} encdec_prepare={prep} "
          f"decode={dec}; encdec_prepare cross K/V against the prefill's "
          f"cross cache rel={cross_rel!r} (bound 1e-5) bitwise_equal="
          f"{cross_same}; teacher-forced decode {tf_s!r} s; last-logits "
          f"rel={rel!r} (bound 2e-2) same_argmax={same}; float32 flash "
          f"kernel on its {n_seen} recorded launches: max_abs_err="
          f"{flash_err!r} (bound 2e-5; chunked and naive plain)")
    if not (rel <= 2e-2 and cross_rel <= 1e-5 and pre == (0, E + L, 0)
            and prep == (0, E, 0) and dec == (0, 0, 0)
            and n_seen == 2 * E + L and bool(torch.isfinite(lg_pre).all())):
        raise AssertionError("Whisper's prefill and its teacher-forced "
                             "decode disagree, or the kernels were not "
                             "taken")
    del params, cache, cross, enc
    return pre[1] + prep[1]


def whisper_serve_phase():
    """The enc-dec family's main path (:func:`_serve_run`):
    Whisper-large-v3 at full width and depth (WHISPER_PARAMS float32
    parameters, counted from its specs), batch 8 clips of 1500 frames,
    prompt 224, 32 new tokens: 64 tensor-core flash launches a prefill
    (32 encoder self-attentions, 32 cross-attentions; the decoder's
    224 x 224 self-attention takes the naive branch), none in decode.
    Returns those launches."""
    n = _spec_count(get_config("whisper_large_v3"))
    print(f"Whisper-large-v3: {n} parameters (expected {WHISPER_PARAMS})")
    if n != WHISPER_PARAMS:
        raise AssertionError(f"Whisper-large-v3 has {n} parameters")
    return _serve_run("whisper_large_v3", WHISPER_SERVE, 0, WHISPER_FLASH)[2]


def _solo_decode(params, cfg, prompt, max_new, max_len):
    """One request alone on the card through ``decode_step`` with an int
    ``cache_len`` (the JAX package's test loop), the argmax over the full
    logits row as the batcher takes it: (tokens, each output step's
    top-two logit margin over the row's largest magnitude)."""
    cache = init_cache(cfg, 1, max_len, dtype=torch.float32)
    toks = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                           device="cuda")[None]
    out, margins, cur = [], [], None
    with torch.inference_mode():
        for i in range(len(prompt) + max_new - 1):
            t = toks[:, i:i + 1] if i < len(prompt) else cur
            lg, cache = decode_step(params, cfg, t, cache, i)
            if i >= len(prompt) - 1:
                row = lg[0, 0]
                top = torch.topk(row, 2).values
                margins.append(float((top[0] - top[1]) / row.abs().max()))
                cur = torch.argmax(row).reshape(1, 1)
                out.append(int(cur))
                if len(out) >= max_new:
                    break
    return out, margins


def batcher_phase():
    """The second entry, ``repro_torch.serve.batcher.ContinuousBatcher``,
    over ``decode_step`` with a (B,) ``cache_len`` on the card, at full
    width on StarCoder2-3B (the JAX package's batcher test's
    architecture), float32 compute, TF32 off: BATCHER_ROWS rows,
    BATCHER_REQUESTS requests from a numpy generator seeded 0 (prompts
    of BATCHER_PROMPT tokens, BATCHER_NEW new ones), counts set to 0 just
    before the run and read just after (plain PyTorch: no kernel).  Every
    request finishes; rows are reused (each later request starts the step
    after a row frees; fewer steps than the serial sum); each request's
    tokens equal the same request decoded alone, where a differing token
    is a fault unless the solo run's top-two margin there is under 1e-4
    of the row's largest logit (then the rest of that request is not
    compared).  Prints the steps, the step p50/p95 and the tokens a
    second."""
    torch.cuda.empty_cache()
    cfg = get_config("starcoder2_3b").scaled(dtype="float32")
    params = init_model(cfg, seed=0)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(BATCHER_REQUESTS):
        n = int(rng.integers(BATCHER_PROMPT[0], BATCHER_PROMPT[1] + 1))
        reqs.append(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                       size=n),
                            max_new=int(rng.integers(BATCHER_NEW[0],
                                                     BATCHER_NEW[1] + 1))))

    def decode_fn(t, c, n):
        with torch.inference_mode():
            return decode_step(params, cfg, t, c, n)

    cache = init_cache(cfg, BATCHER_ROWS, BATCHER_MAX_LEN,
                       dtype=torch.float32)
    bat = ContinuousBatcher(batch=BATCHER_ROWS, max_len=BATCHER_MAX_LEN,
                            decode_fn=decode_fn)
    for r in reqs:
        bat.submit(r)
    torch.cuda.synchronize()
    _reset_model_counts()
    step_ms = []
    t0 = time.perf_counter()
    while bat.queue or bat.active:
        ts = time.perf_counter()
        cache, _ = bat.step(cache)       # ends in the argmax's read-back
        step_ms.append((time.perf_counter() - ts) * 1e3)
    wall = time.perf_counter() - t0
    counts = _model_counts()
    generated = sum(len(r.output) for r in reqs)
    processed = sum(len(r.prompt) + len(r.output) - 1 for r in reqs)
    serial = sum(len(r.prompt) + r.max_new for r in reqs)
    finished = collections.Counter(r.finished_step for r in reqs)
    started = collections.Counter(r.started_step for r in reqs
                                  if r.started_step > 0)
    reused = bool(started) and all(started[s] <= finished[s - 1]
                                   for s in started)
    del cache
    allowed, worst, faults = [], float("inf"), []
    for r in reqs:
        solo, margins = _solo_decode(params, cfg, r.prompt, r.max_new,
                                     BATCHER_MAX_LEN)
        worst = min(worst, min(margins))
        for j, (a, b) in enumerate(zip(r.output, solo)):
            if a != b:
                if margins[j] < 1e-4:
                    allowed.append((r.rid, j, margins[j]))
                else:
                    faults.append((r.rid, j, a, b, margins[j]))
                break
        else:
            if len(r.output) != len(solo):
                faults.append((r.rid, len(r.output), len(solo)))
    print(f"batcher (StarCoder2-3B, float32, {BATCHER_ROWS} rows, "
          f"{BATCHER_REQUESTS} requests, prompts {BATCHER_PROMPT}, new "
          f"{BATCHER_NEW}): steps={bat.step_no} (serial sum {serial}) "
          f"done={len(bat.done)} rows_reused={reused} starts="
          f"{sorted(r.started_step for r in reqs)} step_ms_p50="
          f"{float(np.percentile(step_ms, 50))!r} step_ms_p95="
          f"{float(np.percentile(step_ms, 95))!r} wall_s={wall!r} "
          f"generated_tokens_per_s={generated / wall!r} "
          f"processed_tokens_per_s={processed / wall!r} launches (ssd, "
          f"flash, flash_wgmma)={counts}; against solo decodes: smallest "
          f"top-two margin {worst!r} of the row's largest logit, near-tie "
          f"allowances used {allowed}")
    if faults or not (len(bat.done) == BATCHER_REQUESTS and reused
                      and bat.step_no < serial and counts == (0, 0, 0)):
        raise AssertionError(f"the batcher differs from solo decoding or "
                             f"did not batch: {faults}")
    del params


def per_row_phase():
    """One ``decode_step`` with an unequal (B,) ``cache_len`` on the smoke
    configs of every family with an attention cache (PER_ROW: StarCoder2,
    Gemma2-9B with a row past its 32-slot local cache, OLMoE at
    ``capacity_factor = n_experts``, DeepSeek-V3's MLA, Zamba2), float32,
    over a seeded random cache: the card against the port on the CPU,
    logits and every cache leaf within relative 1e-4; then Whisper's
    refusal of a (B,) ``cache_len`` on the card."""
    worst = 0.0
    for arch, changes, lengths in PER_ROW:
        cfg = get_smoke(arch).scaled(dtype="float32", param_dtype="float32",
                                     **changes)
        cpu_params = init_model(cfg, seed=3, device="cpu")
        gpu_params = tree_map(lambda t: t.cuda(), cpu_params,
                              lambda t: isinstance(t, torch.Tensor))
        B = len(lengths)
        c_cpu = init_cache(cfg, B, 48, dtype=torch.float32, device="cpu")
        g = torch.Generator()
        g.manual_seed(8)
        for leaf in _leaves(c_cpu):
            leaf.copy_(torch.randn(leaf.shape, generator=g))
        c_gpu = tree_map(lambda t: t.cuda(), c_cpu,
                         lambda t: isinstance(t, torch.Tensor))
        tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=g)
        n = torch.tensor(lengths)
        with torch.inference_mode():
            a, c_cpu = decode_step(cpu_params, cfg, tok, c_cpu, n)
            b, c_gpu = decode_step(gpu_params, cfg, tok.cuda(), c_gpu,
                                   n.cuda())
        torch.cuda.synchronize()
        rels = [_rel(b, a)] + [_rel(x, y) for x, y in zip(_leaves(c_gpu),
                                                         _leaves(c_cpu))]
        print(f"per-row decode ({cfg.name}, float32, cache_len "
              f"{list(lengths)}): logits rel={rels[0]!r}, max cache-leaf "
              f"rel={max(rels[1:])!r} over {len(rels) - 1} leaves")
        worst = max(worst, *rels)
    cfg = get_smoke("whisper_large_v3").scaled(dtype="float32")
    params = init_model(cfg, seed=3)
    try:
        decode_step(params, cfg, torch.zeros((2, 1), dtype=torch.int64,
                                             device="cuda"),
                    init_cache(cfg, 2, 8), torch.tensor([0, 3],
                                                        device="cuda"))
    except NotImplementedError as e:
        print(f"per-row decode (Whisper): refused as in the reference: {e}")
    else:
        raise AssertionError("Whisper took a per-row cache_len")
    if worst > 1e-4:
        raise AssertionError(f"per-row decode on the card differs from the "
                             f"CPU: rel {worst!r}")


def _stage_device_ms(prof, names):
    """{range name: device ms of the kernels launched inside it}, over the
    profile's CPU op tree (each kernel belongs to the op that launched it)."""
    def dev(e):
        return (sum(k.duration for k in e.kernels)
                + sum(dev(c) for c in e.cpu_children))
    out = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.name in out and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.name] += dev(e) / 1e3
    return out


class _MoeStages:
    """While active, runs ``moe._dispatch`` (rank sort, scatter),
    ``moe._combine`` (gather, weighting, the k-sum) and ``moe._experts``
    (the three batched expert products) inside named profiler ranges."""
    NAMES = {"_dispatch": "moe_stage:dispatch",
             "_combine": "moe_stage:combine",
             "_experts": "moe_stage:experts"}

    def __enter__(self):
        from torch.profiler import record_function
        self._orig = {k: getattr(moe, k) for k in self.NAMES}
        for k, label in self.NAMES.items():
            def wrapped(*a, _f=self._orig[k], _label=label, **kw):
                with record_function(_label):
                    return _f(*a, **kw)
            setattr(moe, k, wrapped)
        return self

    def __exit__(self, *exc):
        for k, f in self._orig.items():
            setattr(moe, k, f)


def _moe_share(prof, busy, what):
    """Print the MoE stages' device ms in a profile taken under
    :class:`_MoeStages`: the dispatch (rank sort and scatter, then gather
    and combine) against the expert products, each as a share of the
    device busy time ``busy``."""
    st = _stage_device_ms(prof, _MoeStages.NAMES.values())
    disp = st["moe_stage:dispatch"] + st["moe_stage:combine"]
    prod = st["moe_stage:experts"]
    print(f"  MoE stages ({what}): dispatch_ms={disp!r} (sort and scatter "
          f"{st['moe_stage:dispatch']!r}, gather and combine "
          f"{st['moe_stage:combine']!r}) expert_products_ms={prod!r}; "
          f"shares of device busy: dispatch {disp / busy!r}, products "
          f"{prod / busy!r}; dispatch / products "
          f"{disp / prod if prod else float('nan')!r}")


def serve_profile_phase(arch="zamba2_7b", dims=SERVE, steps=4):
    """Where the serving time goes at full width (bf16; ``dims``: batch,
    prompt; Whisper's frames seeded after the prompt): one traced prefill (device busy, idle share, the kernels'
    device time, the top device ops), then ``steps`` traced decode steps;
    for an MoE model, the expert dispatch's device time against the
    expert products' in each."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    stages = _MoeStages() if cfg.n_experts else contextlib.nullcontext()
    params = init_model(cfg, seed=0)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    S = dims["prompt"]
    toks = torch.randint(0, cfg.vocab_size, (dims["batch"], S),
                         generator=g, device="cuda")
    frames = (torch.randn((dims["batch"], cfg.encoder_seq, cfg.d_model),
                          generator=g, device="cuda") * 0.1
              if cfg.family == "encdec" else None)
    serve_steps.prefill_into_cache(params, cfg, toks, S + 1, frames=frames)
    torch.cuda.synchronize()
    with stages, profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, cache = serve_steps.prefill_into_cache(
            params, cfg, toks, S + dims["gen"], frames=frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = _device_table(prof)
    busy = sum(v[0] for v in dev.values())
    kern = {name: tuple(map(sum, zip(*([v for k, v in dev.items()
                                        if name in k] or [(0.0, 0)]))))
            for name in ("ssd_mma_kernel", "flash_wgmma_kernel",
                         "flash_mma_kernel")}
    print(f"profile (one {cfg.name} prefill, bf16, batch {dims['batch']}, "
          f"prompt {S}, traced): wall_ms={wall_ms!r} device_busy_ms={busy!r}"
          f" device_idle_share={1.0 - busy / wall_ms!r} " + " ".join(
              f"{k}_ms={v[0]!r} {k}_launches={v[1]}"
              for k, v in kern.items()))
    for k, (ms, n) in sorted(dev.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  device {ms!r} ms ({n} launches): {k[:90]}")
    if cfg.n_experts:
        _moe_share(prof, busy, "prefill")
    tok = serve_steps.greedy(logits, cfg)
    with stages, profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.inference_mode():
            for i in range(steps):
                logits, cache = decode_step(params, cfg, tok, cache, S + i)
                tok = serve_steps.greedy(logits, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = _device_table(prof)
    busy = sum(v[0] for v in dev.values())
    launches = sum(v[1] for v in dev.values())
    print(f"profile ({steps} {cfg.name} decode steps, bf16, batch "
          f"{dims['batch']}, traced): wall_ms_per_step={wall_ms / steps!r} "
          f"device_busy_ms_per_step={busy / steps!r} device_idle_share="
          f"{1.0 - busy / wall_ms!r} device_launches_per_step="
          f"{launches / steps!r}")
    for k, (ms, n) in sorted(dev.items(), key=lambda kv: -kv[1][0])[
            :8 if cfg.n_experts else 5]:
        print(f"  device {ms!r} ms ({n} launches): {k[:90]}")
    if cfg.n_experts:
        _moe_share(prof, busy, f"{steps} decode step(s)")
    del params, cache
    return kern


def _flash_bwd_bounds(B, Sq, Sk, H, KV, D, causal, window, dtype):
    """(ms over the tensor cores' peak, ms over HBM) for one backward: the
    five products of the function (S = Q K^T recomputed, dP = dO V^T, dV
    = P^T dO, dQ = dS K, dK = dS^T Q) over the visible (query, key) pairs
    of this mask, two operations per multiply-add, at the bf16 rate or,
    for float32, as three TF32 passes (the card's fastest route at
    float32's accuracy, as the forward rows count theirs); q, k, v, o and
    dO read once, dq, dk and dv written once."""
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), bool)
    if causal:
        vis &= qp >= kp
    if window > 0:
        vis &= qp - kp < window
    ops = 5 * 2.0 * B * H * int(vis.sum()) * D
    tc = (3 * ops / PEAK_TF32 if dtype == torch.float32
          else ops / PEAK_OPS[torch.bfloat16])
    nbytes = (4 * B * Sq * H * D + 4 * B * Sk * KV * D) * dtype.itemsize
    return tc * 1e3, nbytes / PEAK_BYTES * 1e3


def _flash_bwd_inputs(B, Sq, Sk, H, KV, D, dtype, seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + B * Sq + H * D + KV + Sk)
    return tuple(torch.randn(sh, generator=g, device="cuda").to(dtype)
                 for sh in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D),
                            (B, Sq, H, D)))


def _plain_flash_grads(q, k, v, do, causal, window, cap):
    """The plain version's gradients: ``attention_ref`` on the inputs
    upcast to float32, differentiated by autograd with dO upcast too."""
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    o = attention_ref(qf, kf, vf, causal=causal, window=window,
                      softcap=cap)
    return torch.autograd.grad(o, (qf, kf, vf), do.float())


def _bwd_o(q, k, v, causal, window, cap):
    """The backward's ``o``: the float32 forward kernel's output, None
    for bfloat16 (whose backward recomputes it)."""
    if q.dtype != torch.float32:
        return None
    return flash_kernel.flash_attention_cuda(q, k, v, causal=causal,
                                             window=window, softcap=cap)


def _held_bwd(q, k, v, o, do, causal, window, cap, case):
    """One backward launch on (q, k, v, o, dO) held to the plain
    version's float32 autograd gradients: each gradient's relative norm
    error within FLASH_BWD_REL of its dtype.  Returns (max abs error,
    largest relative norm error)."""
    got = flash_kernel.flash_attention_bwd_cuda(
        q, k, v, o, do, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    want = _plain_flash_grads(q, k, v, do, causal, window, cap)
    e = r = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == q.dtype and g.shape == w.shape, (case, name)
        assert bool(torch.isfinite(g).all()), f"flash bwd {case}: {name}"
        rel = float((g.float() - w).norm() / w.norm())
        assert rel <= FLASH_BWD_REL[q.dtype], (
            f"flash bwd {case}: {name} rel_norm_err {rel!r} > "
            f"{FLASH_BWD_REL[q.dtype]}")
        e, r = max(e, float((g.float() - w).abs().max())), max(r, rel)
    return e, r


def _sdpa_bwd_ms(q, k, v, do, causal, reps):
    """Device ms of the backward of torch's scaled_dot_product_attention
    (a yardstick the port never calls) on the same inputs, K and V
    repeated to every head before the forward where KV < H, the forward
    outside the timing."""
    H, KV = q.shape[2], k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if KV < H:
        kt, vt = (t.repeat_interleave(H // KV, dim=1) for t in (kt, vt))
    leaves = [t.requires_grad_() for t in (qt, kt, vt)]
    o = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=causal)
    dot = do.transpose(1, 2).contiguous()
    return _device_ms(lambda: torch.autograd.grad(o, leaves, dot,
                                                  retain_graph=True), reps)


def flash_bwd_phase():
    """The flash-attention backward kernel (``csrc/flash_attention_bwd.cu``)
    against the plain version's autograd gradients on the card, the
    forward kernel's O given it as ``FlashAttention`` saves it: both
    dtypes x FLASH_BWD_CASES (causal, window, soft-cap, GQA 24/2,
    non-causal Sq 224 x Sk 1500, ragged S) x every head dim, each
    gradient's relative norm error within FLASH_BWD_REL.  Then timed at
    FLASH_BWD_TIMED: device ms per launch, the plain version's backward
    (autograd through ``attention_ref``, its forward outside the timing),
    the bound (:func:`_flash_bwd_bounds`) and, for the uncapped,
    unwindowed shapes, SDPA's backward.  Returns (max abs error, largest
    relative norm error per dtype, StarCoder2-3B's bf16 timing tuple
    (kernel, plain, bound, tensor-core ms, bytes ms), its SDPA ms)."""
    e_max, worst = 0.0, {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for label, (B, Sq, Sk, H, KV), causal, window, cap in FLASH_BWD_CASES:
            for D in flash_kernel.WGMMA_HEAD_DIMS:
                q, k, v, do = _flash_bwd_inputs(B, Sq, Sk, H, KV, D, dtype)
                o = _bwd_o(q, k, v, causal, window, cap)
                e, r = _held_bwd(q, k, v, o, do, causal, window, cap,
                                 f"{label} D={D} {dtype}")
                e_max, worst[dtype] = max(e_max, e), max(worst[dtype], r)
    print("flash_attention_bwd: "
          f"{2 * len(FLASH_BWD_CASES) * len(flash_kernel.WGMMA_HEAD_DIMS)} "
          "cases (float32, bfloat16 x causal, window 64, soft-cap 50, GQA "
          "24/2, non-causal Sq 224 x Sk 1500, ragged S 77 x D 16/64/112/"
          "128/256) against the plain version's float32 autograd gradients:"
          f" max_abs_err={e_max!r} rel_norm_err float32={worst[torch.float32]!r}"
          f" (bound {FLASH_BWD_REL[torch.float32]}) bfloat16="
          f"{worst[torch.bfloat16]!r} (bound {FLASH_BWD_REL[torch.bfloat16]})",
          flush=True)
    row = lib_row = None
    for model, shape, causal, window, cap, dtypes in FLASH_BWD_TIMED:
        B, Sq, Sk, H, KV, D = shape
        for dtype in dtypes:
            q, k, v, do = _flash_bwd_inputs(B, Sq, Sk, H, KV, D, dtype)
            o = _bwd_o(q, k, v, causal, window, cap)
            case = (f"{model} (B={B}, Sq={Sq}, Sk={Sk}, H={H}, KV={KV}, "
                    f"D={D}, {'causal' if causal else 'non-causal'}, "
                    f"window={window}, cap={cap}) "
                    f"{str(dtype).split('.')[-1]}")
            e, r = _held_bwd(q, k, v, o, do, causal, window, cap, case)
            e_max = max(e_max, e)
            worst[dtype] = max(worst[dtype], r)
            k_ms = _device_ms(lambda: flash_kernel.flash_attention_bwd_cuda(
                q, k, v, o, do, causal=causal, window=window, softcap=cap),
                3)
            qf, kf, vf = (t.detach().float().requires_grad_()
                          for t in (q, k, v))
            of = attention_ref(qf, kf, vf, causal=causal, window=window,
                               softcap=cap)
            dof = do.float()
            p_ms = _time_ms(lambda: torch.autograd.grad(
                of, (qf, kf, vf), dof, retain_graph=True), reps=2)
            del qf, kf, vf, of, dof
            tc_ms, byte_ms = _flash_bwd_bounds(*shape, causal, window, dtype)
            lib = (_sdpa_bwd_ms(q, k, v, do, causal, 3)
                   if not window and not cap else None)
            t = (k_ms, p_ms, max(tc_ms, byte_ms), tc_ms, byte_ms)
            if model == "StarCoder2-3B" and dtype == torch.bfloat16:
                row, lib_row = t, lib
            print(f"flash_attention_bwd {case}: max_abs_err={e!r} "
                  f"rel_norm_err={r!r} (bound {FLASH_BWD_REL[dtype]}) "
                  f"kernel_device_ms={k_ms!r} plain_ms={p_ms!r} (autograd "
                  f"through attention_ref, backward only) bound_ms="
                  f"{t[2]!r} (tensor-core operations {tc_ms!r} ms, five "
                  "products, " + ("TF32 x 3 at " + f"{PEAK_TF32:.3g}"
                                  if dtype == torch.float32 else
                                  f"at {PEAK_OPS[torch.bfloat16]:.3g}")
                  + f" op/s; bytes {byte_ms!r} ms) library_ms (SDPA "
                  f"backward)={lib!r}", flush=True)
            del q, k, v, o, do
            torch.cuda.empty_cache()
    return e_max, worst, row, lib_row


def _bwd_counts():
    """(float32 flash, bfloat16 flash, flash backward) launches so far."""
    return (flash_kernel.flash_attention_cuda.launches,
            flash_kernel.flash_attention_wgmma.launches,
            flash_kernel.flash_attention_bwd_cuda.launches)


def _reset_bwd_counts():
    _reset_model_counts()
    flash_kernel.flash_attention_bwd_cuda.launches = 0


def _grad_rel(got, want):
    """Relative max-abs error of one gradient leaf (0 where both are 0)."""
    scale = float(want.abs().max())
    err = float((got.cpu() - want).abs().max())
    return err / scale if scale else err


def _ssd_refuses_a_gradient():
    """``ssd_chunked`` on CUDA inputs that require a gradient raises
    NotImplementedError (the SSD kernel has no backward yet) and launches
    nothing; under ``no_grad`` the same call launches the kernel once."""
    from repro_torch.models.mamba2 import ssd_chunked
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    b, L, H, P, G, N = 1, 64, 2, 16, 1, 16
    x = torch.randn(b, L, H, P, generator=g, device="cuda")
    dt = torch.rand(b, L, H, generator=g, device="cuda")
    A = -torch.rand(H, generator=g, device="cuda")
    B = torch.randn(b, L, G, N, generator=g, device="cuda")
    C = torch.randn(b, L, G, N, generator=g, device="cuda")
    n = ssd_kernel.ssd_cuda.launches
    try:
        ssd_chunked(x.requires_grad_(), dt, A, B, C, 16)
    except NotImplementedError as e:
        assert "next slice" in str(e), e
    else:
        raise AssertionError("ssd_chunked ran on CUDA inputs that need a "
                             "gradient")
    assert ssd_kernel.ssd_cuda.launches == n
    with torch.no_grad():
        y, _ = ssd_chunked(x, dt, A, B, C, 16)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_cuda.launches == n + 1 and y.shape == (b, L, H, P)
    print("ssd_chunked on CUDA inputs that require a gradient: "
          "NotImplementedError, no launch (one under no_grad)", flush=True)


def train_tiny_phase():
    """The reference test's TINY trained on the card (float32, seq 512:
    the chunked branch, so every layer's attention is one float32 flash
    forward launch and one backward launch a step): first the first
    step's loss and gradients on the card held to the port's own CPU run
    of the same step (loss relative 1e-5, each gradient leaf relative
    max-abs 1e-4), then TINY_TRAIN["steps"] steps of ``make_train_step``
    from the seeded data pipeline with the counts set to 0 just before
    and read just after: 2 forward and 2 backward launches a step, and
    the CE of the last 5 steps under 0.8 x the first 5's.  First of all,
    ``ssd_chunked``'s refusal of a gradient on the card
    (:func:`_ssd_refuses_a_gradient`).  Returns the backward launches."""
    _ssd_refuses_a_gradient()
    data = DataConfig(vocab_size=TINY.vocab_size, seq_len=TINY_TRAIN["seq"],
                      global_batch=TINY_TRAIN["batch"], seed=0, n_chunks=64)
    host = init_model(TINY, seed=0, device="cpu")
    params = tree_map(lambda x: x.cuda(), host,
                      lambda x: isinstance(x, torch.Tensor))
    first = DataPipeline(data).next_batch()
    cpu_b = {k: torch.as_tensor(v).long() for k, v in first.items()}
    dev_b = {k: v.cuda() for k, v in cpu_b.items()}
    want_m, want_g = value_and_grad(host, TINY, cpu_b, TrainHyper())
    got_m, got_g = value_and_grad(params, TINY, dev_b, TrainHyper())
    loss_rel = abs(float(got_m["loss"]) - float(want_m["loss"])) / abs(
        float(want_m["loss"]))
    g_rel = max(_grad_rel(g, w) for g, w in zip(got_g, want_g))
    assert loss_rel <= 1e-5, f"TINY first step: loss rel {loss_rel!r}"
    assert g_rel <= 1e-4, f"TINY first step: gradient rel {g_rel!r}"
    del got_g, want_g
    opt = init_opt(params, TINY_OPT)
    step = make_train_step(TINY, TINY_OPT, TrainHyper())
    pipe = DataPipeline(data)
    ces = []
    _reset_bwd_counts()
    t0 = time.perf_counter()
    for _ in range(TINY_TRAIN["steps"]):
        params, opt, m = step(params, opt, pipe.next_batch())
        ces.append(float(m["ce"]))
    wall = time.perf_counter() - t0
    f32, bf16, bwd = _bwd_counts()
    n = TINY_TRAIN["steps"] * TINY.n_layers
    assert (f32, bf16, bwd) == (n, 0, n), (f32, bf16, bwd)
    first5, last5 = float(np.mean(ces[:5])), float(np.mean(ces[-5:]))
    assert np.all(np.isfinite(ces)) and last5 < 0.8 * first5, (first5,
                                                               last5)
    print(f"train TINY (float32, batch {TINY_TRAIN['batch']} x "
          f"{TINY_TRAIN['seq']} tokens, {TINY_TRAIN['steps']} steps on the "
          f"card): first step against the CPU loss_rel={loss_rel!r} "
          f"grad_rel={g_rel!r} (bounds 1e-5, 1e-4); ce first5={first5!r} "
          f"last5={last5!r} (last5 < 0.8 x first5); flash launches: "
          f"forward float32 {f32}, backward {bwd}; wall_s={wall!r}",
          flush=True)
    return bwd


def train_phase(arch="starcoder2_3b", dims=STARCODER_TRAIN):
    """``arch`` trained at full width and depth through the launcher
    (``repro_torch.launch.train.train``: bfloat16 compute, float32
    parameters and moments, remat, AdamW, batches from the data
    pipeline), the counts set to 0 just before and read just after: per
    step one wgmma forward launch a layer, one more in its remat
    recompute and one backward launch.  The first step's backward
    launches are recorded (inputs copied to the host) and each is held,
    after the run, to the plain version's float32 autograd gradients
    within FLASH_BWD_REL[bfloat16].  The loss is finite and falls from
    the first step to the last.  Prints the step wall p50 (steps 2 on;
    the first records), tokens/s, model TFLOP/s (6 N tokens plus the
    attention's 12 B H (S (S + 1) / 2) D a layer, no remat) and the peak
    device memory.  Returns the backward launches."""
    cfg = get_config(arch)
    L = cfg.n_layers
    B, S, n_steps = dims["batch"], dims["seq"], dims["steps"]
    kernel, seen = flash_kernel.flash_attention_bwd_cuda, []

    def recorded(q, k, v, o, do, **kw):
        # stands in for the module's wrapper during the run: the wrapper
        # counts its launch on this function's ``launches``
        out = kernel(q, k, v, o, do, **kw)
        if len(seen) < L:
            seen.append(tuple(None if t is None else t.detach().cpu()
                              for t in (q, k, v, o, do))
                        + (kw,))
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_bwd_counts()
    recorded.launches = 0
    flash_kernel.flash_attention_bwd_cuda = recorded
    try:
        out = train_launch.train(arch, steps=n_steps, seq=S, batch=B,
                                 ckpt=os.path.join("chiprun_out",
                                                   "train_ckpt"))
        torch.cuda.synchronize()
    finally:
        flash_kernel.flash_attention_bwd_cuda = kernel
    kernel.launches += recorded.launches
    f32, bf16, bwd = _bwd_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    ces = out["ce"]
    assert (f32, bf16, bwd) == (0, 2 * L * n_steps, L * n_steps), (
        f32, bf16, bwd)
    assert np.all(np.isfinite(ces)) and ces[-1] < ces[0], ces
    assert len(seen) == L
    e_max = r_max = 0.0
    for q, k, v, o, do, kw in seen:
        e, r = _held_bwd(*(None if t is None else t.cuda()
                           for t in (q, k, v, o, do)),
                         kw["causal"], kw["window"], kw["softcap"],
                         f"{arch} training step 1")
        e_max, r_max = max(e_max, e), max(r_max, r)
    del seen
    n_params = _spec_count(cfg)
    p50 = float(np.median(out["step_seconds"][1:]))
    tokens = B * S
    attn = 12.0 * B * cfg.n_heads * (S * (S + 1) // 2) * cfg.head_dim * L
    tflops = (6.0 * n_params * tokens + attn) / p50 / 1e12
    print(f"train {arch} (full width and depth: {L} layers, d "
          f"{cfg.d_model}, {n_params} parameters; bfloat16 compute, float32 "
          f"parameters and moments, remat; batch {B} x {S} tokens, "
          f"{n_steps} steps): ce={ces!r}; step wall p50={p50!r} s (steps "
          f"2-{n_steps}; {out['step_seconds']!r}); tokens_per_s="
          f"{tokens / p50!r}; model_tflops={tflops!r} (6 N tokens + "
          f"attention {attn:.4g} flops a step); peak_gb={peak_gb!r}; "
          f"launches: wgmma forward {bf16} ({2 * L} a step with the remat "
          f"recomputes), backward {bwd} ({L} a step); step 1's {L} backward "
          f"launches against the plain gradients: max_abs_err={e_max!r} "
          f"rel_norm_err={r_max!r} (bound "
          f"{FLASH_BWD_REL[torch.bfloat16]})", flush=True)
    return bwd


def _train_steps(cfg, host, dims, device):
    """``dims["steps"]`` launcher steps of ``cfg`` on ``device`` from a
    copy of the host parameters ``host``; returns (CEs, parameters)."""
    params = tree_map(lambda x: x.to(device, copy=True), host,
                      lambda x: isinstance(x, torch.Tensor))
    opt_cfg = train_launch.launcher_opt(dims["steps"])
    opt = init_opt(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, TrainHyper(), device=device)
    pipe = DataPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=dims["seq"],
                                   global_batch=dims["batch"]))
    ces = []
    for _ in range(dims["steps"]):
        params, opt, m = step(params, opt, pipe.next_batch())
        ces.append(float(m["ce"]))
    return ces, params


def train_steps_phase(arch="starcoder2_3b", dims=STARCODER_STEPS):
    """Steps 2 on held as well as step 1: ``arch`` at full width and
    ``dims["layers"]`` layers trained on the card for ``dims["steps"]``
    steps of the launcher's AdamW (in place, remat, the flash forward and
    backward kernels), in float32 and in bfloat16 compute, against the
    port's float32 run on the host CPU from the same parameters and
    batches, within TRAIN_STEPS_REL."""
    small = get_config(arch).scaled(n_layers=dims["layers"])
    host = init_model(small, seed=0, device="cpu")
    want, want_p = _train_steps(small.scaled(dtype="float32"), host, dims,
                                "cpu")
    ce_rel = {}
    for dt in ("float32", "bfloat16"):
        got, got_p = _train_steps(small.scaled(dtype=dt), host, dims, "cuda")
        ce_rel[dt] = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        assert np.all(np.isfinite(got)), (dt, got)
        assert ce_rel[dt] <= TRAIN_STEPS_REL[f"ce_{dt}"], (dt, got, want)
        if dt == "float32":
            pairs = zip(tree_leaves(got_p, torch.is_tensor),
                        tree_leaves(want_p, torch.is_tensor))
            p_rel = max(float((g.cpu() - w).norm()
                              / w.norm().clamp(min=1e-30))
                        for g, w in pairs)
            assert p_rel <= TRAIN_STEPS_REL["param_float32"], p_rel
        del got_p
    torch.cuda.empty_cache()
    print(f"train {arch} steps held (full width, {dims['layers']} layers, "
          f"batch {dims['batch']} x {dims['seq']} tokens, "
          f"{dims['steps']} launcher steps, against the port's float32 run "
          f"on the host CPU): cpu ce={want!r}; card float32 ce max rel "
          f"{ce_rel['float32']!r}, parameters after the last step max rel "
          f"norm {p_rel!r}; card bfloat16 ce max rel {ce_rel['bfloat16']!r} "
          f"(bounds {TRAIN_STEPS_REL})", flush=True)


def _phase(fn, *args, **kw):
    """``fn(*args, **kw)``, its wall time printed after it: where the
    phases' time goes."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    label = " ".join([fn.__name__] + [str(a) for a in args
                                      if isinstance(a, str)]
                     + [f"{k}={v}" for k, v in kw.items()])
    print(f"phase {label}: wall_s={time.perf_counter() - t0!r}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = _card()
    print(card, flush=True)
    t_start = time.perf_counter()
    # the model phases compare float32 results: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    max_err, timings = _phase(kernel_phase)
    slot_err, slot_timings, a_launches = _phase(slot_phase)
    tile_err = _phase(tile_phase)
    plateau_err = _phase(plateau_tile_phase)
    dnc_err = _phase(dnc_tile_phase)
    paper = _phase(paper_phase)
    d_launches, dnc_tiles = _phase(dnc_engine_phase, paper)
    dnc_t = _phase(dnc_mix_phase, dnc_tiles)
    del dnc_tiles
    _phase(precision_phase)
    launches, hist, whole_utility = _phase(scale_phase)
    c_launches, b_launches, tile_shapes, plateau_tiles, one_lane = \
        _phase(tiled_scale_phase, whole_utility)
    lanes_err = _phase(tile_lanes_phase)
    l_launches, lane_shapes = _phase(burst_phase, one_lane)
    tile = _phase(tile_mix_phase, tile_shapes)
    tile8 = _phase(tile_mix_phase, lane_shapes, "8-lane run's own 10x mix")
    plat = _phase(plateau_mix_phase, plateau_tiles)
    del plateau_tiles
    _phase(wide_phase)
    _phase(serving_phase)
    _phase(churn_phase)
    _phase(stream_churn_phase)
    scen = _phase(scenario_phase)
    replays = _phase(learned_phase, paper)
    _phase(obs_phase, paper, one_lane, (c_launches, b_launches))
    _phase(profile_phase, "whole")
    _phase(profile_phase, "tiled", sequential=True)
    _phase(profile_phase, "tiled")
    _phase(profile_phase, "tiled", lanes=8)
    ssd_err, ssd_t = _phase(ssd_phase)
    (flash_err, flash_t), (wgmma_err, wgmma_t), _ = _phase(flash_phase)
    whisper_err = _phase(flash_whisper_phase)
    flash_err = max(flash_err, whisper_err["f32"])
    wgmma_err = max(wgmma_err, whisper_err["wgmma"])
    bwd_err, _, bwd_t, bwd_lib = _phase(flash_bwd_phase)
    _phase(model_parity_phase)
    _phase(encdec_smoke_phase)
    _phase(per_row_phase)
    flash_launches = _phase(consistency_phase)
    flash_launches += _phase(window_consistency_phase)
    flash_launches += _phase(moe_consistency_phase)
    flash_launches += _phase(whisper_consistency_phase)
    ssd_launches, wgmma_launches = _phase(serve_phase)
    wgmma_launches += _phase(dense_serve_phase, "gemma2_9b")
    wgmma_launches += _phase(dense_serve_phase, "starcoder2_3b")
    wgmma_launches += _phase(olmoe_serve_phase)
    wgmma_launches += _phase(whisper_serve_phase)
    _phase(mla_full_phase)
    _phase(deepseek_serve_phase)
    _phase(batcher_phase)
    bwd_launches = _phase(train_tiny_phase)
    bwd_launches += _phase(train_phase, "starcoder2_3b")
    _phase(train_steps_phase, "starcoder2_3b")
    _phase(serve_profile_phase)
    _phase(serve_profile_phase, "gemma2_9b", GEMMA_SERVE)
    _phase(serve_profile_phase, "olmoe_1b_7b", OLMOE_SERVE, steps=1)
    _phase(serve_profile_phase, "whisper_large_v3", WHISPER_SERVE)
    # sweep: launch-weighted means over the whole route's 10x sweep shapes
    # (f64, cost only); chain tile: launch-weighted over the tiled route's
    # own tiles (tile_mix_phase), at one lane a launch and, as a row of its
    # own, at eight (the burst phase's run); one-slot kernel: ops.minplus (cost and
    # argmin, f64, device time per launch) averaged over the 10x buckets
    # at d1 = 1280, one each, as its own run launches it (64 slots at each
    # bucket); plateau kernel: per tile launch, averaged over the tiled
    # route's own plateau tiles (plateau_mix_phase: every one at m_pad 64,
    # d1 1280, f64), its launches that run's plateau tiles
    n = sum(hist.values())
    mean = [sum(hist[m] * timings[(SCALE["T"], m, 1280, torch.float64)][i]
                for m in hist) / n for i in range(5)]
    print(f"sweep over the 10x mix (float64, cost only): launch-weighted "
          f"kernel_device_ms={mean[0]!r} bound_ms={mean[2]!r}; per m_pad " +
          " ".join(f"{m}:{timings[(SCALE['T'], m, 1280, torch.float64)][0]!r}"
                   f"x{hist[m]}" for m in sorted(hist)))
    slot = [sum(slot_timings[(m, 1280)][i] for m in M_PADS)
            / len(M_PADS) for i in range(5)]
    src = "src/repro_torch/kernels/minplus/csrc/"
    ref = "src/repro/kernels/minplus/kernel.py:"
    # the scenario phase's OASiS runs and the learned phase's replays:
    # sweeps of the whole route, chain and plateau tiles of the tiled
    # route (every sweep-kernel launch of a tiled run is a chain tile's)
    rows = [("minplus_sweep", "minplus_sweep.cu", "125",
             launches + scen["whole"][0] + replays["whole"][0], max_err,
             mean),
            ("minplus_tile", "minplus_sweep.cu", "54",
             c_launches + scen["tiled"][0] + replays["tiled"][0], tile_err,
             tile),
            ("minplus_tile_8_lanes", "minplus_sweep.cu", "54", l_launches,
             lanes_err, tile8),
            ("minplus_slot", "minplus_slot.cu", "54", a_launches,
             slot_err, slot),
            ("minplus_plateau", "minplus_plateau.cu", "207",
             b_launches + scen["tiled"][2] + replays["tiled"][2],
             plateau_err, plat)]
    rows = [(name, src + file, ref + line, n_launch, err, t, None)
            for name, file, line, n_launch, err, t in rows]
    # the D&C kernel: the counterpart of a jnp function (monotone.py's
    # monotone_dnc_step), not of a Pallas kernel; launches over the D&C
    # run (paper scale, REPRO_MONOTONE_DNC=1), times over its own tiles
    rows.append(("minplus_dnc", src + "minplus_dnc.cu",
                 "src/repro/kernels/minplus/monotone.py:268", d_launches,
                 dnc_err, dnc_t, None))
    # the model kernels: device time per launch at Zamba2-7B's prefill
    # shapes (the dense, MoE and enc-dec families' shapes on the flash
    # phases' own lines); SSD (float32): launches over the Zamba2 serve
    # phase's two prefills; the tensor-core flash kernel (bf16): over the
    # two prefills of each of the five serve phases (Zamba2-7B, Gemma2-9B,
    # StarCoder2-3B, OLMoE-1B-7B, Whisper-large-v3); the float32 flash
    # kernel (TF32 mma.sync): over the float32 path's prefills (Zamba2-7B's
    # consistency phase, Gemma2-9B's two in the window consistency phase,
    # OLMoE's two in the MoE consistency phase, Whisper's prefill and
    # encdec_prepare in its consistency phase); max_abs_err over the
    # Whisper shapes too
    fa_src = "src/repro_torch/kernels/flash_attention/csrc/"
    fa_ref = "src/repro/kernels/flash_attention/kernel.py:71"
    rows += [("ssd_mma", "src/repro_torch/kernels/ssd/csrc/ssd_mma.cu",
              "src/repro/kernels/ssd/kernel.py:57", ssd_launches, ssd_err,
              ssd_t, None),
             ("flash_attention_wgmma", fa_src + "flash_attention_wgmma.cu",
              fa_ref, wgmma_launches, wgmma_err, wgmma_t, wgmma_t[5]),
             ("flash_attention_mma", fa_src + "flash_attention_mma.cu",
              fa_ref, flash_launches, flash_err, flash_t, flash_t[5])]
    # the flash-attention backward: the counterpart of no Pallas kernel
    # (the reference differentiates its jnp attention with
    # jax.value_and_grad); launches over the two training phases (TINY on
    # the card, StarCoder2-3B at full width), times at StarCoder2-3B's
    # training attention in bfloat16, beside SDPA's backward
    rows.append(("flash_attention_bwd", fa_src + "flash_attention_bwd.cu",
                 "jax.value_and_grad (src/repro/train/steps.py:152) through "
                 "src/repro/models/attention.py::_sdpa_chunked (:66)",
                 bwd_launches, bwd_err, bwd_t, bwd_lib))
    print(f"chip_smoke phases: wall_s={time.perf_counter() - t_start!r}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": n_launch, "max_abs_err": err,
        "ms": t[0], "plain_ms": t[1], "bound_ms": t[2],
        "bound_by": "operations" if t[3] >= t[4] else "bytes",
        "library_ms": lib}
        for name, source, replaces, n_launch, err, t, lib in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

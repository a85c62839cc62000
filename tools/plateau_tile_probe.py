"""Time the plateau tile under each plan it could take, and what each part
of a slot costs, on one NVIDIA card: the measurement behind
``plateau_plan``'s choices.

    python3 tools/plateau_tile_probe.py

Float64 tiles at the tiled route's one plateau shape (DC+1 = 64, D+1 =
1280, r_max 16) from a DP column, on two kinds of rows: ``route`` rows as
the route's COST rows are (a few short finite runs, then a +inf run to
the end of the band) and ``16 runs`` (a staircase of 16 finite runs over
the whole band, the most the route's gate passes).  Each variant runs
the first 1, 17, 47 and 64 rows of one 64-row tile; it prints the device
ms per launch at 47 and 64 slots, and a least-squares fit of the four
times as a fixed cost per launch plus a cost per slot.  The variants:

- the table in shared memory under clusters of 1, 2, 4, 8 and 16 blocks
  (``plateau_plan`` takes 16), 128 threads a block at C = 8 and 16 (the
  plan takes 256), the table in global scratch at C = 16, and the direct
  loop over j at each cluster size (the kernel's path for a row of more
  than r_max runs, forced by r_max = 1): each checked bit for bit against
  the plain tile (``monotone.plateau_step`` chained) before it is timed;
- ``no levels``, ``no answers`` and ``handoff only``: the kernel's source
  with the table levels, the per-run answers or both left out, built
  beside the kernel's library, at the planned plan: they compute wrong
  values and are only timed, to split a slot's time into its parts;
- the chain kernel (``minplus_sweep_cuda`` given the carry) on the same
  tiles, the same function: the yardstick.

Prints the card's name and power limit, then one line per variant and
kind of rows.  Exits non-zero without a CUDA device or when a checked
variant disagrees.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402  (adds src/ to the path)
from repro_torch.kernels.build import (BUILD_DIR, bind,  # noqa: E402
                                       build_libraries, launch)
from repro_torch.kernels.minplus import kernel  # noqa: E402
from repro_torch.kernels.minplus.ref import minplus_sweep_ref  # noqa: E402

DC1, D1, R_MAX = 64, 1280, 16
LENGTHS = (1, 17, 47, 64)

# source edits that leave a part of the slot out (timing only)
_LEVELS = "      for (int k = 1; k <= top; ++k) {"
_ANSWERS = ("          best = min2(best, cst_i[r] + min2(tab[c + lo_i[r]], "
            "tab[c + hi_i[r]]));")
EDITS = {
    "no levels": ((_LEVELS, "      for (int k = 1; k <= 0; ++k) {"),),
    "no answers": ((_ANSWERS, "          best = tab[c + jpad];"),),
    "handoff only": ((_LEVELS, "      for (int k = 1; k <= 0; ++k) {"),
                     (_ANSWERS, "          best = tab[c + jpad];")),
}


def _route_rows(n, rng):
    """COST-row stand-ins as the route's are: 0, then 1-5 finite runs of
    1-4 values on a grid of quarters, then +inf to the end of the band."""
    rows = np.full((n, DC1), np.inf)
    for t in range(n):
        j, v = 1, 0.0
        rows[t, 0] = 0.0
        for _ in range(int(rng.integers(1, 6))):
            v += float(rng.integers(1, 4)) / 4.0
            k = int(rng.integers(1, 5))
            rows[t, j:j + k] = v
            j += k
    return rows


def _staircase_rows(n, rng):
    """16 finite runs over the whole band, non-decreasing."""
    rows = np.empty((n, DC1))
    for t in range(n):
        cuts = np.sort(rng.choice(np.arange(1, DC1), R_MAX - 1,
                                  replace=False))
        vals = np.concatenate([[0.0], np.cumsum(rng.integers(1, 4,
                                                             R_MAX - 1))])
        rows[t] = np.repeat(vals / 4.0,
                            np.diff(np.concatenate([[0], cuts, [DC1]])))
    return rows


def _edited_libraries():
    """The kernel's source with each of EDITS applied, built together."""
    src = kernel.SOURCES["plateau"].read_text()
    folder = BUILD_DIR / "plateau_probe"
    folder.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the kernel's source changed")
            text = text.replace(old, new)
        path = folder / (name.replace(" ", "_") + ".cu")
        path.write_text(text)
        paths.append(path)
    stem, argtypes, err = kernel._SIGNATURES["plateau"]
    return {name: bind(lib, {f"{stem}_f64": argtypes}, err)
            for name, lib in zip(EDITS, build_libraries(paths))}


def _line(kind, name, times):
    ns = np.asarray(LENGTHS, float)
    fixed, per = (float(x) for x in np.linalg.lstsq(
        np.stack([np.ones_like(ns), ns], 1), np.asarray(times),
        rcond=None)[0])
    at = dict(zip(LENGTHS, times))
    print(f"plateau tile, {kind} rows, m_pad={DC1} d1={D1} float64, "
          f"{name}: ms_47={at[47]!r} ms_64={at[64]!r} fit: "
          f"fixed_us={fixed * 1e3!r} per_slot_us={per * 1e3!r}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("plateau_tile_probe: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._card())
    dtype = torch.float64
    size = dtype.itemsize
    edited = _edited_libraries()
    stem, _, err = kernel._SIGNATURES["plateau"]
    carry = minplus_sweep_ref(chip_smoke._rows(3, DC1, D1, dtype) + 1.0,
                              D1 - 1)[0][-1].contiguous()
    rng = np.random.default_rng(0)
    planned = kernel.plateau_plan(DC1, D1, dtype, R_MAX)
    variants = []
    for c in kernel.SWEEP_CLUSTERS:
        variants.append((f"table C={c}", R_MAX, kernel._plateau_plan_at(
            DC1, D1, size, R_MAX, c, True)))
    for c in (8, 16):
        variants.append((f"table C={c} threads=128", R_MAX,
                         kernel._plateau_plan_at(DC1, D1, size, R_MAX, c,
                                                 True)._replace(threads=128)))
    variants.append((f"global table C={planned.cluster}", R_MAX,
                     kernel.plateau_plan(DC1, D1, dtype, R_MAX,
                                         table_shared=False)))
    for c in kernel.SWEEP_CLUSTERS:
        variants.append((f"direct loop C={c}", 1, kernel._plateau_plan_at(
            DC1, D1, size, 1, c, True)))
    for kind, make in (("route", _route_rows), ("16 runs", _staircase_rows)):
        rows64 = torch.tensor(make(64, rng), dtype=dtype, device="cuda")
        want = chip_smoke._plain_plateau_tile(rows64, carry)
        for name, r_max, plan in variants:
            times = []
            for n in LENGTHS:
                rows = rows64[:n]
                out = torch.full((n, D1), float("nan"), dtype=dtype,
                                 device="cuda")
                kernel.minplus_plateau_cuda(rows, carry, r_max=r_max,
                                            out=out, plan=plan)
                torch.cuda.synchronize()
                if not chip_smoke._same_bits(out, want[:n]):
                    raise AssertionError(f"{kind} rows, {n} slots, {name}: "
                                         "the kernel differs from the plain "
                                         "tile")
                times.append(chip_smoke._device_ms(
                    lambda: kernel.minplus_plateau_cuda(
                        rows, carry, r_max=r_max, out=out, plan=plan), 30))
            _line(kind, f"{name} (bitwise)", times)
        for name, lib in edited.items():
            times = []
            for n in LENGTHS:
                rows = rows64[:n]
                out = torch.empty((n, D1), dtype=dtype, device="cuda")
                times.append(chip_smoke._device_ms(lambda: launch(
                    lib, f"{stem}_f64", err, rows.device, rows.data_ptr(),
                    carry.data_ptr(), out.data_ptr(), None, n, DC1, D1,
                    R_MAX, planned.cluster, planned.w, planned.jpad,
                    planned.threads, planned.kmax, planned.stage, 1), 30))
            _line(kind, f"{name} (C={planned.cluster}, wrong values, timed "
                  "only)", times)
        times = []
        for n in LENGTHS:
            rows = rows64[:n]
            out = torch.empty((n, D1), dtype=dtype, device="cuda")
            kernel.minplus_sweep_cuda(rows, D1 - 1, prev=carry, out=out)
            torch.cuda.synchronize()
            if not chip_smoke._same_bits(out, want[:n]):
                raise AssertionError(f"{kind} rows, {n} slots: the chain "
                                     "differs from the plain tile")
            times.append(chip_smoke._device_ms(
                lambda: kernel.minplus_sweep_cuda(rows, D1 - 1, prev=carry,
                                                  out=out), 30))
        _line(kind, "chain kernel (bitwise)", times)
    return 0


if __name__ == "__main__":
    sys.exit(main())

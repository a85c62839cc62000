"""Time the chain tile under each cluster size it can take, on one
NVIDIA card: the measurement behind ``sweep_plan``'s rule for the tile.

    python3 tools/tile_cluster_probe.py

64-slot float64 tiles from a DP column (``minplus_sweep_cuda`` given
``prev``), at the 10x buckets (m_pad 64..640, d1 1280) and the wide bands
(d1 20480), under clusters of 4, 8 and 16 blocks where a plan of that size
fits, each checked bit for bit against ``tiled.minplus_tile``.  Prints
the card's name and power limit, then one line per shape: device ms per
launch by cluster size, and the size ``sweep_plan`` picks.  Exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402  (adds src/ to the path)
from repro_torch.kernels.minplus import kernel  # noqa: E402
from repro_torch.kernels.minplus.ref import minplus_sweep_ref  # noqa: E402
from repro_torch.kernels.minplus.tiled import TILE, minplus_tile  # noqa: E402

CLUSTERS = (4, 8, 16)


def main() -> int:
    if not torch.cuda.is_available():
        print("tile_cluster_probe: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._card())
    dtype = torch.float64
    for dc1, d1 in chip_smoke.SLOT_SCALE_SHAPES + chip_smoke.SLOT_WIDE_SHAPES:
        rows = chip_smoke._rows(TILE, dc1, d1, dtype)
        carry = minplus_sweep_ref(chip_smoke._rows(3, dc1, d1, dtype) + 1.0,
                                  d1 - 1)[0][-1].contiguous()
        want = minplus_tile(rows[:, None, :], carry[None])[1][:, 0]
        out = torch.empty((TILE, d1), dtype=dtype, device="cuda")
        reps = 3 if d1 > 1280 else 50
        by_c = {}
        for c in CLUSTERS:
            plan = kernel._sweep_plan_at(dc1, d1, dtype.itemsize, c)
            if plan is None:
                continue
            kernel.minplus_sweep_cuda(rows, d1 - 1, prev=carry, out=out,
                                      plan=plan)
            torch.cuda.synchronize()
            if not chip_smoke._same_bits(out, want):
                raise AssertionError(f"m_pad={dc1} d1={d1} C={c}: the tile "
                                     "differs from minplus_tile")
            by_c[c] = chip_smoke._device_ms(
                lambda: kernel.minplus_sweep_cuda(rows, d1 - 1, prev=carry,
                                                  out=out, plan=plan), reps)
        picked = kernel.sweep_plan(dc1, d1, dtype).cluster
        print(f"tile {TILE} slots m_pad={dc1} d1={d1} float64 ms per launch: "
              + " ".join(f"C={c}:{ms!r}" for c, ms in by_c.items())
              + f" fastest=C={min(by_c, key=by_c.get)} planned=C={picked} "
              "bitwise=True")
    return 0


if __name__ == "__main__":
    sys.exit(main())

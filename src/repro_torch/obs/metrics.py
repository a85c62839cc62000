"""Process-local metrics registry: counters, gauges, histograms.

Zero-dependency companion to :mod:`repro_torch.obs.trace`.  A
:class:`Registry` is a plain dict-backed accumulator — no background
threads, no exporters — whose whole state round-trips through
``snapshot()`` / ``reset()``.  Metric names are dotted strings
(``"price.device_uploads"``); the README's port section lists the ones
the port's engine emits.

Histograms use fixed buckets: the upper edges are pinned at first
``observe()`` (or pre-declared via :meth:`Registry.histogram`) and a
``+Inf`` overflow bucket is always implied, so merging or diffing two
snapshots never has to reconcile edge sets.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

# default histogram edges: exponential, centred on the sub-ms..minutes
# range the decision/latency observations live in (seconds)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-5, 1e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0, 10.0, 60.0)


class Histogram:
    """Fixed-bucket histogram with count/sum, Prometheus-style."""

    __slots__ = ("edges", "counts", "count", "sum")

    def __init__(self, edges: Sequence[float] = DEFAULT_BUCKETS):
        if list(edges) != sorted(edges):
            raise ValueError(f"histogram edges must be sorted: {edges!r}")
        self.edges: Tuple[float, ...] = tuple(float(e) for e in edges)
        self.counts: List[int] = [0] * (len(self.edges) + 1)  # +Inf overflow
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        lo, hi = 0, len(self.edges)
        while lo < hi:                      # first edge >= v
            mid = (lo + hi) // 2
            if self.edges[mid] >= v:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1

    def to_dict(self) -> dict:
        return {"edges": list(self.edges), "counts": list(self.counts),
                "count": self.count, "sum": self.sum}


class Registry:
    """Process-local counters + gauges + histograms.

    All mutators are O(1) dict operations; ``snapshot()`` returns plain
    JSON-serialisable data (safe to embed in a JSON record or a
    Chrome-trace export) and ``reset()`` zeroes everything in place.
    """

    def __init__(self) -> None:
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    # -- mutators ------------------------------------------------------
    def inc(self, name: str, n: float = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    def histogram(self, name: str,
                  edges: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        """Pre-declare (or fetch) a histogram with explicit edges."""
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(edges)
        return h

    def observe(self, name: str, value: float) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        h.observe(value)

    # -- accessors -----------------------------------------------------
    def counter(self, name: str) -> float:
        return self._counters.get(name, 0)

    def gauge(self, name: str) -> Optional[float]:
        return self._gauges.get(name)

    def snapshot(self) -> dict:
        """JSON-serialisable view of the whole registry."""
        return {
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "histograms": {k: h.to_dict()
                           for k, h in sorted(self._hists.items())},
        }

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()

    def validate(self) -> List[str]:
        """Return a list of problems (non-finite values); empty if clean."""
        bad = []
        for name, v in self._counters.items():
            if not math.isfinite(v):
                bad.append(f"counter {name} is {v!r}")
        for name, v in self._gauges.items():
            if not math.isfinite(v):
                bad.append(f"gauge {name} is {v!r}")
        return bad

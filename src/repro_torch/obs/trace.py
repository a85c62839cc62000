"""Nestable wall-clock spans in a bounded in-memory ring.

A :class:`Tracer` records *complete* span events — name, start, wall
duration, nesting depth, free-form attributes — into a ``deque`` ring
(oldest events are dropped once ``capacity`` is hit; ``dropped`` counts
the loss, so an export is never silently partial).  Timestamps come
from ``time.perf_counter_ns`` relative to the tracer's construction,
which keeps them monotone and immune to wall-clock steps.

Two export formats:

* :meth:`Tracer.export_jsonl` — one JSON object per line, trivially
  greppable / ``pandas.read_json(lines=True)``-able.
* :meth:`Tracer.export_chrome` — the Chrome-trace / Perfetto
  ``traceEvents`` array (``ph: "X"`` complete events, microsecond
  units).  Open the file at https://ui.perfetto.dev or
  ``chrome://tracing``.  Extra top-level keys are legal in the format,
  so a metrics snapshot can ride along in the same file.

Spans are re-entrant per-thread in the trivial sense (a per-tracer
depth counter tracks lexical nesting); the engine is single-threaded,
so no locking is attempted.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional


class Span:
    """Context manager recording one complete event on exit.

    ``set(**attrs)`` attaches attributes discovered mid-span (e.g. how
    many slots a fast-forward actually skipped)."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._t0 = 0
        self._depth = 0

    def set(self, **attrs: Any) -> None:
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        tr = self._tracer
        self._depth = tr._depth
        tr._depth += 1
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter_ns()
        tr = self._tracer
        tr._depth -= 1
        tr._record(self.name, self._t0, t1 - self._t0, self._depth,
                   self.attrs)


class NullSpan:
    """Shared no-op stand-in returned while tracing is disabled."""

    __slots__ = ()

    def set(self, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NULL_SPAN = NullSpan()


class Tracer:
    """Bounded ring of finished spans + instant events."""

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self.dropped = 0
        self._depth = 0
        self._epoch_ns = time.perf_counter_ns()

    # -- recording -----------------------------------------------------
    def span(self, name: str, **attrs: Any) -> Span:
        return Span(self, name, attrs or None)

    def instant(self, name: str, **attrs: Any) -> None:
        """Record a zero-duration marker (Chrome-trace ``ph: "i"``)."""
        self._record(name, time.perf_counter_ns(), None, self._depth,
                     attrs or None)

    def _record(self, name: str, t0_ns: int, dur_ns: Optional[int],
                depth: int, attrs: Optional[Dict[str, Any]]) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(
            (name, t0_ns - self._epoch_ns, dur_ns, depth, attrs))

    # -- access / export ----------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> Iterator[dict]:
        """Yield recorded events as dicts (microsecond floats)."""
        for name, rel_ns, dur_ns, depth, attrs in list(self._events):
            ev = {"name": name, "ts_us": rel_ns / 1e3,
                  "dur_us": None if dur_ns is None else dur_ns / 1e3,
                  "depth": depth}
            if attrs:
                ev["args"] = attrs
            yield ev

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0

    def export_jsonl(self, path: str) -> int:
        """Write one JSON object per event; returns the event count."""
        n = 0
        with open(path, "w") as fh:
            for ev in self.events():
                fh.write(json.dumps(ev, default=str) + "\n")
                n += 1
        return n

    def chrome_events(self) -> List[dict]:
        """Events in Chrome-trace ``traceEvents`` form."""
        pid = os.getpid()
        tid = threading.get_ident() % 10000
        out = []
        for name, rel_ns, dur_ns, depth, attrs in list(self._events):
            ev: Dict[str, Any] = {
                "name": name, "cat": "repro_torch",
                "ph": "X" if dur_ns is not None else "i",
                "ts": rel_ns / 1e3, "pid": pid, "tid": tid,
            }
            if dur_ns is not None:
                ev["dur"] = dur_ns / 1e3
            else:
                ev["s"] = "t"          # instant scope: thread
            if attrs:
                ev["args"] = {k: str(v) if not isinstance(
                    v, (int, float, bool, str, type(None))) else v
                    for k, v in attrs.items()}
            out.append(ev)
        return out

    def export_chrome(self, path: str,
                      metrics: Optional[dict] = None) -> int:
        """Write a Perfetto-loadable trace; returns the event count.

        ``metrics`` (a ``Registry.snapshot()``) is embedded as an extra
        top-level key — Chrome-trace viewers ignore unknown keys, and it
        lets one artifact carry both the timeline and the counters."""
        evs = self.chrome_events()
        doc: Dict[str, Any] = {"traceEvents": evs, "displayTimeUnit": "ms"}
        if self.dropped:
            doc["otherData"] = {"dropped_events": self.dropped}
        if metrics is not None:
            doc["metrics"] = metrics
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return len(evs)

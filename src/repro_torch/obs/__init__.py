"""Flight-recorder observability for the port: structured tracing +
metrics.

The port's own copy of the reference's ``obs`` package (same classes,
same behaviour, same export schema; the Chrome-trace ``cat`` is
``repro_torch``).  Zero-dependency, disabled by default.  The hot paths
guard every emission behind the module-level :data:`ENABLED` flag::

    from .. import obs as _obs
    ...
    if _obs.ENABLED:
        _obs.inc("price.device_uploads")
    with (_obs.span("price.commit", jid=job.jid) if _obs.ENABLED
          else _obs.NULL_SPAN):
        ...

When no :class:`Obs` is active, ``span()`` hands back a shared no-op
singleton and the counter helpers return at once: no allocation, no dict
lookups, so instrumented runs stay bit-identical and within noise of the
uninstrumented code (``tests/test_torch_obs.py``).

Spans time the host clock (``perf_counter_ns``).  The recorder adds no
device synchronisation of its own: a span around device work closes
where the code already reads a result back to the host, and span
attributes are host ints, floats and strs, never tensors (exporting one
would read it back).

Activation is scoped: ``engine.run(..., obs=ob)`` installs ``ob`` for the
duration of the run via :func:`activate`, restoring the previous state on
exit; :func:`enable` installs a process-global recorder for CLI use
(``python -m repro_torch.launch.cluster_sim --trace out.json``).  The
README's port section lists the spans and counters the port emits.
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional, Union

from .metrics import DEFAULT_BUCKETS, Histogram, Registry
from .trace import NULL_SPAN, NullSpan, Span, Tracer

__all__ = [
    "ENABLED", "Obs", "activate", "current", "disable", "enable",
    "event", "inc", "observe", "set_gauge", "span",
    "DEFAULT_BUCKETS", "Histogram", "Registry",
    "NULL_SPAN", "NullSpan", "Span", "Tracer",
]

# single check the hot paths read before touching anything else.  True
# exactly while a recorder is installed (scoped or global).
ENABLED: bool = False

_CURRENT: Optional["Obs"] = None


class Obs:
    """One tracer + one metrics registry, recorded together."""

    def __init__(self, capacity: int = 65536):
        self.tracer = Tracer(capacity=capacity)
        self.metrics = Registry()

    def export_chrome(self, path: str) -> int:
        """Chrome-trace file with the metrics snapshot embedded."""
        return self.tracer.export_chrome(
            path, metrics=self.metrics.snapshot())

    def reset(self) -> None:
        self.tracer.clear()
        self.metrics.reset()


def current() -> Optional[Obs]:
    return _CURRENT


def enable(ob: Optional[Obs] = None, capacity: int = 65536) -> Obs:
    """Install ``ob`` (or a fresh recorder) process-globally."""
    global _CURRENT, ENABLED
    _CURRENT = ob if ob is not None else Obs(capacity=capacity)
    ENABLED = True
    return _CURRENT


def disable() -> None:
    global _CURRENT, ENABLED
    _CURRENT = None
    ENABLED = False


@contextlib.contextmanager
def activate(ob: Optional[Obs]) -> Iterator[Optional[Obs]]:
    """Scoped install: ``with activate(ob): ...``.

    ``activate(None)`` is a no-op passthrough so call sites can thread
    an optional ``obs=`` parameter without branching."""
    global _CURRENT, ENABLED
    if ob is None:
        yield _CURRENT
        return
    prev = _CURRENT
    _CURRENT = ob
    ENABLED = True
    try:
        yield ob
    finally:
        _CURRENT = prev
        ENABLED = prev is not None


# -- hot-path helpers (no-ops unless ENABLED) --------------------------

def span(name: str, **attrs: Any) -> Union[Span, NullSpan]:
    ob = _CURRENT
    if ob is None:
        return NULL_SPAN
    return ob.tracer.span(name, **attrs)


def event(name: str, **attrs: Any) -> None:
    ob = _CURRENT
    if ob is not None:
        ob.tracer.instant(name, **attrs)


def inc(name: str, n: float = 1) -> None:
    ob = _CURRENT
    if ob is not None:
        ob.metrics.inc(name, n)


def observe(name: str, value: float) -> None:
    ob = _CURRENT
    if ob is not None:
        ob.metrics.observe(name, value)


def set_gauge(name: str, value: float) -> None:
    ob = _CURRENT
    if ob is not None:
        ob.metrics.set_gauge(name, value)

"""Span tracer for the serving stack, reading time only through an
injected Clock (port of ``repro.obs.trace``).

A :class:`Tracer` is built around the same injectable
``serve.clock.Clock`` the serving stack runs on, and every implicit
timestamp (``span`` enter and exit, ``event`` with no explicit instant) is
a ``clock.now()`` read.  Under a ``VirtualClock`` the spans are a
bit-for-bit deterministic function of the input trace.

Two recording styles:

* **host stages** happen *now*: ``with tracer.span("pack", ...)``; on a
  ``RealClock`` the span measures real host time, on a ``VirtualClock`` it
  is a zero-duration marker at the virtual instant;
* **timeline stages** computed by an event loop (queue wait, device
  occupancy) are recorded with explicit boundaries by :meth:`Tracer.record`.

The default sink everywhere is :data:`NULL_TRACER`, whose every method is a
constant-return stub: no list append, no clock read.  Call sites build
attributes only when ``tracer.enabled``.

Spans carry a ``track`` (one Perfetto thread row per track) and sorted
``attrs`` tuples, so serialization order never depends on keyword order.
Export lives in ``obs/export.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


def _freeze_attrs(attrs: dict) -> Tuple[tuple, ...]:
    """Attrs as a sorted, hashable tuple."""
    return tuple(sorted(attrs.items()))


@dataclasses.dataclass(frozen=True)
class Span:
    """One closed span, ``[t0_s, t1_s]`` on the tracer's clock; an instant
    event has ``t1_s is None`` (Perfetto ``ph: "i"``), a closed span exports
    as a complete event (``ph: "X"``)."""

    name: str
    t0_s: float
    t1_s: Optional[float]
    track: str = "scheduler"
    attrs: Tuple[tuple, ...] = ()

    @property
    def dur_s(self) -> float:
        return 0.0 if self.t1_s is None else self.t1_s - self.t0_s


class _LiveSpan:
    """Context manager recording one span on exit (exceptions included: a
    failed stage still shows in the trace, with its real duration)."""

    __slots__ = ("_tracer", "_name", "_track", "_attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, track: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._attrs = attrs
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = self._tracer.clock.now()
        return self

    def __exit__(self, *exc):
        self._tracer.record(self._name, self._t0, self._tracer.clock.now(),
                            track=self._track, **self._attrs)
        return False


class Tracer:
    """Collects spans and events; every implicit time read goes through the
    one injected ``clock`` (only ``now()`` is required)."""

    enabled = True

    def __init__(self, clock):
        self.clock = clock
        self.spans: List[Span] = []

    def span(self, name: str, track: str = "host", **attrs) -> _LiveSpan:
        """Measure a host stage happening now."""
        return _LiveSpan(self, name, track, attrs)

    def record(self, name: str, t0_s: float, t1_s: float,
               track: str = "scheduler", **attrs) -> None:
        """Record a closed span with explicit boundaries."""
        self.spans.append(Span(name=name, t0_s=float(t0_s), t1_s=float(t1_s),
                               track=track, attrs=_freeze_attrs(attrs)))

    def event(self, name: str, t_s: Optional[float] = None,
              track: str = "scheduler", **attrs) -> None:
        """Record an instant event at ``t_s`` (default: the clock's now)."""
        at = self.clock.now() if t_s is None else float(t_s)
        self.spans.append(Span(name=name, t0_s=at, t1_s=None, track=track,
                               attrs=_freeze_attrs(attrs)))

    def clear(self) -> None:
        self.spans.clear()


class _NullSpan:
    """The shared no-op context manager ``NullTracer.span`` returns."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The default sink: every method is a no-op and nothing reads a clock."""

    enabled = False
    spans: Tuple[()] = ()

    def span(self, name: str, track: str = "host", **attrs) -> _NullSpan:
        return _NULL_SPAN

    def record(self, name: str, t0_s: float, t1_s: float,
               track: str = "scheduler", **attrs) -> None:
        pass

    def event(self, name: str, t_s: Optional[float] = None,
              track: str = "scheduler", **attrs) -> None:
        pass

    def clear(self) -> None:
        pass


NULL_TRACER = NullTracer()

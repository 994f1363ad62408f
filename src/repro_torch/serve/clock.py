"""The serving stack's one time authority: an injectable ``Clock`` (port of
``repro.serve.clock``).

Scheduling correctness lives in timing edge cases (deadline expiry
against arrival ties, flush ordering, shed decisions taken at admission),
and none of that is testable against a wall clock.  So every timestamp
of the serving stack flows through a ``Clock`` object:

* :class:`VirtualClock` — deterministic simulated time, moved only by its
  owner, so a scripted trace gives the same timestamps, bit for bit, on
  every run;
* :class:`RealClock` — ``time.perf_counter`` for live serving.

The :class:`~repro_torch.serve.executor.Executor` reads every duration
through its clock (default :class:`RealClock`), so a test can substitute a
stepping clock and get deterministic durations.
"""
from __future__ import annotations

import time


class Clock:
    """Monotone seconds since an arbitrary epoch; durations are differences
    of ``now()`` readings.

    ``advance_to`` is the event loop's hook: a simulated clock jumps to the
    requested instant; a real clock cannot jump, so it reports where wall
    time is."""

    def now(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    def advance_to(self, t_s: float) -> float:  # pragma: no cover - interface
        raise NotImplementedError


class RealClock(Clock):
    """Wall time via ``time.perf_counter``."""

    def now(self) -> float:
        return time.perf_counter()

    def advance_to(self, t_s: float) -> float:
        """Live time cannot jump: the advance is a stamp of wall now, which
        is already at or past ``t_s`` by the time the event is processed."""
        return self.now()


class VirtualClock(Clock):
    """Deterministic simulated time, advanced explicitly by its owner; it
    never moves on its own and never moves backwards."""

    __slots__ = ("_now_s",)

    def __init__(self, start_s: float = 0.0):
        self._now_s = float(start_s)

    def now(self) -> float:
        return self._now_s

    def advance_to(self, t_s: float) -> float:
        """Move time forward to ``t_s``; moving backwards is a scheduling
        bug and raises."""
        if t_s < self._now_s:
            raise ValueError(
                f"virtual time cannot go backwards: now={self._now_s!r}, "
                f"requested {t_s!r}"
            )
        self._now_s = float(t_s)
        return self._now_s

    def advance(self, dt_s: float) -> float:
        """Move time forward by a non-negative delta."""
        if dt_s < 0:
            raise ValueError(f"negative advance: {dt_s!r}")
        return self.advance_to(self._now_s + dt_s)

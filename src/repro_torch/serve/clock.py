"""The serving stack's time source: an injectable ``Clock`` (port of
``repro.serve.clock``; the scheduler's ``VirtualClock`` arrives with the
scheduler slice).

The :class:`~repro_torch.serve.executor.Executor` reads every duration
through its clock (default :class:`RealClock`), so a test can substitute a
stepping clock and get deterministic durations.
"""
from __future__ import annotations

import time


class Clock:
    """Monotone seconds since an arbitrary epoch; durations are differences
    of ``now()`` readings."""

    def now(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError


class RealClock(Clock):
    """Wall time via ``time.perf_counter``."""

    def now(self) -> float:
        return time.perf_counter()

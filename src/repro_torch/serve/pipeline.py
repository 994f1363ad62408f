"""Host/device pipelining: bounded prepare-ahead + dispatch-ahead (port of
``repro.serve.pipeline``).

The serial loop blocks in ``Executor.run`` inside the scheduler's event
loop, and every prepare stage (padding, the layout plan, the Laplacian
eigensolve) runs on the host between device executions: at capacity the
card idles while the host packs, and the host idles while the card runs.

This module owns the two live halves of the fix, and is the only place in
``serve/`` + ``obs/`` that touches ``threading`` / ``concurrent.futures``
(``tests/test_torch_engine_singlepath.py`` holds it, as it holds ``time``
to the executor and the clock):

* :class:`PipelinedStream` — a double-buffered executor-level runner: one
  worker thread prepares request k+1 on the host (pad + eigvec) and, on a
  card, pins it and copies it there on the worker's own CUDA stream while
  the card runs request k; the caller thread makes its stream wait for
  that copy, dispatches via :meth:`Executor.run_async` and harvests
  completions strictly FIFO through a bounded in-flight window (default
  depth 2).
* :class:`PipelineConfig` — the knob object of the scheduler's *modeled*
  pipelined mode (``StreamScheduler(pipeline=...)``).  Under a
  ``VirtualClock`` the scheduler stays single-threaded and deterministic
  bit for bit, so it never uses the worker: it dispatches and harvests on
  the virtual timeline, modelling host-pack cost per flush from
  ``host_cost`` — ``None`` (free host), a scripted constant or sequence
  (exact simulations), or ``"measured"`` (real host seconds read through
  the executor's clock, folded into the timeline).

Thread discipline: exactly one worker, and it only prepares and stages;
dispatch, harvest, every warm (a CUDA-graph capture, which runs in
``thread_local`` error mode so the worker's pinning and copies do not
break it) and every executor-cache mutation stay on the caller thread.
The card executes dispatches in order, so completions are FIFO by
construction: harvesting the window front keeps per-request response
order although dispatch k+1 happens before k completes.

:func:`overlap_fraction` reports how much host-pack time hid under device
execution, from a run's trace spans.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.serve.executor import Executor, PendingRun, PreparedBatch, staged


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Knobs of the pipelined execution mode.

    inflight:   bound on dispatched-but-unharvested flushes (the
                in-flight window).  1 = serial dispatch order (the
                equivalence baseline); 2 = double buffering (default).
    host_cost:  how the scheduler's modeled pipeline accounts host-pack
                time per flush on the virtual timeline:
                  * ``None`` — host work is free on the timeline (pure
                    dispatch-ahead semantics; the deterministic default);
                  * a float — constant seconds per flush (exact sims);
                  * a sequence — scripted per-flush seconds, the last
                    entry repeating once exhausted;
                  * ``"measured"`` — real host seconds measured around
                    the pack stage through the executor's clock and
                    folded into the timeline (no longer the same bits
                    across runs).
    overlap:    whether the modeled prepare worker packs *ahead* of the
                device (the pipeline; default).  ``False`` gates each
                pack on the device going idle — the serial loop's
                inline-blocking host — which is the baseline a modeled
                speedup is measured against.
    """

    inflight: int = 2
    host_cost: Union[None, str, float, Sequence[float]] = None
    overlap: bool = True

    def __post_init__(self):
        if self.inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {self.inflight}")
        hc = self.host_cost
        if hc is None or hc == "measured":
            return
        if isinstance(hc, str):
            raise ValueError(
                f"host_cost must be None, 'measured', seconds, or a "
                f"sequence of seconds; got {hc!r}"
            )
        seq = hc if isinstance(hc, (list, tuple)) else (hc,)
        if not seq or any(float(x) < 0 for x in seq):
            raise ValueError(f"host_cost seconds must be >= 0, got {hc!r}")

    @property
    def measured(self) -> bool:
        return self.host_cost == "measured"

    def host_cost_fn(self) -> Optional[Callable[[int], float]]:
        """Per-flush-index modeled host cost; ``None`` for ``"measured"``
        (the scheduler then times the real pack stage instead)."""
        hc = self.host_cost
        if hc == "measured":
            return None
        if hc is None:
            return lambda i: 0.0
        if isinstance(hc, (int, float)):
            const = float(hc)
            return lambda i: const
        seq = [float(x) for x in hc]
        return lambda i: seq[min(i, len(seq) - 1)]


def as_pipeline(value) -> Optional[PipelineConfig]:
    """Normalize the scheduler's ``pipeline=`` argument: ``None``/False
    = serial (off), True = defaults, an int = that in-flight depth, a
    :class:`PipelineConfig` = itself."""
    if value is None or value is False:
        return None
    if value is True:
        return PipelineConfig()
    if isinstance(value, PipelineConfig):
        return value
    if isinstance(value, int):
        return PipelineConfig(inflight=value)
    raise ValueError(
        f"pipeline must be None/bool/int/PipelineConfig, got {value!r}"
    )


class PipelinedStream:
    """Double-buffered streaming through one executor tenant.

    One worker thread prepares batches ahead of the dispatch loop; the
    caller thread dispatches with :meth:`Executor.run_async` and harvests
    the bounded in-flight window strictly FIFO.  ``prepare_ahead`` bounds
    how many prepared batches may wait (default: the in-flight depth —
    one buffer filling while one drains is the classic double buffer).

    stage:  on a card, copy each prepared batch there in the worker (from
            pinned memory, on the worker's CUDA stream, fenced by an event
            the dispatching stream waits on), so the dispatch-time copy is
            device to device; ``False`` hands the pinned host batch to
            ``run_async``, which copies it into the graph's static buffers
            on the dispatching stream.  The staged batch lives in its
            :class:`PendingRun` until the harvest, after its replay.  On
            the CPU both are the host batch itself.
    """

    def __init__(self, executor: Executor, model: Optional[str] = None,
                 inflight: int = 2, prepare_ahead: Optional[int] = None,
                 stage: bool = True):
        if inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {inflight}")
        if prepare_ahead is not None and prepare_ahead < 1:
            raise ValueError(f"prepare_ahead must be >= 1, got {prepare_ahead}")
        self.executor = executor
        self.model = model
        self.inflight = inflight
        self.prepare_ahead = prepare_ahead if prepare_ahead is not None else inflight
        self.stage = stage

    def _prepare(self, raw, with_eigvec: bool, prepare: Optional[Callable],
                 stream) -> Tuple[PreparedBatch, Optional["torch.cuda.Event"]]:
        """The worker's stage: a host batch, pinned and (``stage``) copied
        to the card on ``stream``; -> (batch, the copy's event or None)."""
        ex = self.executor
        p = (prepare(raw) if prepare is not None
             else ex.prepare_stream(raw, with_eigvec=with_eigvec, host=True))
        if stream is None:
            return staged(p, ex.device, copy=self.stage), None
        with torch.cuda.stream(stream):
            p = staged(p, ex.device, copy=self.stage)
            done = torch.cuda.Event()
            done.record(stream)
        return p, done

    def run(self, raws: Sequence[tuple], with_eigvec: bool = False,
            prepare: Optional[Callable] = None,
            ) -> Tuple[List[np.ndarray], dict]:
        """Stream ``raws`` through the pipeline; returns ``(outputs,
        stats)`` with outputs in request order (FIFO by construction: the
        window is harvested front-first).

        ``prepare`` overrides the per-item prepare stage (default:
        ``prepare_stream(host=True)``); it runs on the worker thread, so it
        must not touch executor compile/warm state — the ``prepare_*``
        family is construction only, which is why it can overlap the
        device.
        """
        ex = self.executor
        clock = ex.clock
        on_card = ex.device.type == "cuda"
        stream = torch.cuda.Stream(ex.device) if on_card and self.stage else None
        t_start = clock.now()
        outputs: List[np.ndarray] = []
        times: List[float] = []
        window: "collections.deque[PendingRun]" = collections.deque()
        peak_inflight = 0

        def harvest_one() -> None:
            out, dt = window.popleft().result()
            outputs.append(out)
            times.append(dt)

        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            prepared: "collections.deque" = collections.deque()
            it = iter(raws)

            def top_up() -> None:
                while len(prepared) < self.prepare_ahead:
                    try:
                        raw = next(it)
                    except StopIteration:
                        return
                    prepared.append(pool.submit(
                        self._prepare, raw, with_eigvec, prepare, stream))

            top_up()
            while prepared:
                p, copied = prepared.popleft().result()
                top_up()  # refill the prepare queue before dispatching
                if len(window) >= self.inflight:
                    harvest_one()
                if copied is not None:
                    torch.cuda.current_stream(ex.device).wait_event(copied)
                window.append(ex.run_async(p, model=self.model))
                peak_inflight = max(peak_inflight, len(window))
            while window:
                harvest_one()
        wall_s = clock.now() - t_start
        device_s = float(sum(times))
        return outputs, {
            "wall_s": wall_s,
            "device_s": device_s,
            "per_run_s": times,
            "peak_inflight": peak_inflight,
            "graphs_per_s": len(outputs) / max(wall_s, 1e-12),
        }


def overlap_fraction(trace_or_spans) -> float:
    """Fraction of host-pack span time that overlapped device execution,
    from a run's trace: ``pack`` spans (host track) against the union of
    ``device`` spans.  0.0 when no pack time was recorded — a serial run
    on a ``VirtualClock`` has zero-width pack markers, so a nonzero value
    is itself evidence the timeline modeled (or measured) real overlap."""
    spans = getattr(trace_or_spans, "spans", trace_or_spans)
    packs = [(s.t0_s, s.t1_s) for s in spans
             if s.name == "pack" and s.t1_s is not None and s.t1_s > s.t0_s]
    total = sum(t1 - t0 for t0, t1 in packs)
    if total <= 0.0:
        return 0.0
    devs = sorted((s.t0_s, s.t1_s) for s in spans
                  if s.name == "device" and s.t1_s is not None)
    merged: List[Tuple[float, float]] = []
    for t0, t1 in devs:
        if merged and t0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
        else:
            merged.append((t0, t1))
    ov = 0.0
    for p0, p1 in packs:
        for d0, d1 in merged:
            ov += max(0.0, min(p1, d1) - max(p0, d0))
    return ov / total

"""Process-wide metrics: counters, gauges, histograms and the closed catalog
(port of ``repro.obs.metrics``).

A :class:`MetricsRegistry` is a plain in-process store: no background
thread, no clock reads, no dependency.  Instruments are created through
``registry.counter(...)`` / ``gauge`` / ``histogram`` with get-or-create
semantics (a second registration with another type or label set raises),
and every instrument holds one value per label-set series.

**The catalog is closed.**  :data:`CATALOG` holds every metric the serving
stack may emit (name, type, help text, label names), the same surface as
the JAX package's, name for name and text for text, so a dashboard reads
both.  A name outside it raises, and ``obs/export.py`` validates snapshots
against it.  Where a help text speaks of jit or XLA, it keeps the JAX
package's words; on CUDA the executor's metrics mean:

* ``serve_programs_built_total`` — program-cache misses: a new
  ``(program_key, bucket_key, num_graphs)`` record (the forward closure of
  ``gnn.models.forward_program``);
* ``serve_warms_total`` — new warm signatures: one eager forward, one
  CUDA-graph capture and one untimed replay each (on the CPU: one eager
  forward);
* ``serve_compile_seconds_total`` — seconds in CUDA-graph capture (0 on
  the CPU, where nothing is captured);
* ``serve_warm_seconds_total`` — seconds of the eager warm forward (which
  builds the kernels at first use and sets up the libraries) plus the
  first replay;
* ``serve_device_seconds_total`` — the timed region: input copies into
  the graph's static buffers, the replay, the output's copy, up to the
  event that ends them;
* ``serve_d2h_seconds_total`` — the copy of the output to the host at
  harvest;
* ``kernels_dispatch_total{op, path}`` — where a ``kernels.ops`` wrapper
  ran and chose its path (``kernel`` or ``reference``; the port has no
  interpret path and no VMEM fallback): at warm and at capture, never at
  replay, so it is a census of the programs built, not of requests.

* ``serve_aot_cache_total{result}`` — lookups of the kernel-library cache
  (``serve/aot.py``; hit, miss or stale), one per library at its first
  load in the process, written by the executor; a miss or a stale entry
  ran ``nvcc``;
* ``serve_cold_start_seconds`` — launcher entry to ladder-warm, written by
  ``launch/serve.py`` under ``--aot-cache`` (the CUDA context, the
  libraries' load or build, every capture).

Snapshots sort metric names and label sets, so two identical simulated
runs serialize to identical JSON.  Histograms use fixed cumulative ``le``
bucket bounds (``+Inf`` implicit via ``count``).

``default_registry()`` is the process-wide instance: instrumentation with
no injection point (the ``kernels/ops`` dispatch census) records there;
serving components take an explicit ``metrics=`` registry (default
``None``: off).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

# latency-shaped seconds buckets: sub-ms to 1s, the serving stack's range
LATENCY_BUCKETS_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                     0.05, 0.1, 0.25, 0.5, 1.0)
# flush batch-size buckets: base bucket to the deepest ladder rung
SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)

#: name -> (type, help, label names).  The closed metric surface.
CATALOG: Dict[str, Tuple[str, str, Tuple[str, ...]]] = {
    # ---- scheduler: admission / shedding / flush accounting
    "serve_requests_total": (
        "counter", "Requests offered to the scheduler", ("tenant", "priority")),
    "serve_admitted_total": (
        "counter", "Requests admitted past SLO projection", ("tenant", "priority")),
    "serve_shed_total": (
        "counter", "Requests shed at admission, by reason",
        ("tenant", "priority", "reason")),
    "serve_served_total": (
        "counter", "Requests served to completion (goodput numerator)",
        ("tenant", "priority")),
    "serve_deadline_misses_total": (
        "counter", "Served requests that finished past their SLO deadline",
        ("tenant", "priority")),
    "serve_flushes_total": (
        "counter", "Bucket flushes, by reason (budget|deadline|drain)",
        ("reason",)),
    "serve_flush_graphs": (
        "histogram", "Real graphs per flush (micro-batch fill)", ()),
    "serve_request_latency_seconds": (
        "histogram", "End-to-end latency of served requests (arrival to done)",
        ("tenant", "priority")),
    "serve_queue_depth": (
        "gauge", "Admitted-but-unflushed requests across open buckets", ()),
    "serve_open_buckets": (
        "gauge", "Currently open (accumulating) micro-batch buckets", ()),
    "serve_service_ewma_seconds": (
        "gauge", "Per-signature service-time EWMA feeding admission projection",
        ("sig",)),
    "serve_ladder_refits_total": (
        "counter", "Adaptive-ladder geometry refits, per signature", ("sig",)),
    # ---- executor: compile / warm / device accounting
    "serve_programs_built_total": (
        "counter", "Compiled-program cache misses (jit program constructions)", ()),
    "serve_warms_total": (
        "counter", "Untimed warm executions (new trace signatures)", ()),
    "serve_compile_seconds_total": (
        "counter", "Seconds spent in trace+lower+compile (or AOT disk load), "
        "outside every timed region", ()),
    "serve_warm_seconds_total": (
        "counter", "Seconds spent in first-run device warm executions, "
        "outside every timed region (paid even on an AOT cache hit)", ()),
    "serve_aot_cache_total": (
        "counter", "AOT disk-cache lookups, by result (hit|miss|stale)",
        ("result",)),
    "serve_cold_start_seconds": (
        "gauge", "Process restart to first served response (serving-stack "
        "cost: construct + register + prewarm/AOT-load + first probe)", ()),
    "serve_device_seconds_total": (
        "counter", "Seconds of timed device execution", ()),
    "serve_d2h_seconds_total": (
        "counter", "Seconds spent in device-to-host output transfer "
        "(the unpack_d2h span at result harvest)", ()),
    "serve_eigvec_cache_total": (
        "counter", "Host eigvec-LRU lookups, by result (hit|miss)",
        ("result",)),
    # ---- pipeline: dispatch-ahead execution
    "serve_inflight_depth": (
        "gauge", "Dispatched-but-unharvested flushes in the pipelined "
        "in-flight window", ()),
    "serve_pack_ewma_seconds": (
        "gauge", "Per-signature host-pack EWMA feeding pipelined admission "
        "projection", ("sig",)),
    # ---- kernels: dispatch decisions (one per compiled program, at trace time)
    "kernels_dispatch_total": (
        "counter",
        "Kernel dispatch decisions at trace time, by op and resolved path "
        "(kernel|interpret|reference|vmem_fallback)",
        ("op", "path")),
}


def _series_key(labelnames: Tuple[str, ...], labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared label names "
            f"{sorted(labelnames)}"
        )
    return tuple(str(labels[k]) for k in labelnames)


class _Instrument:
    """Shared per-metric state: declared labels and one value per series."""

    kind = "abstract"

    def __init__(self, name: str, help: str, labelnames: Sequence[str]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series: dict = {}

    def _key(self, labels: dict) -> tuple:
        return _series_key(self.labelnames, labels)

    def series(self) -> dict:
        """``{label-value tuple: value}`` (the exporters sort it)."""
        return dict(self._series)


class Counter(_Instrument):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({value})")
        k = self._key(labels)
        self._series[k] = self._series.get(k, 0.0) + float(value)

    def value(self, **labels) -> float:
        return self._series.get(self._key(labels), 0.0)

    def total(self) -> float:
        return float(sum(self._series.values()))


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[self._key(labels)] = float(value)

    def value(self, **labels) -> float:
        return self._series.get(self._key(labels), 0.0)


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        super().__init__(name, help, labelnames)
        bs = tuple(float(b) for b in buckets)
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram {name} buckets must strictly increase")
        if bs and math.isinf(bs[-1]):
            bs = bs[:-1]  # +Inf is implicit (== count)
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        k = self._key(labels)
        s = self._series.get(k)
        if s is None:
            s = self._series[k] = {
                "buckets": [0] * len(self.buckets), "sum": 0.0, "count": 0,
            }
        v = float(value)
        for i, bound in enumerate(self.buckets):
            if v <= bound:
                s["buckets"][i] += 1
        s["sum"] += v
        s["count"] += 1

    def count(self, **labels) -> int:
        s = self._series.get(self._key(labels))
        return 0 if s is None else s["count"]

    def sum(self, **labels) -> float:
        s = self._series.get(self._key(labels))
        return 0.0 if s is None else s["sum"]


class MetricsRegistry:
    """Get-or-create instrument store, validated against :data:`CATALOG`."""

    def __init__(self):
        self._metrics: Dict[str, _Instrument] = {}

    # ------------------------------------------------------------ create

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Sequence[str], **kw) -> _Instrument:
        spec = CATALOG.get(name)
        if spec is None:
            raise ValueError(
                f"metric {name!r} is not in obs.metrics.CATALOG — the metric "
                f"surface is closed; add it to the catalog first"
            )
        kind, cat_help, cat_labels = spec
        if kind != cls.kind:
            raise ValueError(
                f"metric {name!r} is a {kind} in the catalog, not a {cls.kind}"
            )
        labels = tuple(labels) or cat_labels
        help = help or cat_help
        if labels != cat_labels:
            raise ValueError(
                f"metric {name!r} declares labels {labels}, catalog says "
                f"{cat_labels}"
            )
        inst = self._metrics.get(name)
        if inst is None:
            inst = self._metrics[name] = cls(name, help, labels, **kw)
        elif not isinstance(inst, cls):
            raise ValueError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"not {cls.kind}"
            )
        return inst

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    # ------------------------------------------------------------- read

    def get(self, name: str) -> Optional[_Instrument]:
        return self._metrics.get(name)

    def names(self) -> list:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """Deterministic JSON-able view: sorted names, sorted series, the
        ``repro-metrics/v1`` schema."""
        metrics = {}
        for name in sorted(self._metrics):
            inst = self._metrics[name]
            series = []
            for key in sorted(inst._series):
                entry = {"labels": dict(zip(inst.labelnames, key))}
                val = inst._series[key]
                if inst.kind == "histogram":
                    entry.update(
                        buckets=dict(zip((str(b) for b in inst.buckets),
                                         val["buckets"])),
                        sum=val["sum"], count=val["count"],
                    )
                else:
                    entry["value"] = val
                series.append(entry)
            metrics[name] = {
                "type": inst.kind,
                "help": inst.help,
                "labelnames": list(inst.labelnames),
                "series": series,
            }
            if inst.kind == "histogram":
                metrics[name]["bucket_bounds"] = list(inst.buckets)
        return {"schema": "repro-metrics/v1", "metrics": metrics}


_DEFAULT: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-wide registry: the sink for instrumentation with no
    injection point (kernel dispatch decisions).  Serving components never
    reach for it implicitly; they take ``metrics=``."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
    return _DEFAULT


class ServingInstruments:
    """All catalog instruments of one registry, registered and bound to
    attributes once at attach time, so an emission is one method call and
    an exported snapshot carries the whole declared surface (a metric that
    never fired appears with zero series)."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.requests = registry.counter("serve_requests_total")
        self.admitted = registry.counter("serve_admitted_total")
        self.shed = registry.counter("serve_shed_total")
        self.served = registry.counter("serve_served_total")
        self.deadline_misses = registry.counter("serve_deadline_misses_total")
        self.flushes = registry.counter("serve_flushes_total")
        self.flush_graphs = registry.histogram("serve_flush_graphs",
                                               buckets=SIZE_BUCKETS)
        self.latency = registry.histogram("serve_request_latency_seconds")
        self.queue_depth = registry.gauge("serve_queue_depth")
        self.open_buckets = registry.gauge("serve_open_buckets")
        self.service_ewma = registry.gauge("serve_service_ewma_seconds")
        self.ladder_refits = registry.counter("serve_ladder_refits_total")
        self.programs_built = registry.counter("serve_programs_built_total")
        self.warms = registry.counter("serve_warms_total")
        self.compile_seconds = registry.counter("serve_compile_seconds_total")
        self.warm_seconds = registry.counter("serve_warm_seconds_total")
        self.aot_cache = registry.counter("serve_aot_cache_total")
        self.cold_start = registry.gauge("serve_cold_start_seconds")
        self.device_seconds = registry.counter("serve_device_seconds_total")
        self.d2h_seconds = registry.counter("serve_d2h_seconds_total")
        self.eigvec_cache = registry.counter("serve_eigvec_cache_total")
        self.inflight_depth = registry.gauge("serve_inflight_depth")
        self.pack_ewma = registry.gauge("serve_pack_ewma_seconds")

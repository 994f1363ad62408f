"""Exporters: Prometheus text, JSON snapshots, Chrome / Perfetto traces
(port of ``repro.obs.export``; for the same calls the output is byte for
byte the JAX package's).

* :func:`prometheus_text` — the Prometheus text exposition format
  (``# HELP`` / ``# TYPE`` headers, one sample line per series,
  histograms as cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``);
* :func:`metrics_snapshot` / :func:`write_metrics_json` — the
  ``repro-metrics/v1`` JSON document, deterministically ordered;
* :func:`trace_events` / :func:`trace_json` / :func:`write_trace` — the
  Chrome trace-event JSON (``chrome://tracing``, https://ui.perfetto.dev)
  of a :class:`~repro_torch.obs.trace.Tracer`'s spans: one thread row per
  track, complete events for closed spans, instants for events.

The validators (:func:`validate_metrics_snapshot`,
:func:`validate_trace_events`) raise ``ValueError`` with a per-defect
message.
"""
from __future__ import annotations

import json

from repro_torch.obs.metrics import CATALOG, MetricsRegistry

_SCHEMA = "repro-metrics/v1"


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------


def _fmt(v) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _esc(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labelnames, key, extra=()) -> str:
    pairs = list(zip(labelnames, key)) + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_esc(v)}"' for k, v in pairs)
    return "{" + body + "}"


def prometheus_text(registry: MetricsRegistry) -> str:
    """The registry in Prometheus text exposition format (sorted names and
    series)."""
    out = []
    for name in registry.names():
        inst = registry.get(name)
        out.append(f"# HELP {name} {_esc(inst.help)}")
        out.append(f"# TYPE {name} {inst.kind}")
        for key in sorted(inst._series):
            val = inst._series[key]
            if inst.kind == "histogram":
                for bound, n in zip(inst.buckets, val["buckets"]):
                    out.append(
                        f"{name}_bucket"
                        f"{_label_str(inst.labelnames, key, [('le', _fmt(bound))])}"
                        f" {n}"
                    )
                out.append(
                    f"{name}_bucket"
                    f"{_label_str(inst.labelnames, key, [('le', '+Inf')])}"
                    f" {val['count']}"
                )
                out.append(f"{name}_sum{_label_str(inst.labelnames, key)} "
                           f"{_fmt(val['sum'])}")
                out.append(f"{name}_count{_label_str(inst.labelnames, key)} "
                           f"{val['count']}")
            else:
                out.append(f"{name}{_label_str(inst.labelnames, key)} "
                           f"{_fmt(val)}")
    return "\n".join(out) + ("\n" if out else "")


# ---------------------------------------------------------------------------
# JSON snapshot
# ---------------------------------------------------------------------------


def metrics_snapshot(registry: MetricsRegistry) -> dict:
    return registry.snapshot()


def write_metrics_json(registry: MetricsRegistry, path: str) -> None:
    with open(path, "w") as f:
        json.dump(registry.snapshot(), f, indent=2, sort_keys=True)
        f.write("\n")


def validate_metrics_snapshot(doc: dict, catalog: dict = CATALOG) -> int:
    """Schema-check one ``repro-metrics/v1`` document: every metric name
    in the closed catalog, with its type and label set.  Returns the number
    of metrics validated; raises ``ValueError``."""
    if not isinstance(doc, dict) or doc.get("schema") != _SCHEMA:
        raise ValueError(f"not a {_SCHEMA} document: schema={doc.get('schema')!r}"
                         if isinstance(doc, dict) else "metrics doc is not an object")
    metrics = doc.get("metrics")
    if not isinstance(metrics, dict):
        raise ValueError("metrics document missing 'metrics' object")
    for name, m in metrics.items():
        spec = catalog.get(name)
        if spec is None:
            raise ValueError(f"unregistered metric name {name!r} — not in "
                             f"obs.metrics.CATALOG (the surface is closed)")
        kind, _, labelnames = spec
        if m.get("type") != kind:
            raise ValueError(f"{name}: type {m.get('type')!r} != catalog {kind!r}")
        if tuple(m.get("labelnames", ())) != labelnames:
            raise ValueError(f"{name}: labelnames {m.get('labelnames')} != "
                             f"catalog {list(labelnames)}")
        for s in m.get("series", ()):
            if set(s.get("labels", {})) != set(labelnames):
                raise ValueError(f"{name}: series labels {sorted(s.get('labels', {}))} "
                                 f"!= declared {sorted(labelnames)}")
            if kind == "histogram":
                if not {"buckets", "sum", "count"} <= set(s):
                    raise ValueError(f"{name}: histogram series missing "
                                     f"buckets/sum/count: {sorted(s)}")
            elif "value" not in s:
                raise ValueError(f"{name}: series missing 'value'")
    return len(metrics)


# ---------------------------------------------------------------------------
# Chrome / Perfetto trace events
# ---------------------------------------------------------------------------

_PID = 1
_PROCESS = "repro-serve"


def _arg(v):
    return v if isinstance(v, (str, int, float, bool)) or v is None else str(v)


def trace_events(tracer) -> dict:
    """Spans as a Chrome trace-event document: thread-name metadata first
    (one row per track, in sorted track order), then events in recorded
    order.  Timestamps are microseconds on the tracer's clock, rounded to
    1 ns so float formatting is stable."""
    tracks = sorted({s.track for s in tracer.spans})
    tid = {t: i + 1 for i, t in enumerate(tracks)}
    events = [{
        "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
        "args": {"name": _PROCESS},
    }]
    for t in tracks:
        events.append({"name": "thread_name", "ph": "M", "pid": _PID,
                       "tid": tid[t], "args": {"name": t}})
    for s in tracer.spans:
        ev = {
            "name": s.name,
            "cat": s.track,
            "pid": _PID,
            "tid": tid[s.track],
            "ts": round(s.t0_s * 1e6, 3),
            "args": {k: _arg(v) for k, v in s.attrs},
        }
        if s.t1_s is None:
            ev["ph"] = "i"
            ev["s"] = "t"
        else:
            ev["ph"] = "X"
            ev["dur"] = round(s.dur_s * 1e6, 3)
        events.append(ev)
    return {"displayTimeUnit": "ms", "traceEvents": events}


def trace_json(tracer) -> str:
    """Canonical serialization (sorted keys, fixed separators): the same
    bytes for two ``VirtualClock`` runs of the same scripted trace."""
    return json.dumps(trace_events(tracer), sort_keys=True,
                      separators=(",", ":"))


def write_trace(tracer, path: str) -> None:
    with open(path, "w") as f:
        f.write(trace_json(tracer))
        f.write("\n")


def validate_trace_events(doc: dict) -> int:
    """Schema-check one trace-event document.  Returns the number of
    non-metadata events; raises ``ValueError`` on any defect."""
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        raise ValueError("trace document missing 'traceEvents' list")
    n = 0
    for i, ev in enumerate(doc["traceEvents"]):
        ph = ev.get("ph")
        if ph not in ("M", "X", "i"):
            raise ValueError(f"traceEvents[{i}]: unsupported ph {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"traceEvents[{i}]: missing name")
        if not isinstance(ev.get("pid"), int) or not isinstance(ev.get("tid"), int):
            raise ValueError(f"traceEvents[{i}]: pid/tid must be ints")
        if ph == "M":
            continue
        n += 1
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"traceEvents[{i}]: ts must be numeric")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"traceEvents[{i}]: X event needs dur >= 0")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"traceEvents[{i}]: args must be an object")
    return n


# ---------------------------------------------------------------------------
# the admission ledger, rendered for humans
# ---------------------------------------------------------------------------


def admission_line(registry: MetricsRegistry) -> str:
    """The admission ledger as one line, rendered from the registry, so the
    printout and the exported counters cannot disagree."""
    def total(name: str) -> int:
        inst = registry.get(name)
        return int(inst.total()) if inst is not None else 0

    by_reason: dict = {}
    shed = registry.get("serve_shed_total")
    if shed is not None:
        ri = shed.labelnames.index("reason")
        for key, v in sorted(shed.series().items()):
            by_reason[key[ri]] = by_reason.get(key[ri], 0) + int(v)
    line = (f"admission: served {total('serve_served_total')}  "
            f"shed {total('serve_shed_total')} ({by_reason}); "
            f"deadline misses {total('serve_deadline_misses_total')}")

    def seconds(name: str) -> float:
        inst = registry.get(name)
        return float(inst.total()) if inst is not None else 0.0

    # the untimed warm-up, split into compile (in the port: CUDA-graph
    # capture) and first-run warm; omitted when neither was paid
    compile_s = seconds("serve_compile_seconds_total")
    warm_s = seconds("serve_warm_seconds_total")
    if compile_s or warm_s:
        line += f"; untimed compile {compile_s:.2f}s + warm {warm_s:.2f}s"
    aot = registry.get("serve_aot_cache_total")
    if aot is not None and aot.total():
        ri = aot.labelnames.index("result")
        tally = {k: 0 for k in ("hit", "miss", "stale")}
        for key, v in aot.series().items():
            tally[key[ri]] = tally.get(key[ri], 0) + int(v)
        line += (f"; aot hit {tally['hit']} miss {tally['miss']} "
                 f"stale {tally['stale']}")
    return line

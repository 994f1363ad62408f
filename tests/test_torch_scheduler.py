"""The port's stream scheduler (``repro_torch.serve.scheduler``) on the CPU,
against the JAX package's.

* **Scripted simulations** (``tests/test_slo_sim.py``, the scheduler cases
  of ``tests/test_obs.py``): the same arrival trace and service-time script
  go through JAX's scheduler over ``conftest.scripted_executor`` and the
  port's over :class:`TorchScripted`, its port-side twin, on a
  ``VirtualClock``.  Flush logs, shed lists, latencies and makespans are
  equal as floats (no tolerance), the trace JSON and Prometheus text are
  the same bytes, and each JAX test's own assertions hold on the port.
  Timestamps are binary fractions, so every sum is exact.
* **Real engines** (``tests/test_stream_scheduler.py``, the scheduler cases
  of ``tests/test_executor.py``): small configs (2 layers, hidden 16, GAT 2
  heads of 8) with params converted from JAX's.  Served outputs agree with
  JAX's engine within the mirrored tests' tolerance (rtol 1e-4, atol
  1e-5), and with the port's own per-graph stream; two tenants through one
  scheduler give each tenant's solo run bit for bit.
* **Dispatch census**: a stream over N graphs of K signatures, a
  scheduler's ladders, and a two-tenant executor count
  ``kernels_dispatch_total`` exactly as JAX does (once per compiled
  program and signature), not once per request.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from conftest import scripted_executor
from repro import obs as JO
from repro.gnn import models as JM
from repro.serve.executor import Executor as JExecutor
from repro.serve.gnn_engine import GNNEngine as JEngine
from repro.serve.scheduler import StreamScheduler as JScheduler
from repro_torch import obs as TO
from repro_torch.configs.gengnn_models import get_gnn_config
from repro_torch.convert import from_jax_params
from repro_torch.core.batching import BucketBudget, pack_graphs, unpack_outputs
from repro_torch.obs import MetricsRegistry, Tracer, export
from repro_torch.obs.metrics import default_registry
from repro_torch.serve.clock import RealClock, VirtualClock
from repro_torch.serve.executor import Executor
from repro_torch.serve.gnn_engine import GNNEngine
from repro_torch.serve.scheduler import Request, Shed, StreamScheduler, _OpenBucket

torch.set_num_threads(1)

MW = 0.015625  # max_wait_s = 1/64: binary-exact
SVC = 0.00390625  # 1/256
SLOW = 0.125  # 1/8
A1 = 0.001953125  # second arrival = 1/512
DONE = A1 + SVC  # budget flush completion
BUCKETS4 = ((32, 96), (64, 192), (128, 384), (256, 768))
SERVE_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_stream_scheduler.py:81


class TorchScripted(Executor):
    """The port's twin of ``conftest.scripted_executor``: a real
    ``Executor`` (so the scheduler routes it as the multi-tenant surface)
    on the CPU whose ``run`` returns the next scripted duration, the last
    repeating; ``has_program`` is always True, so eager prewarm is a no-op."""

    def __init__(self, service_s=0.001, buckets=BUCKETS4):
        super().__init__(buckets=buckets, device="cpu")
        cfg = dataclasses.make_dataclass("Cfg", ["model", "task"])("gin", "graph")
        self.tenants["default"] = dataclasses.make_dataclass(
            "FakeTenant", ["cfg", "share_layout"])(cfg, True)
        self._script = (list(service_s) if isinstance(service_s, (list, tuple))
                        else [float(service_s)])
        self._calls = 0
        self.run_log = []

    def has_program(self, bucket_key, num_graphs, model=None):
        return True

    def warm(self, p, model=None):
        return 0.0

    def run(self, p, model=None):
        dt = self._script[min(self._calls, len(self._script) - 1)]
        self._calls += 1
        self.run_log.append((p.bucket_key, p.num_graphs, dt))
        return np.zeros((p.num_graphs, 1), np.float32), dt


def rows(records) -> list:
    """Flush records or sheds as plain tuples (the two packages' dataclasses
    differ by type, not by field)."""
    return [dataclasses.astuple(r) for r in records]


def assert_same_report(jrep, trep) -> None:
    """The port's report equals JAX's as floats: flush log, sheds,
    latencies (nan where shed), makespan, compile seconds."""
    assert rows(trep.flush_log) == rows(jrep.flush_log)
    assert rows(trep.shed) == rows(jrep.shed)
    np.testing.assert_array_equal(trep.latencies_s, jrep.latencies_s)
    assert trep.makespan_s == jrep.makespan_s
    assert trep.compile_s == jrep.compile_s
    assert [o is None for o in trep.outputs] == [o is None for o in jrep.outputs]


class Twin:
    """The same scheduler configuration over both scripted executors;
    ``run`` serves one trace through both, asserts the reports equal, and
    returns the port's.  ``tracer=True`` / ``metrics=True`` give each side
    its own sink; a ``clock`` is the port's, JAX's starts at its time."""

    def __init__(self, script=0.001, buckets=BUCKETS4, **kw):
        self.jex = scripted_executor(service_s=script, buckets=buckets)
        self.tex = TorchScripted(service_s=script, buckets=buckets)
        from repro.serve.clock import VirtualClock as JClock

        lit = {k: kw.pop(k, False) for k in ("tracer", "metrics")}
        jkw, tkw = dict(kw), dict(kw)
        if lit["tracer"]:
            jkw["tracer"], tkw["tracer"] = JO.Tracer(JClock()), TO.Tracer(VirtualClock())
        if lit["metrics"]:
            jkw["metrics"], tkw["metrics"] = JO.MetricsRegistry(), MetricsRegistry()
        if "clock" in kw:
            jkw["clock"] = JClock(kw["clock"].now())
        self.j = JScheduler(self.jex, **jkw)
        self.t = StreamScheduler(self.tex, **tkw)

    def run(self, graphs, **run_kw):
        jrep = self.j.run(graphs, **run_kw)
        trep = self.t.run(graphs, **run_kw)
        assert_same_report(jrep, trep)
        assert self.tex.run_log == self.jex.run_log
        return trep


def twin(script=0.001, **kw) -> Twin:
    """``Twin`` with ``tests/test_slo_sim.py``'s defaults: capacity 4,
    max_wait_s = 1/64; ``script`` is the executors' service times."""
    kw.setdefault("capacity", 4)
    kw.setdefault("max_wait_s", MW)
    return Twin(script=script, **kw)


def graph(n=8, e=12, feat=4, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, n, e).astype(np.int32),
        rng.integers(0, n, e).astype(np.int32),
        rng.normal(size=(n, feat)).astype(np.float32),
        rng.normal(size=(e, 3)).astype(np.float32),
    )


# ------------------------------------------------------------ virtual clock


def test_virtual_clock_is_explicit_and_monotone():
    c = VirtualClock()
    assert c.now() == 0.0
    assert c.advance_to(1.5) == 1.5
    assert c.advance(0.25) == 1.75
    with pytest.raises(ValueError, match="backwards"):
        c.advance_to(1.0)
    with pytest.raises(ValueError, match="negative"):
        c.advance(-0.1)
    assert c.now() == 1.75


def test_real_clock_moves_forward():
    c = RealClock()
    a = c.now()
    assert c.now() >= a


# ----------------------------------------------------- exact flush timing


def test_exact_flush_times_and_latencies():
    s = twin(script=SVC)
    arrivals = [0.0, 0.0009765625, 0.0625]
    rep = s.run([graph(seed=i) for i in range(3)], arrivals=arrivals)
    assert rep.num_served == 3 and rep.num_shed == 0
    f0, f1 = rep.flush_log
    assert f0.rids == (0, 1) and f0.reason == "deadline"
    assert (f0.at_s, f0.start_s, f0.done_s) == (MW, MW, MW + SVC)
    assert f1.rids == (2,) and f1.reason == "drain"
    assert (f1.at_s, f1.start_s, f1.done_s) == (
        0.0625 + MW, 0.0625 + MW, 0.0625 + MW + SVC)
    expect = np.array([MW + SVC, MW + SVC - 0.0009765625, MW + SVC])
    assert np.array_equal(rep.latencies_s, expect)
    assert rep.flush_reasons == {"deadline": 1, "drain": 1}
    assert rep.compute_s == 2 * SVC
    assert rep.makespan_s == f1.done_s


def test_simulation_is_bitwise_reproducible():
    def once():
        s = twin(script=[SLOW, SVC, SVC], slo_s=0.25, admit_limit=6)
        graphs = [graph(n=6 + i % 9, e=9 + (i * 5) % 13, seed=i) for i in range(12)]
        return s.run(graphs, arrivals=[i * 0.0078125 for i in range(12)],
                     priorities=[i % 2 for i in range(12)])

    a, b = once(), once()
    assert a.flush_log == b.flush_log and a.shed == b.shed
    assert np.array_equal(a.latencies_s, b.latencies_s, equal_nan=True)
    assert (a.batch_sizes, a.flush_reasons, a.deadline_misses, a.makespan_s) == (
        b.batch_sizes, b.flush_reasons, b.deadline_misses, b.makespan_s)
    assert a.num_shed > 0  # the trace exercises shedding


def test_injected_clock_chains_runs_on_one_timeline():
    clock = VirtualClock()
    s = twin(script=SVC, clock=clock)
    rep1 = s.run([graph()], arrivals=[0.0])
    assert clock.now() == rep1.flush_log[0].done_s
    rep2 = s.run([graph(seed=1)])
    assert rep2.flush_log[0].at_s == rep1.flush_log[0].done_s + MW


def test_scripted_arrivals_are_validated():
    s = twin().t
    with pytest.raises(ValueError, match="stamp every graph"):
        s.run([graph(), graph(seed=1)], arrivals=[0.0])
    with pytest.raises(ValueError, match="non-decreasing"):
        s.run([graph(), graph(seed=1)], arrivals=[1.0, 0.5])
    with pytest.raises(ValueError, match="predates the clock"):
        s.run([graph()], arrivals=[-1.0], qps=0.0)


def test_constructor_validation_matches_jax():
    for kw, needle in ((dict(capacity=0), "capacity"),
                       (dict(prewarm="sometimes"), "prewarm"),
                       (dict(admit_limit=0), "admit_limit"),
                       (dict(admit_margin=1.5), "admit_margin"),
                       (dict(refit_every=0), "refit_every"),
                       (dict(max_rungs=1), "max_rungs"),
                       (dict(svc_alpha=0.0), "svc_alpha")):
        with pytest.raises(ValueError, match=needle) as want:
            JScheduler(scripted_executor(), **kw)
        with pytest.raises(ValueError, match=needle) as got:
            StreamScheduler(TorchScripted(), **kw)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------- priority ordering


def test_priority_orders_flushes_when_both_ready():
    s = twin(script=SLOW)
    rep = s.run([graph(seed=0), graph(seed=1)], arrivals=[0.0, 0.0],
                priorities=[1, 0])
    f0, f1 = rep.flush_log
    assert f0.rids == (1,) and f0.priority == 0
    assert f1.rids == (0,) and f1.priority == 1
    assert (f0.at_s, f0.done_s) == (MW, MW + SLOW)
    assert (f1.at_s, f1.start_s, f1.done_s) == (MW + SLOW, MW + SLOW, MW + 2 * SLOW)
    assert rep.latencies_s[1] < rep.latencies_s[0]


def test_same_priority_ties_break_by_bucket_age():
    s = twin(script=SLOW, capacity=1)
    rep = s.run([graph(n=8, e=12), graph(n=40, e=60, seed=1)], arrivals=[0.0, 0.0])
    assert [f.rids for f in rep.flush_log] == [(0,), (1,)]


# ------------------------------------------------ shedding / backpressure


def test_backlog_shed_is_typed_and_exact():
    s = twin(script=SLOW, slo_s=0.2)
    rep = s.run([graph(seed=i) for i in range(3)], arrivals=[0.0, 0.03125, 0.25])
    assert rep.flush_log[0].done_s == MW + SLOW
    assert rep.shed == [Shed(rid=1, model=None, priority=0, reason="backlog",
                             at_s=0.03125,
                             projected_delay_s=(MW + SLOW - 0.03125) + SLOW,
                             slo_s=0.2)]
    assert rep.outputs[1] is None and math.isnan(rep.latencies_s[1])
    assert rep.outputs[2] is not None and rep.deadline_misses == 0
    assert rep.num_served + rep.num_shed == rep.num_requests == 3


def test_queue_full_shed_bounds_admitted_queue():
    s = twin(script=SVC, admit_limit=2, max_wait_s=1.0)
    rep = s.run([graph(seed=i) for i in range(4)], arrivals=[0.0] * 4)
    assert [x.rid for x in rep.shed] == [2, 3]
    assert all(x.reason == "queue_full" for x in rep.shed)
    assert rep.num_served == 2 and sum(rep.batch_sizes) == 2
    assert rep.flush_log[0].rids == (0, 1)


def test_backlog_shed_counts_admitted_unflushed_work():
    s = twin(capacity=1, max_wait_s=1.0, slo_s=0.25, service_s=0.125)
    rep = s.run([graph(seed=i) for i in range(5)], arrivals=[0.0] * 5,
                priorities=[0, 1, 2, 3, 4])
    assert [x.rid for x in rep.shed] == [2, 3, 4]
    assert all(x.reason == "backlog" for x in rep.shed)
    assert [x.projected_delay_s for x in rep.shed] == [0.125 * 3] * 3
    assert rep.num_served == 2


def test_admit_margin_guard_band_sheds_earlier():
    def trace(margin):
        s = twin(capacity=1, max_wait_s=1.0, slo_s=0.25, service_s=0.125,
                 admit_margin=margin)
        return s.run([graph(seed=0), graph(seed=1)], arrivals=[0.0, 0.0],
                     priorities=[0, 1])

    assert trace(1.0).num_shed == 0
    guarded = trace(0.5)
    assert [x.rid for x in guarded.shed] == [1]
    assert guarded.shed[0].slo_s == 0.25


def test_slo_by_class_beats_default_and_wildcard():
    pair = twin(slo_s=1.0, slo_by_class={(None, 1): 0.5, ("default", 1): 0.25})
    for s in (pair.j, pair.t):
        assert s.resolve_slo_s("default", 0) == 1.0
        assert s.resolve_slo_s("other", 1) == 0.5
        assert s.resolve_slo_s("default", 1) == 0.25
    assert twin().t.resolve_slo_s("default", 0) == math.inf


def test_best_effort_requests_are_never_shed():
    s = twin(script=SLOW)
    rep = s.run([graph(seed=i) for i in range(6)],
                arrivals=[i * 0.0078125 for i in range(6)])
    assert rep.num_shed == 0 and rep.num_served == 6


def test_deadline_miss_is_counted_not_hidden():
    s = twin(script=SLOW, slo_s=0.0625)
    rep = s.run([graph()], arrivals=[0.0])
    assert rep.num_served == 1 and rep.num_shed == 0
    assert rep.latencies_s[0] == MW + SLOW
    assert rep.deadline_misses == 1


def test_slo_tightens_bucket_deadline_below_max_wait():
    s = twin(script=[SVC, SVC], slo_s=0.0078125, service_s=SVC)
    rep = s.run([graph()], arrivals=[0.0])
    f = rep.flush_log[0]
    assert f.at_s == 0.0078125 - SVC
    assert f.done_s == 0.0078125
    assert rep.deadline_misses == 0


# ------------------------------------------- flush-reason classification


def test_deadline_vs_drain_at_exactly_deadline_arrival():
    s = twin(script=SVC)
    rep = s.run([graph(seed=0), graph(seed=1)], arrivals=[0.0, MW])
    f0, f1 = rep.flush_log
    assert f0.rids == (0,) and f0.reason == "deadline" and f0.at_s == MW
    assert f1.rids == (1,) and f1.reason == "drain" and f1.at_s == 2 * MW


def test_drain_only_when_stream_exhausted():
    s = twin(script=SVC)
    rep = s.run([graph(seed=i) for i in range(3)], arrivals=[0.0, 0.0625, 0.125])
    assert [f.reason for f in rep.flush_log] == ["deadline", "deadline", "drain"]


# --------------------------------------------------- empty / all-shed runs


def test_percentile_on_empty_report_is_nan_not_crash():
    rep = twin().run([])
    assert rep.num_requests == 0
    assert math.isnan(rep.percentile_ms(50)) and math.isnan(rep.percentile_ms(99))
    assert rep.graphs_per_s == 0.0


def test_percentile_when_everything_shed_is_nan():
    s = twin(slo_s=0.001, service_s=0.01)
    rep = s.run([graph(seed=i) for i in range(3)], arrivals=[0.0] * 3)
    assert rep.num_shed == 3 and rep.num_served == 0
    assert all(x.reason == "backlog" for x in rep.shed)
    assert math.isnan(rep.percentile_ms(99))
    assert rep.batch_sizes == [] and rep.flush_log == []


# ----------------------------------------------------- adaptive ladder


def test_adaptive_ladder_closes_unused_rungs_deterministically():
    s = twin(script=SVC, capacity=8, adapt_ladder=True, refit_every=3)
    rep = s.run([graph(seed=i) for i in range(3)], arrivals=[0.0, 0.25, 0.5])
    assert rep.num_served == 3
    assert s.t.ladder_multiples((32, 96)) == s.j.ladder_multiples((32, 96)) == [1, 8]
    rep2 = s.run([graph(seed=9)], arrivals=[0.0])
    assert rep2.num_served == 1 and rep2.flush_log[0].rung_multiple == 1


def test_refit_never_strands_an_open_bucket():
    s = twin(script=SVC, capacity=8, adapt_ladder=True, refit_every=2,
             max_wait_s=1.0)
    small = [graph(seed=i) for i in range(3)]
    big = graph(n=40, e=60, seed=7)
    rep = s.run([big, *small], arrivals=[0.0, 0.0, 0.25, 0.5])
    assert rep.num_served == 4 and rep.num_served + rep.num_shed == 4
    assert sorted(r for f in rep.flush_log for r in f.rids) == [0, 1, 2, 3]


def test_adaptive_ladder_opens_observed_midpoints():
    s = twin(script=SVC, capacity=8, adapt_ladder=True, refit_every=2,
             max_wait_s=1.0)
    batch = [graph(n=16, e=24, seed=i) for i in range(10)]
    rep = s.run(batch + batch, arrivals=[0.0] * 10 + [2.0] * 10)
    assert rep.num_served == 20
    assert 5 in s.t.ladder_multiples((32, 96))
    assert s.t.ladder_multiples((32, 96)) == s.j.ladder_multiples((32, 96))
    assert s.t.ladder_multiples((32, 96))[-1] == 8


# -------------------------------------------------- telemetry (test_obs.py)


def run_budget_flush(tracer=False, metrics=False):
    """Two arrivals fill one capacity-1 bucket: one ``budget`` flush at the
    second arrival, through both schedulers."""
    s = Twin(script=SVC, capacity=1, max_wait_s=MW, tracer=tracer,
             metrics=metrics)
    rep = s.run([graph(seed=0), graph(seed=1)], arrivals=[0.0, A1])
    return s, rep


def spans_by_name(tracer, name):
    return [s for s in tracer.spans if s.name == name]


def test_scripted_run_emits_exact_span_boundaries():
    s, rep = run_budget_flush(tracer=True)
    tracer = s.t.tracer
    assert rep.num_served == 2 and rep.flush_reasons == {"budget": 1}
    assert [(x.name, x.track) for x in tracer.spans] == [
        ("admit", "scheduler"), ("admit", "scheduler"),
        ("pack", "host"), ("unpack", "host"),
        ("queue", "scheduler"), ("queue", "scheduler"),
        ("flush", "scheduler"), ("device", "device"),
        ("respond", "scheduler"), ("respond", "scheduler"),
    ]
    q0, q1 = spans_by_name(tracer, "queue")
    assert (q0.t0_s, q0.t1_s) == (0.0, A1) and (q1.t0_s, q1.t1_s) == (A1, A1)
    (pack,), (fl,) = spans_by_name(tracer, "pack"), spans_by_name(tracer, "flush")
    assert (pack.t0_s, pack.t1_s) == (A1, A1)
    assert dict(pack.attrs) == {"tenant": "default", "graphs": 2, "rung": 1}
    assert (fl.t0_s, fl.t1_s) == (A1, DONE)
    assert dict(fl.attrs) == {"tenant": "default", "priority": 0, "reason": "budget",
                              "graphs": 2, "sig": str((32, 96)), "rung": 1}
    r0, r1 = spans_by_name(tracer, "respond")
    assert dict(r1.attrs) == {"rid": 1, "latency_s": DONE - A1, "miss": False}
    # the same bytes as JAX's trace of the same run
    assert export.trace_json(tracer) == JO.export.trace_json(s.j.tracer)


def test_scripted_run_counts_exactly_in_the_registry():
    s, rep = run_budget_flush(metrics=True)
    reg = s.t.metrics
    lab = dict(tenant="default", priority="0")
    assert reg.get("serve_requests_total").value(**lab) == 2
    assert reg.get("serve_admitted_total").value(**lab) == 2
    assert reg.get("serve_served_total").value(**lab) == 2
    assert reg.get("serve_shed_total").total() == 0
    assert reg.get("serve_flushes_total").value(reason="budget") == 1
    fg = reg.get("serve_flush_graphs")
    assert (fg.count(), fg.sum()) == (1, 2.0)
    lat = reg.get("serve_request_latency_seconds")
    assert lat.count(**lab) == 2 and lat.sum(**lab) == DONE + (DONE - A1)
    assert reg.get("serve_service_ewma_seconds").value(sig="32x96") == SVC
    assert reg.get("serve_queue_depth").value() == 0
    assert reg.get("serve_served_total").total() == rep.num_served
    assert export.prometheus_text(reg) == JO.export.prometheus_text(s.j.metrics)


def test_shed_and_miss_events_reach_tracer_registry_and_ledger():
    s = Twin(script=SVC, capacity=1, max_wait_s=MW, admit_limit=1,
             slo_s=0.001, tracer=True, metrics=True)
    rep = s.run([graph(seed=i) for i in range(3)], arrivals=[0.0, 0.0, 0.0])
    assert rep.num_served == 1 and rep.num_shed == 2 and rep.deadline_misses == 1
    assert [x.reason for x in rep.shed] == ["queue_full", "queue_full"]
    sheds = spans_by_name(s.t.tracer, "shed")
    assert [(x.t0_s, dict(x.attrs)["rid"]) for x in sheds] == [(0.0, 1), (0.0, 2)]
    (resp,) = spans_by_name(s.t.tracer, "respond")
    assert dict(resp.attrs)["miss"] is True
    assert export.admission_line(s.t.metrics) == (
        "admission: served 1  shed 2 ({'queue_full': 2}); deadline misses 1")
    assert export.trace_json(s.t.tracer) == JO.export.trace_json(s.j.tracer)


def test_trace_json_is_bitwise_identical_across_runs():
    docs, snaps = [], []
    for _ in range(2):
        s, _ = run_budget_flush(tracer=True, metrics=True)
        docs.append(export.trace_json(s.t.tracer))
        snaps.append(export.prometheus_text(s.t.metrics))
    assert docs[0] == docs[1] and snaps[0] == snaps[1]


def test_disabled_telemetry_is_provably_free():
    graphs = [graph(seed=i) for i in range(6)]
    arrivals = [0.0, A1, 2 * A1, 3 * A1, MW, MW + A1]
    kw = dict(capacity=2, max_wait_s=MW, slo_s=0.125, admit_limit=3)
    on = Twin(script=SVC, tracer=True, metrics=True, **kw)
    off = Twin(script=SVC, **kw)
    rep_on, rep_off = on.run(graphs, arrivals=arrivals), off.run(graphs, arrivals=arrivals)
    assert rep_on.flush_log == rep_off.flush_log and rep_on.shed == rep_off.shed
    np.testing.assert_array_equal(rep_on.latencies_s, rep_off.latencies_s)
    assert on.tex.run_log == off.tex.run_log


def test_metrics_snapshot_golden_schema_and_validation():
    s, _ = run_budget_flush(metrics=True)
    doc = s.t.metrics.snapshot()
    assert doc["schema"] == "repro-metrics/v1"
    assert export.validate_metrics_snapshot(doc) == len(doc["metrics"])
    assert doc["metrics"]["serve_served_total"]["series"] == [
        {"labels": {"tenant": "default", "priority": "0"}, "value": 2.0}]
    doc["metrics"]["serve_rogue_total"] = {
        "type": "counter", "help": "", "labelnames": [], "series": []}
    with pytest.raises(ValueError, match="unregistered"):
        export.validate_metrics_snapshot(doc)


def test_prometheus_text_exposition():
    s, _ = run_budget_flush(metrics=True)
    text = export.prometheus_text(s.t.metrics)
    assert 'serve_served_total{tenant="default",priority="0"} 2' in text
    assert 'serve_flushes_total{reason="budget"} 1' in text
    assert 'serve_flush_graphs_bucket{le="+Inf"} 1' in text
    assert "serve_flush_graphs_count 1" in text


def test_trace_event_export_golden_schema():
    s, _ = run_budget_flush(tracer=True)
    doc = export.trace_events(s.t.tracer)
    assert export.validate_trace_events(doc) == len(s.t.tracer.spans)
    flush = next(e for e in doc["traceEvents"] if e["ph"] == "X" and e["name"] == "flush")
    assert flush["ts"] == round(A1 * 1e6, 3) and flush["dur"] == round(SVC * 1e6, 3)
    assert doc == JO.export.trace_events(s.j.tracer)


def test_svc_alpha_is_a_real_knob_with_exact_ewma():
    script = [SVC, 2 * SVC, 4 * SVC]
    for alpha in (0.5, 0.25, 1.0):
        s = Twin(script=script, capacity=1, max_wait_s=MW, svc_alpha=alpha,
                 metrics=True)
        s.run([graph(seed=i) for i in range(3)], arrivals=[0.0, 0.0625, 0.125])
        ewma = script[0]
        for dt in script[1:]:
            ewma = (1.0 - alpha) * ewma + alpha * dt
        assert s.t.service_estimate_s((32, 96)) == ewma == s.j.service_estimate_s((32, 96))
        assert s.t.metrics.get("serve_service_ewma_seconds").value(sig="32x96") == ewma


# ------------------------------------------------------------ real engines


def small_config(model):
    small = dict(num_layers=2, hidden=16, heads=2, head_features=8)
    jcfg = (JM.paper_config("gin", virtual_node=True, **small) if model == "gin_vn"
            else JM.paper_config(model, **small))
    return jcfg, get_gnn_config(model, **small)


def converted(jcfg, seed=0):
    jp = JM.init(jax.random.PRNGKey(seed), jcfg)
    return jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp))


def raw_graphs(n_graphs=10, nodes=(6, 16), feat=9, edge=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        n = int(rng.integers(*nodes))
        e = int(rng.integers(n, 2 * n))
        out.append((rng.integers(0, n, e).astype(np.int32),
                    rng.integers(0, n, e).astype(np.int32),
                    rng.normal(size=(n, feat)).astype(np.float32),
                    rng.normal(size=(e, edge)).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def gin():
    """(port engine, JAX engine) of one small fused GIN, same params."""
    jcfg, tcfg = small_config("gin")
    jp, tp = converted(jcfg)
    return (GNNEngine(tcfg, tp, fused=True, device="cpu"),
            JEngine(jcfg, jp, fused=True))


@pytest.fixture(scope="module")
def gin_scheduler(gin):
    return StreamScheduler(gin[0], capacity=2, max_wait_s=0.002)


def test_pack_unpack_node_level_roundtrip():
    graphs = raw_graphs(3)
    packed, meta = pack_graphs(graphs, BucketBudget(64, 128, 4))
    per_graph = unpack_outputs(packed.node_feat.numpy(), meta, level="node")
    for i, g in enumerate(graphs):
        np.testing.assert_array_equal(per_graph[i], g[2])


def test_pack_rejects_over_budget():
    with pytest.raises(ValueError, match="exceeds budget"):
        pack_graphs(raw_graphs(3, nodes=(30, 31)), BucketBudget(32, 96, 8))
    with pytest.raises(ValueError, match="exceeds budget"):
        pack_graphs(raw_graphs(3), BucketBudget(64, 128, 2))


def test_scheduler_outputs_match_per_graph_stream(gin, gin_scheduler):
    eng, jeng = gin
    graphs = raw_graphs(10)
    outs, _, _ = eng.infer_stream(graphs)
    want, _, _ = jeng.infer_stream(graphs)
    rep = gin_scheduler.run(graphs, qps=0.0)
    assert rep.num_requests == 10
    for i in range(10):
        np.testing.assert_allclose(rep.outputs[i], outs[i], **SERVE_TOL)
        np.testing.assert_allclose(rep.outputs[i], np.asarray(want[i]), **SERVE_TOL)
    assert max(rep.batch_sizes) > 1 and sum(rep.batch_sizes) == 10


def test_scheduler_zero_recompiles_after_warmup(gin, gin_scheduler):
    eng = gin[0]
    graphs = raw_graphs(10, seed=1)
    gin_scheduler.run(graphs, qps=0.0)
    untimed, n_records = eng.compile_seconds + eng.warm_seconds, len(eng._compiled)
    for qps in (0.0, 500.0, 5000.0):
        assert gin_scheduler.run(graphs, qps=qps).compile_s == 0.0
    assert eng.compile_seconds + eng.warm_seconds == untimed
    assert len(eng._compiled) == n_records


def test_scheduler_deadline_flushes_singletons_at_low_load(gin, gin_scheduler):
    rep = gin_scheduler.run(raw_graphs(5), qps=10.0)
    assert rep.batch_sizes == [1] * 5
    assert rep.flush_reasons["deadline"] + rep.flush_reasons["drain"] == 5
    assert float(rep.latencies_s.min()) >= gin_scheduler.max_wait_s


def test_scheduler_budget_flush_on_overflow(gin):
    sched = StreamScheduler(gin[0], capacity=2, max_wait_s=10.0)
    rep = sched.run(raw_graphs(5, nodes=(28, 31), seed=2), qps=0.0)
    assert rep.flush_reasons["budget"] >= 2
    assert max(rep.batch_sizes) == 2


def test_rung_selection_prefers_smallest_fit(gin):
    eng = gin[0]
    sched = StreamScheduler(eng, capacity=4)
    req = Request(rid=0, graph=raw_graphs(1)[0], arrival_s=0.0)
    key, ladder = sched.ladder_for(req)
    assert [b.n_pad for b in ladder] == [k * key[0] for k in (1, 2, 3, 4)]
    bucket = _OpenBucket(ladder, 0.0, 1.0)
    bucket.add(req)
    assert bucket.rung() == ladder[0]
    for b in ladder:  # every rung is warm for this tenant
        assert ("packed", b.n_pad, b.e_pad, b.g_pad) in eng._compiled
        assert eng.executor.has_program(("packed", b.n_pad, b.e_pad, b.g_pad), b.g_pad)


def test_scheduler_accepts_edge_featureless_graphs():
    jcfg = JM.paper_config("gcn", edge_dim=1, num_layers=2, hidden=16)
    _, tp = converted(jcfg)
    eng = GNNEngine(get_gnn_config("gcn", edge_dim=1, num_layers=2, hidden=16), tp,
                    device="cpu")
    graphs = [g[:3] for g in raw_graphs(4, seed=5)]
    rep = StreamScheduler(eng, capacity=2).run(graphs, qps=0.0)
    assert rep.num_requests == 4 and all(o.shape == (1, 1) for o in rep.outputs)


def test_latencies_include_queueing_delay(gin, gin_scheduler):
    rep = gin_scheduler.run(raw_graphs(12, seed=4), qps=0.0)
    assert float(rep.latencies_s.max()) >= rep.compute_s * 0.9
    assert rep.makespan_s > 0 and rep.graphs_per_s > 0


def test_disabled_telemetry_adds_zero_program_records(gin):
    """A real engine builds the same program records with and without
    telemetry; the lit run's executor accounting lands in the sinks."""
    jcfg, tcfg = small_config("gin")
    _, tp = converted(jcfg)
    graphs = [graph(seed=i, feat=9, e=16) for i in range(4)]
    keys = []
    for telemetry in (False, True):
        eng = GNNEngine(tcfg, tp, device="cpu")
        kw = {}
        if telemetry:
            tracer, reg = Tracer(VirtualClock()), MetricsRegistry()
            kw = dict(tracer=tracer, metrics=reg)
        rep = StreamScheduler(eng, capacity=2, max_wait_s=MW, **kw).run(
            graphs, arrivals=[0.0, A1, 2 * A1, 3 * A1])
        keys.append(set(eng._compiled))
    assert keys[0] == keys[1] and keys[0]
    assert reg.get("serve_programs_built_total").value() == len(keys[1])
    assert reg.get("serve_warms_total").value() == len(keys[1])
    assert reg.get("serve_warm_seconds_total").value() > 0
    assert reg.get("serve_device_seconds_total").value() == rep.compute_s
    assert spans_by_name(tracer, "program_build") and spans_by_name(tracer, "warm")
    assert len(spans_by_name(tracer, "executor_run")) == len(rep.flush_log)


# ------------------------------------------------- tenants (test_executor.py)


def test_two_tenants_one_scheduler_match_solo_runs():
    """gcn@int8 + gat@fp32 through one executor and one scheduler: each
    tenant's outputs equal its solo scheduler run bit for bit and JAX's
    engine within the int8 noise bound / SERVE_TOL; a second pass warms
    nothing; the program records do not cross tenants."""
    (jcfg_a, cfg_a), (jcfg_b, cfg_b) = small_config("gcn"), small_config("gat")
    (jp_a, tp_a), (jp_b, tp_b) = converted(jcfg_a), converted(jcfg_b, 1)
    graphs = raw_graphs(8, nodes=(5, 14))
    ex = Executor(buckets=((16, 32),), device="cpu")
    ex.register("gcn8", cfg_a, tp_a, precision="int8")
    ex.register("gat32", cfg_b, tp_b)
    sched = StreamScheduler(ex, capacity=2)
    assert sched.prewarm == "lazy"
    models = ["gcn8" if i % 2 == 0 else "gat32" for i in range(len(graphs))]
    rep = sched.run(graphs, qps=0.0, models=models)
    untimed = ex.untimed_seconds
    rep2 = sched.run(graphs, qps=0.0, models=models)
    assert rep2.compile_s == 0.0 and ex.untimed_seconds == untimed
    for o, o2 in zip(rep.outputs, rep2.outputs):
        np.testing.assert_array_equal(o, o2)
    for name, jcfg, cfg, jp, tp, precision in [
            ("gcn8", jcfg_a, cfg_a, jp_a, tp_a, "int8"),
            ("gat32", jcfg_b, cfg_b, jp_b, tp_b, "fp32")]:
        mine_g = [g for g, m in zip(graphs, models) if m == name]
        solo = StreamScheduler(GNNEngine(cfg, tp, buckets=((16, 32),), precision=precision,
                                         device="cpu"), capacity=2)
        srep = solo.run(mine_g, qps=0.0)
        mine = [o for o, m in zip(rep.outputs, models) if m == name]
        for i, (a, b) in enumerate(zip(mine, srep.outputs)):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} graph {i}")
        want, _, _ = JEngine(jcfg, jp, buckets=((16, 32),),
                             precision=precision).infer_stream(mine_g)
        got, want = np.concatenate(mine), np.concatenate([np.asarray(w) for w in want])
        if precision == "fp32":
            np.testing.assert_allclose(got, want, **SERVE_TOL)
        else:
            fp32, _, _ = JEngine(jcfg, jp, buckets=((16, 32),)).infer_stream(mine_g)
            noise = np.abs(want - np.concatenate(fp32)).mean()
            assert np.abs(got - want).mean() <= 0.2 * noise + 1e-5
    keys_a = {k for k in ex._compiled if k[0] == ex.tenant("gcn8").program_key}
    keys_b = {k for k in ex._compiled if k[0] == ex.tenant("gat32").program_key}
    assert keys_a and keys_b and not (keys_a & keys_b)
    assert keys_a | keys_b == set(ex._compiled)


def test_scheduler_rejects_mismatched_model_tags():
    _, tcfg = small_config("gin")
    _, tp = converted(small_config("gin")[0])
    sched = StreamScheduler(GNNEngine(tcfg, tp, buckets=((16, 32),), device="cpu"),
                            capacity=2)
    with pytest.raises(ValueError, match="must tag every graph"):
        sched.run(raw_graphs(3), models=["default"])


def test_scheduler_rejects_untagged_multitenant_stream_up_front():
    jcfg, tcfg = small_config("gin")
    ex = Executor(buckets=((16, 32),), device="cpu")
    ex.register("a", tcfg, converted(jcfg)[1])
    ex.register("b", tcfg, converted(jcfg, 1)[1])
    sched = StreamScheduler(ex, capacity=2)
    graphs = raw_graphs(3)
    with pytest.raises(ValueError, match="untagged requests are ambiguous"):
        sched.run(graphs)
    with pytest.raises(ValueError, match="untagged requests are ambiguous"):
        sched.run(graphs, models=["a", None, "b"])


def test_second_same_architecture_tenant_prewarms_its_own_ladder():
    """Program records are shared, captured graphs are per tenant: the
    readiness check is per tenant, so the eager prewarm of a second GIN
    tenant warms its own rungs before its stream."""
    jcfg, tcfg = small_config("gin")
    ex = Executor(buckets=((16, 32),), device="cpu")
    a = GNNEngine(tcfg, converted(jcfg)[1], executor=ex, name="a")
    b = GNNEngine(tcfg, converted(jcfg, 1)[1], executor=ex, name="b")
    graphs = raw_graphs(4, nodes=(5, 14))
    StreamScheduler(a, capacity=2).run(graphs, qps=0.0)
    rungs = [("packed", 16 * k, 32 * k, 2 * k) for k in (1, 2)]
    assert all(ex.has_program(r, r[3], model="a") for r in rungs)
    assert not any(ex.has_program(r, r[3], model="b") for r in rungs)
    StreamScheduler(b, capacity=2).prewarm_ladders(graphs[:1])
    assert all(ex.has_program(r, r[3], model="b") for r in rungs)
    rep = StreamScheduler(b, capacity=2).run(graphs, qps=0.0)
    assert rep.compile_s == 0.0


def test_share_layout_false_is_refused():
    """The per-call-sort path is no longer refused: a ``share_layout=False``
    tenant registers and serves its stream through the scheduler bit for
    bit the shared (unfused) tenant; the facade still defaults to the
    shared plan."""
    jcfg, tcfg = small_config("gin")
    ex = Executor(buckets=((16, 32),), device="cpu")
    ex.register("m", tcfg, converted(jcfg)[1], share_layout=False)
    ex.register("s", tcfg, converted(jcfg)[1])
    assert not ex.tenant("m").share_layout
    graphs = raw_graphs(4, nodes=(5, 14))
    a = StreamScheduler(ex, capacity=2).run(graphs, qps=0.0, models=["m"] * 4)
    b = StreamScheduler(ex, capacity=2).run(graphs, qps=0.0, models=["s"] * 4)
    for x, y in zip(a.outputs, b.outputs):
        np.testing.assert_array_equal(x, y)
    assert GNNEngine(tcfg, converted(jcfg)[1], device="cpu").share_layout is True


# ------------------------------------------------------------ dispatch census


def _census(reg) -> dict:
    return dict(reg.counter("kernels_dispatch_total").series())


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def census_of(fn, reg) -> dict:
    before = _census(reg)
    fn()
    return _delta(_census(reg), before)


@pytest.mark.parametrize("model,precision", [("gin", "fp32"), ("gin", "int8"),
                                             ("gat", "fp32"), ("dgn", "fp32")])
def test_stream_census_counts_signatures_not_requests(model, precision):
    """``infer_stream`` over N graphs of K signatures: the port counts K
    forwards, as JAX counts K compiled programs (the parent counted N + K:
    one at warm and one per request)."""
    jcfg, tcfg = small_config(model)
    jp, tp = converted(jcfg)
    buckets = ((16, 32), (32, 64))
    graphs = raw_graphs(9, nodes=(5, 24), seed=3)
    eig = model == "dgn"
    eng = GNNEngine(tcfg, tp, buckets=buckets, precision=precision, fused=True,
                    device="cpu")
    jeng = JEngine(jcfg, jp, buckets=buckets, precision=precision, fused=True)
    got = census_of(lambda: eng.infer_stream(graphs, with_eigvec=eig),
                    default_registry())
    want = census_of(lambda: jeng.infer_stream(graphs, with_eigvec=eig),
                     JO.default_registry())
    k = len({eng.executor.prepare_stream(g).signature for g in graphs})
    assert k == 2 and got == want
    one = census_of(lambda: eng.infer_stream(graphs[:1], with_eigvec=eig),
                    default_registry())
    assert one == {}  # warm already: a served request counts nothing


def test_scheduler_and_two_tenant_census_match_jax():
    """Two tenants of one architecture (one JAX warm key each program and
    signature: counted once) plus a GAT tenant, through one scheduler with
    eager ladders: the census equals JAX's op for op."""
    (jg, tg), (ja, ta) = small_config("gin"), small_config("gat")
    graphs = raw_graphs(12, nodes=(5, 14), seed=6)
    models = [("a", "b", "g")[i % 3] for i in range(len(graphs))]

    def serve(ex_cls, cfgs, params, sched_cls, **ex_kw):
        ex = ex_cls(buckets=((16, 32),), **ex_kw)
        for name, cfg, p in zip(("a", "b", "g"), cfgs, params):
            ex.register(name, cfg, p, fused=True)
        sched = sched_cls(ex, capacity=2, prewarm="eager")
        return lambda: [sched.run(graphs, qps=0.0, models=models) for _ in range(2)]

    jps = [converted(jg)[0], converted(jg)[0], converted(ja, 1)[0]]
    tps = [converted(jg)[1], converted(jg)[1], converted(ja, 1)[1]]
    want = census_of(serve(JExecutor, (jg, jg, ja), jps, JScheduler),
                     JO.default_registry())
    got = census_of(serve(Executor, (tg, tg, ta), tps, StreamScheduler, device="cpu"),
                    default_registry())
    assert got == want and all(path == "reference" for _, path in got)


def test_census_mute_holds_only_on_its_own_thread():
    """A forward the executor mutes does not hide a wrapper that runs on
    another thread meanwhile (a pipeline worker's prepare, say)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import ops

    x, w, b = torch.ones(4, 8), torch.ones(8, 3), torch.zeros(3)
    reg = default_registry()
    with ThreadPoolExecutor(1) as pool:
        def muted_here_counted_there():
            with ops.census_muted():
                ops.node_mlp(x, w, b)
                pool.submit(ops.node_mlp, x, w, b).result()

        got = census_of(muted_here_counted_there, reg)
    assert got == {("node_mlp", "reference"): 1.0}


def test_a_failed_warm_leaves_its_key_uncounted():
    """A warm whose forward raises records nothing: warming the signature
    again counts one forward, as a first warm does."""
    jcfg, tcfg = small_config("gin")
    ex = Executor(buckets=((16, 32),), device="cpu")
    ex.register("m", tcfg, converted(jcfg)[1], fused=True)
    p = ex.prepare_stream(raw_graphs(1)[0])
    cb = ex._program(ex.tenant("m"), p.bucket_key, p.num_graphs)
    real = cb.fn

    def fails(*args):
        real(*args)
        raise RuntimeError("forward failed")

    cb.fn = fails
    reg = default_registry()
    with pytest.raises(RuntimeError, match="forward failed"):
        ex.warm(p)
    cb.fn = real
    fresh = Executor(buckets=((16, 32),), device="cpu")
    fresh.register("m", tcfg, converted(jcfg)[1], fused=True)
    want = census_of(lambda: fresh.warm(fresh.prepare_stream(raw_graphs(1)[0])), reg)
    assert want and census_of(lambda: ex.warm(p), reg) == want

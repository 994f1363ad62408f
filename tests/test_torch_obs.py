"""The port's telemetry (``repro_torch.obs``, ``serve.clock``) against the
JAX package's (``repro.obs``, ``repro.serve.clock``).

The same scripted sequence of tracer and registry calls runs under a
``VirtualClock`` on both sides; the Chrome trace JSON, the Prometheus text,
the metrics snapshot and the admission line must be the same bytes.  Both
validators must refuse the same malformed documents with the same
message, and the catalogs must be equal.  Timestamps are binary fractions,
so every sum is exact.  The dispatch census (``kernels_dispatch_total``)
of one port forward on the CPU equals the JAX engine's for one compiled
program, op for op.  These mirror the scheduler-free cases of
``tests/test_obs.py``.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import obs as JO
from repro.gnn import models as JM
from repro.serve import clock as JC
from repro.serve.gnn_engine import GNNEngine as JEngine
from repro_torch import obs as TO
from repro_torch.configs.gengnn_models import get_gnn_config
from repro_torch.convert import from_jax_params
from repro_torch.data.pipeline import MOLHIV, MoleculeStream
from repro_torch.gnn import models as TM
from repro_torch.serve import clock as TC
from repro_torch.serve.executor import Executor

torch.set_num_threads(1)

MW = 0.015625  # 1/64
SVC = 0.00390625  # 1/256
A1 = 0.001953125  # 1/512
DONE = A1 + SVC
LAB = dict(tenant="default", priority=0)


def scripted(obs, clock_mod):
    """One scripted lifecycle on ``obs`` (either package's obs module):
    two admits, a host span, a flush and its device span, two responds, a
    shed, and every kind of instrument."""
    clock = clock_mod.VirtualClock()
    tracer, reg = obs.Tracer(clock), obs.MetricsRegistry()
    mi = obs.ServingInstruments(reg)
    tracer.event("admit", rid=0, bucket=str((32, 96)), **LAB)
    mi.requests.inc(**LAB)
    mi.admitted.inc(**LAB)
    clock.advance_to(A1)
    tracer.event("admit", rid=1, bucket=str((32, 96)), **LAB)
    tracer.event("shed", rid=2, reason="queue_full", **LAB)
    mi.requests.inc(2, **LAB)
    mi.admitted.inc(**LAB)
    mi.shed.inc(reason="queue_full", **LAB)
    with tracer.span("pack", tenant="default", graphs=2, rung=1):
        pass
    tracer.record("queue", 0.0, A1, rid=0)
    tracer.record("flush", A1, DONE, reason="budget", graphs=2, sig=str((32, 96)))
    tracer.record("device", A1, DONE, track="device", compute_s=SVC)
    clock.advance(SVC)
    for rid, at in ((0, 0.0), (1, A1)):
        tracer.event("respond", rid=rid, latency_s=DONE - at, miss=False)
        mi.served.inc(**LAB)
        mi.latency.observe(DONE - at, **LAB)
    mi.deadline_misses.inc(0.0, **LAB)
    mi.flushes.inc(reason="budget")
    mi.flush_graphs.observe(2)
    mi.queue_depth.set(0)
    mi.open_buckets.set(1)
    mi.service_ewma.set(SVC, sig="32x96")
    mi.compile_seconds.inc(1.25)
    mi.warm_seconds.inc(0.5)
    mi.aot_cache.inc(2, result="hit")
    mi.aot_cache.inc(1, result="miss")
    mi.device_seconds.inc(SVC)
    mi.d2h_seconds.inc(A1)
    mi.inflight_depth.set(2)
    return tracer, reg


def test_catalogs_are_equal():
    assert TO.CATALOG == JO.CATALOG


def test_scripted_exports_are_byte_identical():
    jt, jr = scripted(JO, JC)
    tt, tr = scripted(TO, TC)
    assert TO.export.trace_json(tt) == JO.export.trace_json(jt)
    assert TO.export.prometheus_text(tr) == JO.export.prometheus_text(jr)
    dump = lambda doc: json.dumps(doc, sort_keys=True)
    assert dump(TO.export.metrics_snapshot(tr)) == dump(JO.export.metrics_snapshot(jr))
    assert TO.export.admission_line(tr) == JO.export.admission_line(jr) == (
        "admission: served 2  shed 1 ({'queue_full': 1}); deadline misses 0; "
        "untimed compile 1.25s + warm 0.50s; aot hit 2 miss 1 stale 0")
    assert TO.export.validate_trace_events(TO.export.trace_events(tt)) == len(tt.spans)
    snap = TO.export.metrics_snapshot(tr)
    # every catalog metric but the census, which lives in default_registry()
    assert TO.export.validate_metrics_snapshot(snap) == len(snap["metrics"]) == len(
        TO.CATALOG) - 1


def test_written_files_are_byte_identical(tmp_path):
    jt, jr = scripted(JO, JC)
    tt, tr = scripted(TO, TC)
    JO.export.write_trace(jt, tmp_path / "j.json")
    TO.export.write_trace(tt, tmp_path / "t.json")
    JO.export.write_metrics_json(jr, tmp_path / "jm.json")
    TO.export.write_metrics_json(tr, tmp_path / "tm.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert (tmp_path / "tm.json").read_bytes() == (tmp_path / "jm.json").read_bytes()


def test_scripted_trace_is_exact_and_repeats():
    tt, _ = scripted(TO, TC)
    (fl,) = [s for s in tt.spans if s.name == "flush"]
    assert (fl.t0_s, fl.t1_s, fl.dur_s) == (A1, DONE, SVC)
    (pack,) = [s for s in tt.spans if s.name == "pack"]
    assert (pack.t0_s, pack.t1_s) == (A1, A1)  # virtual time stands still
    doc = TO.export.trace_events(tt)
    flush = next(e for e in doc["traceEvents"] if e["name"] == "flush")
    assert flush["ts"] == round(A1 * 1e6, 3) and flush["dur"] == round(SVC * 1e6, 3)
    respond = next(e for e in doc["traceEvents"] if e["name"] == "respond")
    assert respond["ph"] == "i" and respond["s"] == "t"
    assert TO.export.trace_json(scripted(TO, TC)[0]) == TO.export.trace_json(tt)


def _malformed_metrics():
    good = scripted(TO, TC)[1].snapshot()
    docs = [[], {"schema": "other/v1"}, {"schema": "repro-metrics/v1"}]
    rogue = json.loads(json.dumps(good))
    rogue["metrics"]["serve_rogue_total"] = {
        "type": "counter", "help": "", "labelnames": [], "series": []}
    kind = json.loads(json.dumps(good))
    kind["metrics"]["serve_served_total"]["type"] = "gauge"
    names = json.loads(json.dumps(good))
    names["metrics"]["serve_served_total"]["labelnames"] = ["tenant"]
    labels = json.loads(json.dumps(good))
    labels["metrics"]["serve_served_total"]["series"][0]["labels"] = {}
    hist = json.loads(json.dumps(good))
    del hist["metrics"]["serve_flush_graphs"]["series"][0]["count"]
    value = json.loads(json.dumps(good))
    del value["metrics"]["serve_queue_depth"]["series"][0]["value"]
    return docs + [rogue, kind, names, labels, hist, value]


def _malformed_traces():
    ev = {"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0, "dur": 1.0}
    return [[], {"traceEvents": {}},
            {"traceEvents": [dict(ev, ph="B")]},
            {"traceEvents": [dict(ev, name="")]},
            {"traceEvents": [dict(ev, pid="1")]},
            {"traceEvents": [dict(ev, ts="0")]},
            {"traceEvents": [dict(ev, dur=-1.0)]},
            {"traceEvents": [dict(ev, args=[])]}]


@pytest.mark.parametrize("which", ["metrics", "trace"])
def test_validators_reject_the_same_documents(which):
    docs = _malformed_metrics() if which == "metrics" else _malformed_traces()
    name = "validate_metrics_snapshot" if which == "metrics" else "validate_trace_events"
    for doc in docs:
        errs = []
        for obs in (JO, TO):
            with pytest.raises(ValueError) as err:
                getattr(obs.export, name)(doc)
            errs.append(str(err.value))
        assert errs[0] == errs[1]


def test_registry_rejects_names_outside_the_catalog():
    reg = TO.MetricsRegistry()
    with pytest.raises(ValueError, match="closed"):
        reg.counter("serve_totally_new_total")
    with pytest.raises(ValueError, match="counter"):
        reg.gauge("serve_requests_total")
    with pytest.raises(ValueError, match="labels"):
        reg.counter("serve_requests_total", labels=("tenant",))
    with pytest.raises(ValueError, match="cannot decrease"):
        reg.counter("serve_served_total").inc(-1.0, tenant="a", priority=0)
    with pytest.raises(ValueError, match="label names"):
        reg.counter("serve_served_total").inc(tenant="a")


def test_virtual_clock_moves_only_forward():
    clock = TC.VirtualClock(0.5)
    assert clock.now() == 0.5 and clock.advance(0.25) == 0.75
    with pytest.raises(ValueError, match="backwards"):
        clock.advance_to(0.5)
    with pytest.raises(ValueError, match="negative"):
        clock.advance(-1.0)
    real = TC.RealClock()
    assert real.advance_to(0.0) <= real.now()


def test_null_tracer_records_nothing():
    nt = TO.NULL_TRACER
    with nt.span("pack", tenant="a") as sp:
        assert sp is nt.span("other")
    nt.event("x")
    nt.record("y", 0.0, 1.0)
    assert nt.spans == () and not nt.enabled


class CountingClock:
    """A clock that counts its reads (and steps by 1/4 s each)."""

    def __init__(self):
        self.reads = 0

    def now(self):
        self.reads += 1
        return self.reads * 0.25


def _engine_graphs(k=3):
    return [g[:4] for g in MoleculeStream(MOLHIV, seed=3).take(k)]


def test_disabled_telemetry_records_nothing_and_changes_nothing():
    """No sinks: no registry, no spans, no extra clock reads (two a warm,
    two a run); with sinks the same program keys and the same outputs."""
    cfg = get_gnn_config("gin", num_layers=2, hidden=16)
    params = TM.init(torch.Generator().manual_seed(0), cfg)
    outs, keys, reads = [], [], []
    for telemetry in (False, True):
        clock = CountingClock()
        kw = dict(tracer=TO.Tracer(TC.VirtualClock()),
                  metrics=TO.MetricsRegistry()) if telemetry else {}
        ex = Executor(device="cpu", clock=clock, **kw)
        ex.register("m", cfg, params, fused=True)
        outs.append([ex.run(ex.prepare_stream(g))[0] for g in _engine_graphs()])
        keys.append(set(ex._compiled))
        reads.append(clock.reads)
        if not telemetry:
            assert ex.tracer is TO.NULL_TRACER and ex.metrics is None and ex._mi is None
            assert TO.NULL_TRACER.spans == ()
    warms = len({ex.prepare_stream(g).signature for g in _engine_graphs()})
    assert reads[0] == 2 * warms + 2 * 3
    assert reads[1] == reads[0] + 2 * 3  # the D2H accounting's two reads a run
    assert keys[0] == keys[1]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_kernel_dispatch_decisions_are_counted():
    from repro_torch.kernels import ops

    c = TO.default_registry().counter("kernels_dispatch_total")
    before = c.value(op="node_mlp", path="reference")
    x = torch.zeros((4, 8))
    w = torch.zeros((8, 8))
    b = torch.zeros((8,))
    ops.node_mlp(x, w, b, mode="reference")
    ops.node_mlp(x, w, b)  # auto on the CPU: the plain version
    assert c.value(op="node_mlp", path="reference") == before + 2
    assert c.value(op="node_mlp", path="kernel") == 0


def _census():
    return dict(TO.default_registry().counter("kernels_dispatch_total").series())


def _jax_census():
    return dict(JO.default_registry().counter("kernels_dispatch_total").series())


def _delta(after, before):
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("model", ["gcn", "gin", "gin_vn", "gat", "pna", "dgn"])
def test_dispatch_census_of_one_forward_matches_jax(model, precision):
    """One port forward on the CPU counts each wrapper call with
    path="reference", op for op as the JAX engine counts its one compiled
    program (JAX counts at trace time)."""
    small = dict(num_layers=2, hidden=16, heads=2, head_features=8)
    jcfg = (JM.paper_config("gin", virtual_node=True, **small) if model == "gin_vn"
            else JM.paper_config(model, **small))
    jp = JM.init(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    g = _engine_graphs(1)
    eng = JEngine(jcfg, jp, precision=precision, fused=True)
    before = _jax_census()
    eng.infer_stream(g, with_eigvec=model == "dgn")
    want = _delta(_jax_census(), before)

    ex = Executor(device="cpu")
    tenant = ex.register("m", get_gnn_config(model, **small), tp,
                         precision=precision, fused=True)
    p = ex.prepare_stream(g[0], with_eigvec=model == "dgn")
    fn = TM.forward_program(tenant.cfg, num_graphs=1, fused=True)
    before = _census()
    with torch.inference_mode():
        fn(tenant.params, *p.inputs)
    got = _delta(_census(), before)
    assert got == want and all(path == "reference" for _, path in got)

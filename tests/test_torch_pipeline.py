"""The port's pipelined execution (``repro_torch.serve.pipeline``) on the
CPU, against the JAX package's; mirrors ``tests/test_serve_pipeline.py``.

* **Scripted simulations**: the pipelined scheduler loop over JAX's
  ``conftest.scripted_executor`` and over the port's twin
  (``test_torch_scheduler.TorchScripted``) on the same trace give the same
  flush logs, sheds and latencies as floats, the same trace bytes, and each
  JAX assertion (dispatch-ahead, the in-flight bound, FIFO harvest, the
  pack EWMA, admission with host-pack cost) holds on the port.
* **Real engines** (small configs, params converted from JAX's): for all
  six models in fp32 and int8 the pipelined scheduler's outputs equal the
  serial loop's bit for bit, the threaded ``PipelinedStream`` equals
  ``infer_stream`` bit for bit (staged or not), and the served outputs
  agree with JAX's engine (fp32 rtol 1e-4, atol 1e-6, PNA 5e-3; int8 within
  the quantization-noise bound of ``tests/test_torch_quant.py``).
* **Executor satellites**: the eigenvector LRU, the D2H accounting, the
  ``run_async`` / ``PendingRun`` contract, host-prepared batches.
"""
import jax
import numpy as np
import pytest
import torch

from conftest import scripted_executor
from repro import obs as JO
from repro.gnn import models as JM
from repro.serve.clock import VirtualClock as JClock
from repro.serve.gnn_engine import GNNEngine as JEngine
from repro.serve.pipeline import PipelineConfig as JPipelineConfig
from repro.serve.scheduler import StreamScheduler as JScheduler
from repro_torch.configs.gengnn_models import get_gnn_config
from repro_torch.convert import from_jax_params
from repro_torch.core.batching import BucketBudget, pack_prepared
from repro_torch.obs import MetricsRegistry, Tracer, export
from repro_torch.serve.clock import RealClock, VirtualClock
from repro_torch.serve.executor import Executor, staged
from repro_torch.serve.gnn_engine import GNNEngine
from repro_torch.serve.pipeline import (
    PipelineConfig,
    PipelinedStream,
    as_pipeline,
    overlap_fraction,
)
from repro_torch.serve.scheduler import StreamScheduler
from test_torch_scheduler import TorchScripted, assert_same_report

torch.set_num_threads(1)

# binary fractions: every modeled timestamp below is exact in float64
MW = 0.0009765625  # max_wait_s = 2**-10
A1 = 0.001953125  # 2**-9
A2 = 0.00390625  # 2**-8
H = 0.0029296875  # scripted host-pack seconds = 3 * 2**-10
SVC = 0.00390625  # scripted flush compute = 2**-8
BUCKETS = ((16, 32),)


def graph(n=8, e=12, feat=9, edge=3, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, n, e).astype(np.int32),
        rng.integers(0, n, e).astype(np.int32),
        rng.normal(size=(n, feat)).astype(np.float32),
        rng.normal(size=(e, edge)).astype(np.float32),
    )


def graphs(k, seed=0, nodes=(5, 14)):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        n = int(rng.integers(*nodes))
        e = int(rng.integers(n, 2 * n))
        out.append((rng.integers(0, n, e).astype(np.int32),
                    rng.integers(0, n, e).astype(np.int32),
                    rng.normal(size=(n, 9)).astype(np.float32),
                    rng.normal(size=(e, 3)).astype(np.float32)))
    return out


def flush_rows(rep, with_start=True):
    return [
        (f.rids, f.reason, f.at_s, f.start_s, f.done_s, f.compute_s)
        if with_start else (f.rids, f.reason, f.at_s, f.done_s, f.compute_s)
        for f in rep.flush_log
    ]


def as_jax(pipeline):
    """The JAX twin of a port ``pipeline=`` argument."""
    if isinstance(pipeline, PipelineConfig):
        return JPipelineConfig(inflight=pipeline.inflight,
                               host_cost=pipeline.host_cost,
                               overlap=pipeline.overlap)
    return pipeline


def both(script, graphs_, run_kw, tracer=False, metrics=False, **kw):
    """One scheduler configuration over both scripted executors: runs the
    trace through JAX's and the port's, asserts the reports equal, and
    returns (port report, port scheduler, JAX scheduler)."""
    jkw, tkw = dict(kw), dict(kw)
    jkw["pipeline"] = as_jax(kw.get("pipeline"))
    if tracer:
        jkw["tracer"], tkw["tracer"] = JO.Tracer(JClock()), Tracer(VirtualClock())
    if metrics:
        jkw["metrics"], tkw["metrics"] = JO.MetricsRegistry(), MetricsRegistry()
    jex, tex = scripted_executor(service_s=script), TorchScripted(service_s=script)
    js, ts = JScheduler(jex, **jkw), StreamScheduler(tex, **tkw)
    jrep, trep = js.run(graphs_, **run_kw), ts.run(graphs_, **run_kw)
    assert_same_report(jrep, trep)
    assert tex.run_log == jex.run_log
    if tracer:
        assert export.trace_json(ts.tracer) == JO.export.trace_json(js.tracer)
    if metrics:
        assert export.prometheus_text(ts.metrics) == JO.export.prometheus_text(js.metrics)
    return trep, ts, js


# ------------------------------------------------------------ config surface


def test_pipeline_config_validation():
    assert PipelineConfig().inflight == 2
    for bad, needle in ((dict(inflight=0), "inflight"),
                        (dict(host_cost="wall"), "host_cost"),
                        (dict(host_cost=-0.001), "host_cost"),
                        (dict(host_cost=[0.001, -0.002]), "host_cost"),
                        (dict(host_cost=[]), "host_cost")):
        with pytest.raises(ValueError, match=needle) as got:
            PipelineConfig(**bad)
        with pytest.raises(ValueError, match=needle) as want:
            JPipelineConfig(**bad)
        assert str(got.value) == str(want.value)
    assert PipelineConfig(host_cost="measured").measured
    assert not PipelineConfig(host_cost=0.001).measured


def test_as_pipeline_normalization():
    assert as_pipeline(None) is None and as_pipeline(False) is None
    assert as_pipeline(True) == PipelineConfig()
    assert as_pipeline(3) == PipelineConfig(inflight=3)
    cfg = PipelineConfig(inflight=4, host_cost=0.001)
    assert as_pipeline(cfg) is cfg
    with pytest.raises(ValueError, match="pipeline"):
        as_pipeline("deep")


def test_host_cost_fn_forms():
    assert PipelineConfig(host_cost=None).host_cost_fn()(7) == 0.0
    assert PipelineConfig(host_cost=H).host_cost_fn()(3) == H
    seq = PipelineConfig(host_cost=[0.001, 0.002]).host_cost_fn()
    assert [seq(0), seq(1), seq(2), seq(9)] == [0.001, 0.002, 0.002, 0.002]
    assert PipelineConfig(host_cost="measured").host_cost_fn() is None


# -------------------------------------------- serial equivalence at depth 1


def _paced_run(pipeline, slo=None):
    gs = graphs(12, seed=3)
    rep, _, _ = both([0.004, 0.002, 0.006, 0.003], gs,
                     dict(arrivals=[0.001 * i for i in range(len(gs))]),
                     capacity=2, max_wait_s=0.0015, slo_s=slo,
                     service_s=0.004, pipeline=pipeline)
    return rep


def test_depth1_free_host_cost_equals_serial():
    ser = _paced_run(None)
    p1 = _paced_run(PipelineConfig(inflight=1))
    assert flush_rows(ser, with_start=False) == flush_rows(p1, with_start=False)
    np.testing.assert_array_equal(ser.latencies_s, p1.latencies_s)
    for a, b in zip(ser.outputs, p1.outputs):
        np.testing.assert_array_equal(a, b)
    assert ser.makespan_s == p1.makespan_s
    for fs, fp in zip(ser.flush_log, p1.flush_log):
        assert fp.start_s <= fs.start_s


def test_depth1_equivalence_with_slo_shedding():
    ser = _paced_run(None, slo=0.006)
    p1 = _paced_run(PipelineConfig(inflight=1), slo=0.006)
    assert [(s.rid, s.reason, s.at_s, s.projected_delay_s) for s in ser.shed] \
        == [(s.rid, s.reason, s.at_s, s.projected_delay_s) for s in p1.shed]
    assert flush_rows(ser, with_start=False) == flush_rows(p1, with_start=False)


# ------------------------------------------------- exact overlap simulation


def _overlap_sim(tracer=False, metrics=False, inflight=2, host_cost=H):
    rep, ts, _ = both(SVC, [graph(seed=0), graph(seed=1), graph(seed=2)],
                      dict(arrivals=[0.0, A1, A2]), tracer=tracer,
                      metrics=metrics, capacity=2, max_wait_s=MW,
                      pipeline=PipelineConfig(inflight=inflight, host_cost=host_cost))
    return ts, rep


def test_exact_virtual_clock_overlap_sim():
    _, rep = _overlap_sim()
    assert flush_rows(rep) == [
        ((0,), "deadline", MW, MW + H, MW + H + SVC, SVC),
        ((1,), "deadline", A1 + MW, MW + 2 * H, MW + H + 2 * SVC, SVC),
        ((2,), "drain", MW + H + SVC, MW + H + SVC + H, MW + H + 3 * SVC, SVC),
    ]
    np.testing.assert_array_equal(rep.latencies_s, [
        MW + H + SVC, MW + H + 2 * SVC - A1, MW + H + 3 * SVC - A2])
    assert rep.makespan_s == MW + H + 3 * SVC
    f0, f1, f2 = rep.flush_log
    assert f1.start_s < f0.done_s
    assert f0.done_s <= f1.done_s <= f2.done_s


def test_pipelined_sim_is_bitwise_reproducible():
    ts_a, rep_a = _overlap_sim(tracer=True, metrics=True)
    ts_b, rep_b = _overlap_sim(tracer=True, metrics=True)
    assert flush_rows(rep_a) == flush_rows(rep_b)
    np.testing.assert_array_equal(rep_a.latencies_s, rep_b.latencies_s)
    assert export.trace_json(ts_a.tracer) == export.trace_json(ts_b.tracer)
    assert export.prometheus_text(ts_a.metrics) == export.prometheus_text(ts_b.metrics)


def test_pipelined_trace_models_overlap():
    ts, _ = _overlap_sim(tracer=True)
    tr = ts.tracer
    packs = [s for s in tr.spans if s.name == "pack"]
    devs = [s for s in tr.spans if s.name == "device"]
    assert len(packs) == 3 and len(devs) == 3
    assert all(s.dur_s == H for s in packs)
    assert packs[1].t0_s < devs[0].t1_s and packs[1].t1_s > devs[0].t0_s
    assert overlap_fraction(tr) == pytest.approx(2.0 / 3.0)
    _, ser, _ = both(SVC, [graph(seed=0)], dict(arrivals=[0.0]), tracer=True,
                     capacity=2, max_wait_s=MW)
    assert overlap_fraction(ser.tracer) == 0.0


def test_dispatch_events_and_inflight_metric():
    ts, rep = _overlap_sim(tracer=True, metrics=True)
    dispatches = [dict(s.attrs) for s in ts.tracer.spans if s.name == "dispatch"]
    assert len(dispatches) == len(rep.flush_log)
    assert all(1 <= a["inflight"] <= 2 for a in dispatches)
    snap = export.metrics_snapshot(ts.metrics)
    assert export.validate_metrics_snapshot(snap) == len(snap["metrics"])
    text = export.prometheus_text(ts.metrics)
    assert "serve_inflight_depth 0" in text and "serve_pack_ewma_seconds" in text


def test_pack_ewma_tracks_scripted_host_costs():
    _, ts, js = both(SVC, [graph(seed=0), graph(seed=1), graph(seed=2)],
                     dict(arrivals=[0.0, A1, A2]), capacity=2, max_wait_s=MW,
                     svc_alpha=0.5,
                     pipeline=PipelineConfig(inflight=2, host_cost=[0.002, 0.004, 0.008]))
    sig = (32, 96)
    assert ts.pack_estimate_s(sig) == 0.5 * (0.5 * (0.002 + 0.004)) + 0.5 * 0.008
    assert ts.pack_estimate_s(sig) == js.pack_estimate_s(sig)
    assert ts.pack_estimate_s((64, 192)) == 0.0


def test_admission_projection_accounts_host_pack_backlog():
    gs = graphs(10, seed=5)

    def run(pipeline):
        rep, _, _ = both(0.004, gs, dict(arrivals=[0.0008 * i for i in range(len(gs))]),
                         capacity=1, max_wait_s=0.0005, slo_s=0.0105,
                         service_s=0.004, pipeline=pipeline)
        return rep

    ser = run(None)
    d1 = run(PipelineConfig(inflight=1, host_cost=None))
    free = run(PipelineConfig(inflight=2, host_cost=None))
    costly = run(PipelineConfig(inflight=2, host_cost=0.004))
    assert [(s.rid, s.reason, s.at_s, s.projected_delay_s) for s in ser.shed] \
        == [(s.rid, s.reason, s.at_s, s.projected_delay_s) for s in d1.shed]
    assert len(costly.shed) > len(free.shed)
    for rep in (ser, d1, free, costly):
        assert rep.num_served + rep.num_shed == rep.num_requests


# ------------------------------------------------------ in-flight window


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_inflight_window_bounds(depth):
    rep, _, _ = both(SVC, graphs(12, seed=7), dict(qps=0.0), capacity=1,
                     max_wait_s=MW,
                     pipeline=PipelineConfig(inflight=depth, host_cost=0.0001))
    log = rep.flush_log
    assert len(log) >= depth + 2
    for k in range(depth, len(log)):
        assert log[k].start_s >= log[k - depth].done_s
    if depth >= 2:
        assert any(log[k].start_s < log[k - 1].done_s for k in range(1, len(log)))


def test_fifo_response_order_under_unequal_service_times():
    rep, ts, _ = both([0.016, 0.0005, 0.0005], graphs(6, seed=9), dict(qps=0.0),
                      tracer=True, capacity=1, max_wait_s=MW,
                      pipeline=PipelineConfig(inflight=3, host_cost=None))
    log = rep.flush_log
    assert len(log) >= 3
    assert [f.done_s for f in log] == sorted(f.done_s for f in log)
    responds = [dict(s.attrs)["rid"] for s in ts.tracer.spans if s.name == "respond"]
    assert responds == [r for f in log for r in f.rids]
    assert all(o is not None for o in rep.outputs)


# ------------------------------------------------- real-engine parity


MODELS = ("gcn", "gin", "gin_vn", "gat", "pna", "dgn")


def small_config(model):
    small = dict(num_layers=2, hidden=16, heads=2, head_features=8)
    jcfg = (JM.paper_config("gin", virtual_node=True, **small) if model == "gin_vn"
            else JM.paper_config(model, **small))
    return jcfg, get_gnn_config(model, **small)


def converted(jcfg, seed=0):
    jp = JM.init(jax.random.PRNGKey(seed), jcfg)
    return jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp))


def gin_engine():
    jcfg, tcfg = small_config("gin")
    return GNNEngine(tcfg, converted(jcfg)[1], buckets=BUCKETS, device="cpu")


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_pipelined_bitwise_parity_all_models(model, precision):
    """Pipelined outputs equal serial ones bit for bit in both serving
    shapes (the scheduler's serial vs pipelined loop; ``infer_stream`` vs
    the threaded ``PipelinedStream``), and the port serves what JAX's
    engine serves."""
    jcfg, tcfg = small_config(model)
    jp, tp = converted(jcfg)
    gs = graphs(6, seed=11)
    eig = model == "dgn"
    eng = GNNEngine(tcfg, tp, buckets=BUCKETS, precision=precision, fused=True,
                    device="cpu")
    ser = StreamScheduler(eng, capacity=2, max_wait_s=0.002, with_eigvec=eig).run(gs)
    pipe = StreamScheduler(eng, capacity=2, max_wait_s=0.002, with_eigvec=eig,
                           pipeline=PipelineConfig(inflight=2)).run(gs)
    assert [f.rids for f in ser.flush_log] == [f.rids for f in pipe.flush_log]
    for a, b in zip(ser.outputs, pipe.outputs):
        np.testing.assert_array_equal(a, b)
    base, _, _ = eng.infer_stream(gs, with_eigvec=eig)
    outs, stats = PipelinedStream(eng.executor, model=eng.name,
                                  inflight=2).run(gs, with_eigvec=eig)
    assert len(outs) == len(base) and stats["peak_inflight"] <= 2
    for a, b in zip(base, outs):
        np.testing.assert_array_equal(a, b[:1])
    # against JAX's engine on the same graphs and params
    jeng = JEngine(jcfg, jp, buckets=BUCKETS, precision=precision, fused=True)
    want, _, _ = jeng.infer_stream(gs, with_eigvec=eig)
    want = np.concatenate([np.asarray(w) for w in want])
    got, served = np.concatenate(base), np.concatenate(ser.outputs)
    if precision == "fp32":
        tol = dict(rtol=5e-3, atol=5e-3) if model == "pna" else dict(rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got, want, **tol)
        np.testing.assert_allclose(served, want, **(tol if model == "pna" else
                                                    dict(rtol=1e-4, atol=1e-5)))
    else:
        fp32, _, _ = JEngine(jcfg, jp, buckets=BUCKETS, fused=True).infer_stream(
            gs, with_eigvec=eig)
        noise = np.abs(want - np.concatenate([np.asarray(f) for f in fp32])).mean()
        assert np.abs(got - want).mean() <= 0.2 * noise + 1e-5
        assert np.abs(served - want).mean() <= 0.2 * noise + 1e-5


def test_pipelined_stream_validation_and_staging():
    eng = gin_engine()
    with pytest.raises(ValueError, match="inflight"):
        PipelinedStream(eng.executor, inflight=0)
    with pytest.raises(ValueError, match="prepare_ahead"):
        PipelinedStream(eng.executor, inflight=2, prepare_ahead=0)
    gs = graphs(4, seed=13)
    base, _, _ = eng.infer_stream(gs)
    for kwargs in (dict(stage=False), dict(prepare_ahead=3), dict(inflight=1)):
        outs, stats = PipelinedStream(eng.executor, model=eng.name,
                                      **{"inflight": 2, **kwargs}).run(gs)
        assert stats["peak_inflight"] <= kwargs.get("inflight", 2)
        for a, b in zip(base, outs):
            np.testing.assert_array_equal(a, b[:1])


def test_pipelined_stream_serves_a_cold_executor():
    """No signature warm before the run: the warms happen on the caller
    thread while the worker prepares, and the outputs are the stream's."""
    jcfg, tcfg = small_config("gat")
    tp = converted(jcfg)[1]
    gs = graphs(5, seed=15)
    cold = GNNEngine(tcfg, tp, buckets=BUCKETS, device="cpu")
    outs, _ = PipelinedStream(cold.executor, inflight=2).run(gs)
    base, _, _ = GNNEngine(tcfg, tp, buckets=BUCKETS, device="cpu").infer_stream(gs)
    for a, b in zip(base, outs):
        np.testing.assert_array_equal(a, b[:1])


def test_pack_prepared_builds_on_the_host_and_stages_transparently():
    eng = gin_engine()
    gs = graphs(4, seed=17)
    budget = BucketBudget(64, 128, 8)
    prep, meta = pack_prepared(gs, budget, with_layout=eng.share_layout, stage=True)
    kept, _ = pack_prepared(gs, budget, with_layout=eng.share_layout)
    assert prep.graph.device.type == "cpu" and prep.layout is not None
    assert prep.bucket_key == kept.bucket_key == ("packed", 64, 128, 8)
    assert prep.signature == kept.signature and meta.num_graphs == 4
    assert staged(prep, "cpu") is prep
    out_a, _ = eng.executor.run(prep, model=eng.name)
    out_b, _ = eng.executor.run(kept, model=eng.name)
    np.testing.assert_array_equal(out_a, out_b)


def test_host_prepared_batch_has_the_device_batch_signature():
    eng = gin_engine()
    ex = eng.executor
    g = graph(seed=19)
    host, dev = ex.prepare_stream(g, host=True), ex.prepare_stream(g)
    assert host.signature == dev.signature
    hb = ex.prepare_batched(graphs(2), 2, 32, 64, host=True)
    assert hb.signature == ex.prepare_batched(graphs(2), 2, 32, 64).signature
    np.testing.assert_array_equal(ex.run(host)[0], ex.run(dev)[0])


# ------------------------------------------- executor satellites (LRU, D2H)


def test_eigvec_lru_hits_and_misses():
    reg = MetricsRegistry()
    ex = Executor(buckets=BUCKETS, device="cpu")
    ex.attach_telemetry(metrics=reg)
    g = graph(seed=21)
    c = reg.get("serve_eigvec_cache_total")
    v1 = ex._eigvec(g[0], g[1], g[2].shape[0], 16)
    assert (c.value(result="miss"), c.value(result="hit")) == (1, 0)
    v2 = ex._eigvec(g[0], g[1], g[2].shape[0], 16)
    assert (c.value(result="miss"), c.value(result="hit")) == (1, 1)
    np.testing.assert_array_equal(v1, v2)
    g2 = graph(seed=22)
    ex._eigvec(g2[0], g2[1], g2[2].shape[0], 16)
    assert c.value(result="miss") == 2
    ex._eigvec(g[0], g[1], g[2].shape[0], 32)
    assert c.value(result="miss") == 3


def test_eigvec_lru_evicts_least_recent(monkeypatch):
    ex = Executor(buckets=BUCKETS, device="cpu")
    monkeypatch.setattr(Executor, "_EIGVEC_LRU_SIZE", 2)
    ga, gb, gc = graph(seed=31), graph(seed=32), graph(seed=33)
    for g in (ga, gb, gc):
        ex._eigvec(g[0], g[1], g[2].shape[0], 16)
    assert len(ex._eigvec_lru) == 2
    ex._eigvec(gb[0], gb[1], gb[2].shape[0], 16)
    ex._eigvec(ga[0], ga[1], ga[2].shape[0], 16)
    key = lambda g: (np.ascontiguousarray(g[0]).tobytes(),
                     np.ascontiguousarray(g[1]).tobytes(), g[2].shape[0], 16)
    assert list(ex._eigvec_lru) == [key(gb), key(ga)]


def test_d2h_span_and_counter():
    tr, reg = Tracer(RealClock()), MetricsRegistry()
    eng = gin_engine()
    eng.executor.attach_telemetry(tracer=tr, metrics=reg)
    gs = graphs(4, seed=41)
    eng.infer_stream(gs)
    d2h = [s for s in tr.spans if s.name == "unpack_d2h"]
    runs = [s for s in tr.spans if s.name == "executor_run"]
    assert len(d2h) == len(runs) == len(gs)
    assert all(dict(s.attrs)["dur_s"] >= 0.0 for s in d2h)
    total = sum(dict(s.attrs)["dur_s"] for s in d2h)
    assert reg.get("serve_d2h_seconds_total").value() == pytest.approx(total)


def test_run_async_pending_run_contract():
    eng = gin_engine()
    ex = eng.executor
    p = ex.prepare_stream(graph(seed=51))
    pr = ex.run_async(p, model=eng.name)
    assert not pr.done
    out, dt = pr.result()
    assert pr.done and dt >= 0.0
    out2, dt2 = pr.result()
    assert out2 is out and dt2 == dt
    out3, _ = ex.run(ex.prepare_stream(graph(seed=51)), model=eng.name)
    np.testing.assert_array_equal(out, out3)


# ----------------------------------------------------------------- clocks


def test_real_clock_advance_to_stamps():
    c = RealClock()
    t = c.now()
    assert c.advance_to(t + 100.0) >= t


def test_virtual_clock_advance_to_monotone():
    c = VirtualClock(1.0)
    assert c.advance_to(2.5) == 2.5
    with pytest.raises(ValueError, match="backwards"):
        c.advance_to(2.0)

"""The port's Executor (``repro_torch.serve.executor``) on the CPU,
mirroring the scheduler-free cases of ``tests/test_executor.py``.

* **Facade parity** — ``GNNEngine``'s three modes give bit for bit what a
  fresh ``Executor`` gives for the same ``prepare_*`` calls, for all six
  models in fp32 and int8, and both agree with JAX's engine (rtol 1e-4,
  atol 1e-6; PNA 5e-3; int8 within the quantization-noise bound of
  ``tests/test_torch_quant.py``).
* **Warm signatures** key on every leaf's dtype; a dtype change warms
  outside the timed region (exact on a stepping clock); ``num_graphs`` is
  part of the program key.
* **Tenants** of one architecture share program records, not params;
  resolution and registration errors; the facade rejects executor-level
  configuration and reports its own tenant's untimed seconds.
* **run_async / PendingRun** — ``result()`` is cached, ``done`` flips, two
  pending runs harvested in reverse each return their own output.
* **Telemetry** — the exact ``program_build`` / ``warm`` / ``executor_run``
  / ``unpack_d2h`` events and counters on a stepping clock, and no extra
  clock read when the sinks are dark.

The CPU captures no CUDA graph (``tests/test_torch_on_card.py`` holds the
captures on the card): its warm is one eager forward and costs no compile.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import batching as JB
from repro.gnn import models as JM
from repro.serve.gnn_engine import GNNEngine as JEngine
from repro_torch.configs.gengnn_models import get_gnn_config
from repro_torch.convert import from_jax_params
from repro_torch.core import batching as TB
from repro_torch.core import graph as TG
from repro_torch.data.pipeline import laplacian_eigvec
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serve.clock import VirtualClock
from repro_torch.serve.executor import Executor, prepared, trace_signature
from repro_torch.serve.gnn_engine import GNNEngine

torch.set_num_threads(1)

MODELS = ("gcn", "gin", "gin_vn", "gat", "pna", "dgn")
BUCKETS = ((16, 32),)
STEP = 0.25  # the stepping clock's tick: binary-exact sums


class StepClock:
    """Each read moves time by ``STEP``; counts its reads."""

    def __init__(self):
        self.reads = 0

    def now(self):
        self.reads += 1
        return self.reads * STEP


def _small(model):
    small = dict(num_layers=2, hidden=16, heads=2, head_features=8)
    jcfg = (JM.paper_config("gin", virtual_node=True, **small) if model == "gin_vn"
            else JM.paper_config(model, **small))
    return jcfg, get_gnn_config(model, **small)


def _params(jcfg, seed=0):
    jp = JM.init(jax.random.PRNGKey(seed), jcfg)
    for lp in jp["layers"]:
        if "eps" in lp:  # 0 at init; make GIN's eps matter
            lp["eps"] = lp["eps"] + 0.25
    return jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp))


def _raw_graphs(rng, k=4, feat=9, edge=3):
    out = []
    for _ in range(k):
        n = int(rng.integers(5, 14))
        e = int(rng.integers(n, 2 * n))
        out.append((rng.integers(0, n, e).astype(np.int32),
                    rng.integers(0, n, e).astype(np.int32),
                    rng.normal(size=(n, feat)).astype(np.float32),
                    rng.normal(size=(e, edge)).astype(np.float32)))
    return out


def _bitwise(a, b, msg):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _gin(seed=0):
    jcfg, tcfg = _small("gin")
    return tcfg, _params(jcfg, seed)[1]


# --------------------------------------------------------------- facade parity


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_engine_facade_bitwise_equals_direct_executor(model, precision, rng):
    jcfg, tcfg = _small(model)
    jp, tp = _params(jcfg)
    graphs = _raw_graphs(rng)
    eig = model == "dgn"
    eng = GNNEngine(tcfg, tp, buckets=BUCKETS, precision=precision, fused=True,
                    device="cpu")
    ex = Executor(buckets=BUCKETS, device="cpu")
    ex.register("m", tcfg, tp, precision=precision, fused=True)

    outs, _, _ = eng.infer_stream(graphs, with_eigvec=eig)
    for i, g in enumerate(graphs):
        got, _ = ex.run(ex.prepare_stream(g, with_eigvec=eig), model="m")
        _bitwise(got[:1], outs[i], f"stream graph {i}")

    b_eng, _ = eng.infer_batched(graphs, batch_size=2, n_pad=32, e_pad=64,
                                 with_eigvec=eig)
    b_ex = np.concatenate([
        ex.run(ex.prepare_batched(graphs[i : i + 2], 2, 32, 64,
                                  with_eigvec=eig), model="m")[0][:2]
        for i in range(0, len(graphs), 2)
    ])
    _bitwise(b_ex, b_eng, "batched")

    budget = TB.BucketBudget(n_pad=64, e_pad=128, g_pad=len(graphs))
    packed, meta = TB.pack_graphs(graphs, budget)
    eigv = None
    if eig:
        eigv = TB.pack_eigvecs(
            [laplacian_eigvec(s, r, nf.shape[0]) for s, r, nf, _ in graphs], meta)
    p_eng, _ = eng.infer_packed(packed, budget, eigvec=eigv,
                                layout=TB.pack_layout(packed))
    p_ex, _ = ex.run(ex.prepare_packed(packed, budget, eigvec=eigv,
                                       layout=TB.pack_layout(packed)), model="m")
    _bitwise(p_ex, p_eng, "packed")

    # the slice as a whole against JAX's engine on the same graphs
    jeng = JEngine(jcfg, jp, buckets=BUCKETS, precision=precision, fused=True)
    want, _, _ = jeng.infer_stream(graphs, with_eigvec=eig)
    jb = JB.BucketBudget(n_pad=64, e_pad=128, g_pad=len(graphs))
    jpk, _ = JB.pack_graphs(graphs, jb)
    want_p, _ = jeng.infer_packed(jpk, jb, eigvec=eigv, layout=JB.pack_layout(jpk))
    got_s, want_s = np.concatenate(outs), np.concatenate(want)
    if precision == "fp32":
        tol = dict(rtol=5e-3, atol=5e-3) if model == "pna" else dict(rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got_s, want_s, **tol)
        np.testing.assert_allclose(p_eng, np.asarray(want_p), **tol)
    else:
        fp32, _, _ = JEngine(jcfg, jp, buckets=BUCKETS, fused=True).infer_stream(
            graphs, with_eigvec=eig)
        noise = np.abs(want_s - np.concatenate(fp32)).mean()
        assert np.abs(got_s - want_s).mean() <= 0.2 * noise + 1e-5


# ------------------------------------------------------------ warm signatures


def test_trace_signature_keys_on_leaf_dtypes(rng):
    g = _raw_graphs(rng, 1)[0]
    a = TG.from_numpy(*g, n_pad=16, e_pad=32)
    b = TG.from_numpy(g[0], g[1], g[2].astype(np.float16), g[3], n_pad=16, e_pad=32)
    assert trace_signature(a) != trace_signature(b)
    assert trace_signature(a) == trace_signature(a)
    assert trace_signature(a)[:2] == (("eig", False), ("lay", False))


def test_stream_dtype_change_warms_outside_timed_region(rng):
    """A mid-stream dtype change in one bucket is a new signature, warmed
    untimed; on a stepping clock every timed region is exactly one step."""
    cfg, params = _gin()
    ex = Executor(buckets=BUCKETS, clock=StepClock(), device="cpu")
    eng = GNNEngine(cfg, params, fused=True, executor=ex)
    g = _raw_graphs(rng, 1)[0]
    g_half = (g[0], g[1], g[2].astype(np.float16), g[3])

    _, lats, untimed = eng.infer_stream([g])
    cb = eng._compiled[("stream", 16, 32)]
    assert len(cb.warm) == 1 and lats.tolist() == [STEP] and untimed == STEP
    _, lats, untimed = eng.infer_stream([g_half])  # same bucket, new dtype
    assert len(cb.warm) == 2, "a dtype change must be a new warm signature"
    assert lats.tolist() == [STEP] and untimed == STEP
    assert eng.compile_seconds == 0.0  # the CPU captures nothing
    _, lats, untimed = eng.infer_stream([g, g_half])
    assert untimed == 0.0 and lats.tolist() == [STEP, STEP]
    assert eng.warm_seconds == 2 * STEP and ex.lowered_count == 0


def test_num_graphs_is_part_of_the_program_cache_key(rng):
    cfg, params = _gin()
    ex = Executor(buckets=BUCKETS, device="cpu")
    ex.register("m", cfg, params)
    gs = [(rng.integers(0, 5, 6).astype(np.int32), rng.integers(0, 5, 6).astype(np.int32),
           rng.normal(size=(5, 9)).astype(np.float32),
           rng.normal(size=(6, 3)).astype(np.float32)) for _ in range(2)]
    g = TG.batch_graphs(gs, n_pad=16, e_pad=32)
    out1, _ = ex.run(prepared(g, None, None, ("bucket", 16, 32), 1), model="m")
    out2, _ = ex.run(prepared(g, None, None, ("bucket", 16, 32), 2), model="m")
    assert out1.shape == (1, cfg.out_dim) and out2.shape == (2, cfg.out_dim)
    assert len(ex._compiled) == 2
    assert ex.has_program(("bucket", 16, 32), 2) and not ex.has_program(("bucket", 16, 32), 3)


# -------------------------------------------------------------------- tenants


def test_same_architecture_tenants_share_programs_not_params(rng):
    """Equal (cfg, precision, fused): one program record per bucket, each
    tenant with its own params and its own warm signature (a captured graph
    holds its tenant's params); steady state warms nothing."""
    cfg, params_a = _gin(0)
    _, params_b = _gin(7)
    ex = Executor(buckets=BUCKETS, device="cpu")
    ex.register("a", cfg, params_a)
    ex.register("b", cfg, params_b)
    g = _raw_graphs(rng, 1)[0]
    out_a, _ = ex.run(ex.prepare_stream(g), model="a")
    n_programs, before = len(ex._compiled), ex.untimed_seconds
    out_b, _ = ex.run(ex.prepare_stream(g), model="b")
    assert len(ex._compiled) == n_programs == 1
    assert ex.untimed_seconds > before  # b warms its own signature
    assert not np.array_equal(out_a, out_b)
    steady = ex.untimed_seconds
    ex.run(ex.prepare_stream(g), model="a")
    ex.run(ex.prepare_stream(g), model="b")
    assert ex.untimed_seconds == steady
    assert ex.tenant("a").params is not ex.tenant("b").params


def test_tenant_resolution_and_registration_errors():
    cfg, params = _gin()
    ex = Executor(device="cpu")
    ex.register("only", cfg, params)
    assert ex.tenant() is ex.tenant("only")
    with pytest.raises(ValueError, match="already registered"):
        ex.register("only", cfg, params)
    with pytest.raises(KeyError, match="no tenant"):
        ex.tenant("missing")
    ex.register("second", cfg, params)
    with pytest.raises(KeyError, match="model name required"):
        ex.tenant()
    with pytest.raises(ValueError, match="calib_graphs"):
        ex.register("static", cfg, params, precision="int8-static")


def test_facade_rejects_engine_level_executor_config():
    cfg, params = _gin()
    ex = Executor(device="cpu")
    with pytest.raises(ValueError, match="belong to the executor"):
        GNNEngine(cfg, params, buckets=BUCKETS, executor=ex)
    with pytest.raises(ValueError, match="belong to the executor"):
        GNNEngine(cfg, params, device="cpu", executor=ex, name="x")
    eng = GNNEngine(cfg, params, executor=ex)  # defaults are fine
    assert eng.executor is ex and eng.device == torch.device("cpu")
    assert eng.name == "default" and eng.executor.tenant() is eng._tenant


def test_facade_compile_seconds_is_per_tenant(rng):
    """Two facades on one executor: each reports only its own tenant's
    untimed cost, on a stepping clock exactly."""
    cfg_a, cfg_b = _small("gcn")[1], _small("gat")[1]
    ex = Executor(buckets=BUCKETS, clock=StepClock(), device="cpu")
    a = GNNEngine(cfg_a, _params(_small("gcn")[0])[1], executor=ex, name="a")
    b = GNNEngine(cfg_b, _params(_small("gat")[0], 1)[1], executor=ex, name="b")
    g = _raw_graphs(rng, 1)
    _, _, untimed_a = a.infer_stream(g)
    assert untimed_a == STEP == a.compile_seconds + a.warm_seconds
    assert a.compile_seconds == 0.0 and b.compile_seconds + b.warm_seconds == 0.0
    _, _, untimed_b = b.infer_stream(g)
    assert untimed_b == STEP and a.warm_seconds == STEP
    assert ex.untimed_seconds == untimed_a + untimed_b


# --------------------------------------------------------- run_async / pending


def test_pending_runs_harvest_in_any_order(rng):
    """Two runs dispatched before either is harvested each return their own
    output (the card clones the graph's static output at dispatch);
    ``result()`` is cached and ``done`` flips at harvest."""
    cfg, params = _gin()
    ex = Executor(buckets=BUCKETS, device="cpu")
    ex.register("m", cfg, params)
    g1, g2 = _raw_graphs(rng, 2)
    p1, p2 = ex.prepare_stream(g1), ex.prepare_stream(g2)
    want1, want2 = ex.run(p1)[0], ex.run(p2)[0]
    r1, r2 = ex.run_async(p1), ex.run_async(p2)
    assert not r1.done and not r2.done
    got2 = r2.result()
    assert r2.done and not r1.done
    got1 = r1.result()
    _bitwise(got1[0], want1, "first pending run")
    _bitwise(got2[0], want2, "second pending run")
    assert not np.array_equal(got1[0], got2[0])
    assert r1.result() is got1 and r1._out is None


def test_warm_without_a_timed_run(rng):
    cfg, params = _gin()
    ex = Executor(buckets=BUCKETS, clock=StepClock(), device="cpu")
    ex.register("m", cfg, params)
    p = ex.prepare_stream(_raw_graphs(rng, 1)[0])
    assert not ex.has_program(p.bucket_key, 1)
    assert ex.warm(p) == STEP and ex.warm(p) == 0.0
    assert ex.has_program(p.bucket_key, 1) and ex.warm_seconds == STEP
    _, dt = ex.run(p)
    assert dt == STEP and ex.warm_seconds == STEP


# ----------------------------------------------------------------- telemetry


def test_executor_telemetry_is_exact_on_a_stepping_clock(rng):
    """Program build, warm (its untimed cost, no capture on the CPU), and per
    run ``executor_run`` + ``unpack_d2h`` with their durations; the counters
    agree; with the sinks dark the executor reads its clock 2 times a warm
    and 2 a run, lit 2 more a run."""
    cfg, params = _gin()
    graphs = _raw_graphs(rng, 3)

    def serve(**sinks):
        clock = StepClock()
        ex = Executor(buckets=BUCKETS, clock=clock, device="cpu", **sinks)
        ex.register("m", cfg, params)
        outs = [ex.run(ex.prepare_stream(g))[0] for g in graphs]
        return ex, clock, outs

    dark, dark_clock, dark_outs = serve()
    tracer, reg = Tracer(VirtualClock()), MetricsRegistry()
    ex, clock, outs = serve(tracer=tracer, metrics=reg)
    warms = len(next(iter(ex._compiled.values())).warm)
    assert dark_clock.reads == 2 * warms + 2 * len(graphs)
    assert clock.reads == dark_clock.reads + 2 * len(graphs)
    for a, b in zip(outs, dark_outs):
        _bitwise(a, b, "telemetry changes no output")

    bucket = str(("stream", 16, 32))
    assert [(s.name, s.t0_s, s.t1_s, dict(s.attrs)) for s in tracer.spans] == (
        [("program_build", 0.0, None, dict(tenant="m", bucket=bucket, num_graphs=1)),
         ("warm", 0.0, None, dict(bucket=bucket, dur_s=STEP, compile_s=0.0))]
        + [("executor_run", 0.0, None, dict(tenant="m", bucket=bucket, dur_s=STEP)),
           ("unpack_d2h", 0.0, None, dict(tenant="m", bucket=bucket, dur_s=STEP))]
        * len(graphs))
    assert warms == 1
    assert reg.get("serve_programs_built_total").value() == 1
    assert reg.get("serve_warms_total").value() == 1
    assert reg.get("serve_compile_seconds_total").value() == 0.0
    assert reg.get("serve_warm_seconds_total").value() == STEP
    assert reg.get("serve_device_seconds_total").value() == STEP * len(graphs)
    assert reg.get("serve_d2h_seconds_total").value() == STEP * len(graphs)


def test_attach_telemetry_first_attachment_wins():
    ex = Executor(device="cpu")
    t1, r1 = Tracer(VirtualClock()), MetricsRegistry()
    ex.attach_telemetry(tracer=t1, metrics=r1)
    ex.attach_telemetry(tracer=Tracer(VirtualClock()), metrics=MetricsRegistry())
    assert ex.tracer is t1 and ex.metrics is r1 and ex._mi.registry is r1


def test_eigvec_lookups_are_counted(rng):
    jcfg, tcfg = _small("dgn")
    reg = MetricsRegistry()
    ex = Executor(buckets=BUCKETS, device="cpu", metrics=reg)
    ex.register("m", tcfg, _params(jcfg)[1])
    g = _raw_graphs(rng, 1)[0]
    ex.prepare_stream(g, with_eigvec=True)
    ex.prepare_stream(g, with_eigvec=True)
    c = reg.get("serve_eigvec_cache_total")
    assert (c.value(result="miss"), c.value(result="hit")) == (1.0, 1.0)

"""The per-call-sort path (``share_layout=False``) of the PyTorch port on the
CPU, against its own shared-plan path and against the JAX package's
``apply(..., share_layout=False)``.

* **Bit for bit the shared forward** (as ``tests/test_layout_parity.py``
  holds JAX): for the six models (GIN+VN among them), fp32 and int8,
  single and packed graphs, the port's per-call forward equals its
  unfused shared forward exactly, and ``fused=True`` without a plan takes
  that same unfused path (JAX's guard: no plan, no fused layer).
* **Against JAX's per-call forward**: fp32 within rtol 1e-4, atol 1e-6
  (PNA 5e-3), the tolerances of ``tests/test_torch_models.py``; int8
  within the quantization-noise bound of ``tests/test_torch_quant.py``
  (MAE(port - jax) <= 0.2 MAE(jax int8 - jax fp32) + 1e-5).
* **Plan-less DGN weights** equal what ``with_dgn_weights`` caches.
* **Sort counts**, ``aten.sort`` under a ``TorchDispatchMode``: the shared
  forward without a plan sorts once, a pre-planned one never, and the
  per-call forward as often as JAX's jaxpr has ``sort`` ops
  (``benchmarks/bench_layout.py:count_jaxpr_sorts``).
* **Serving**: ``GNNEngine(share_layout=False)`` and
  ``Executor.register(share_layout=False)`` serve stream, batched and
  packed batches, bit for bit the shared engine (unfused); ``program_key``
  separates the two tenants; ``prepare_packed(model=...)`` builds no plan
  for a per-call tenant; a scheduler run of a per-call tenant flushes as
  JAX's does and its flushed batches carry no plan.
"""
import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import batching as JB
from repro.gnn import models as JM
from repro.serve.gnn_engine import GNNEngine as JEngine
from repro.serve.scheduler import StreamScheduler as JScheduler
from repro_torch.core import batching as TB
from repro_torch.core import layout as TLY
from repro_torch.core import message_passing as TMP
from repro_torch.gnn import models as TM
from repro_torch.serve.executor import Executor
from repro_torch.serve.gnn_engine import GNNEngine as TEngine
from repro_torch.serve.scheduler import StreamScheduler as TScheduler
from test_torch_layout import _eigvec, _graph_pair, _np
from test_torch_models import MODELS, _configs, _eig_for, _inputs, _params, _tol
from test_torch_quant import _noise_bound, _quantized_pair
from test_torch_scheduler import SERVE_TOL, converted, raw_graphs, small_config

torch.set_num_threads(1)

KINDS = ("single", "packed")
PRECISIONS = ("fp32", "int8")


def _case(model, precision, kind):
    """-> (jcfg, tcfg, jax params, jax params served, port params served,
    inputs): fp32 params, or int8 ones quantized by JAX and converted."""
    if precision == "fp32":
        jcfg, tcfg = _configs(model)
        jp, tp = _params(jcfg)
        jq = jp
    else:
        jcfg, tcfg, jp, jq, tp = _quantized_pair(model, precision)
    return jcfg, tcfg, jp, jq, tp, _inputs(kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("model", MODELS)
def test_percall_forward_equals_shared_bitwise(model, precision, fused, kind):
    _, tcfg, _, _, tp, (_, tg, m, _, tl, eig) = _case(model, precision, kind)
    te = _eig_for(tcfg.model, eig)[1]
    shared = TM.apply(tp, tg, tcfg, eigvec=te, num_graphs=m, layout=tl)
    # a plan handed in is dropped, as JAX drops it
    percall = TM.apply(tp, tg, tcfg, eigvec=te, num_graphs=m, layout=tl,
                       share_layout=False, fused=fused)
    assert torch.equal(percall, shared)
    program = TM.forward_program(tcfg, num_graphs=m, share_layout=False,
                                 fused=fused)
    assert torch.equal(program(tp, tg, te, None), shared)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("model", MODELS)
def test_percall_forward_matches_jax(model, precision, fused, kind):
    jcfg, tcfg, jp, jq, tp, (jg, tg, m, _, _, eig) = _case(model, precision, kind)
    je, te = _eig_for(tcfg.model, eig)
    want = np.asarray(JM.apply(jq, jg, jcfg, eigvec=je, num_graphs=m,
                               share_layout=False, fused=fused))
    got = TM.apply(tp, tg, tcfg, eigvec=te, num_graphs=m, share_layout=False,
                   fused=fused).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    if precision == "fp32":
        np.testing.assert_allclose(got, want, **_tol(model))
    else:
        fp32 = np.asarray(JM.apply(jp, jg, jcfg, eigvec=je, num_graphs=m,
                                   share_layout=False))
        _noise_bound(got, want, fp32)


def test_percall_dgn_needs_its_eigenvector():
    _, tcfg = _configs("dgn")
    _, tp = _params(_configs("dgn")[0])
    _, tg, m, _, _, _ = _inputs("single")
    with pytest.raises(ValueError, match="eigenvector"):
        TM.apply(tp, tg, tcfg, num_graphs=m, share_layout=False)


@pytest.mark.parametrize("kind", ["single", "batched", "packed"])
def test_planless_dgn_weights_equal_the_cached_ones_bitwise(kind):
    _, tg = _graph_pair(kind, 13)
    eig = torch.from_numpy(_eigvec(tg, 13))
    cached = TLY.for_model(None, tg, "dgn", eigvec=eig)
    w_e, denom, wsum = TMP.dgn_directional_weights(tg, eig)
    assert torch.equal(w_e, cached.dgn_w_e)
    assert torch.equal(denom, cached.dgn_denom)
    assert torch.equal(wsum, cached.dgn_wsum)


@pytest.mark.parametrize("kind", ["single", "packed"])
def test_csr_plan_sorts_once_with_offsets(kind):
    """Without a plan ``csr_plan`` gives the plan's four arrays bit for bit
    (one sort); ``edge_plan`` keeps JAX's three."""
    _, tg = _graph_pair(kind, 14)
    lay = TLY.build_layout(tg)
    with SortCount() as sc:
        fresh = TLY.csr_plan(None, tg)
    assert sc.n == 1
    for got, name in zip(fresh, ("perm", "ids_sorted", "offsets", "src_sorted")):
        assert torch.equal(got, getattr(lay, name)), name
    assert all(a is b for a, b in zip(TLY.csr_plan(lay, tg),
                                      (lay.perm, lay.ids_sorted, lay.offsets,
                                       lay.src_sorted)))
    assert len(TLY.edge_plan(None, tg)) == 3


# ----------------------------------------------------------------- sort counts


class SortCount(TorchDispatchMode):
    """Counts ``aten.sort`` calls (``torch.sort``, ``argsort``) below it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.sort:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _sorts(fn) -> int:
    with SortCount() as sc:
        fn()
    return sc.n


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("model", MODELS)
def test_sort_counts_match_jax(model, fused):
    from benchmarks.bench_layout import count_jaxpr_sorts

    jcfg, tcfg = _configs(model)
    jp, tp = _params(jcfg)
    jg, tg, m, _, _, eig = _inputs("single")
    je, te = _eig_for(tcfg.model, eig)
    lay = TLY.build_layout(tg)
    run = lambda **kw: TM.apply(tp, tg, tcfg, eigvec=te, num_graphs=m,
                                fused=fused, **kw)
    assert _sorts(lambda: run()) == 1
    assert _sorts(lambda: run(layout=lay)) == 0
    percall = _sorts(lambda: run(share_layout=False))
    jaxpr = jax.make_jaxpr(lambda p, g, e: JM.apply(
        p, g, jcfg, eigvec=e, num_graphs=m, share_layout=False, fused=fused))
    want = count_jaxpr_sorts(jaxpr(jp, jg, je).jaxpr)
    assert percall == want and percall >= jcfg.num_layers


# --------------------------------------------------------------------- serving


@pytest.mark.parametrize("model", MODELS)
def test_engine_percall_serves_every_mode_as_the_shared_engine(model, rng):
    """``GNNEngine(share_layout=False, fused=True)`` against the shared
    unfused engine, bit for bit, in the three modes; its stream against
    JAX's per-call engine within the parity tolerance."""
    jcfg, tcfg = small_config(model)
    jp, tp = converted(jcfg)
    dgn = tcfg.model == "dgn"
    graphs = raw_graphs(6, nodes=(5, 14), seed=5)
    buckets = ((16, 32), (32, 64))
    percall = TEngine(tcfg, tp, buckets=buckets, share_layout=False, fused=True,
                      device="cpu")
    shared = TEngine(tcfg, tp, buckets=buckets, device="cpu")
    assert not percall.share_layout and percall.fused and shared.share_layout
    assert percall.buckets == sorted(buckets) and percall.params is not None
    a, _, _ = percall.infer_stream(graphs, with_eigvec=dgn)
    b, _, _ = shared.infer_stream(graphs, with_eigvec=dgn)
    np.testing.assert_array_equal(np.concatenate(a), np.concatenate(b))
    want, _, _ = JEngine(jcfg, jp, buckets=buckets, share_layout=False,
                         fused=True).infer_stream(graphs, with_eigvec=dgn)
    np.testing.assert_allclose(np.concatenate(a), np.concatenate(want),
                               **(_tol(model) if model == "pna" else SERVE_TOL))
    kw = dict(batch_size=3, n_pad=48, e_pad=128, with_eigvec=dgn)
    np.testing.assert_array_equal(percall.infer_batched(graphs, **kw)[0],
                                  shared.infer_batched(graphs, **kw)[0])
    budget = TB.BucketBudget(128, 384, 8)
    packed, meta = TB.pack_graphs(graphs, budget)
    eig = None
    if dgn:
        from repro_torch.data.pipeline import laplacian_eigvec

        eig = TB.pack_eigvecs([laplacian_eigvec(g[0], g[1], g[2].shape[0], None)
                               for g in graphs], meta)
    pa, _ = percall.infer_packed(packed, budget, eigvec=eig)
    pb, _ = shared.infer_packed(packed, budget, eigvec=eig)
    np.testing.assert_array_equal(pa, pb)


def test_program_key_separates_layout_tenants(rng):
    jcfg, tcfg = small_config("gin")
    _, tp = converted(jcfg)
    ex = Executor(buckets=((16, 32),), device="cpu")
    ex.register("shared", tcfg, tp, fused=True)
    ex.register("percall", tcfg, tp, fused=True, share_layout=False)
    ks, kp = ex.tenant("shared").program_key, ex.tenant("percall").program_key
    assert ks == (tcfg, "fp32", True, True) and kp == (tcfg, "fp32", False, True)
    graphs = raw_graphs(4, nodes=(5, 14), seed=6)
    budget = TB.BucketBudget(64, 192, 4)
    packed, _ = TB.pack_graphs(graphs, budget)
    ps = ex.prepare_packed(packed, budget, model="shared")
    pp = ex.prepare_packed(packed, budget, model="percall")
    assert ps.layout is not None and pp.layout is None
    assert ps.signature != pp.signature
    out_p, _ = ex.run(pp, model="percall")
    unfused = Executor(buckets=((16, 32),), device="cpu")
    unfused.register("u", tcfg, tp)
    out_u, _ = unfused.run(unfused.prepare_packed(packed, budget, model="u"), model="u")
    np.testing.assert_array_equal(out_p, out_u)
    for g in graphs:
        a, _ = ex.run(ex.prepare_stream(g), model="percall")
        b, _ = unfused.run(unfused.prepare_stream(g), model="u")
        np.testing.assert_array_equal(a, b)
    ex.run(ps, model="shared")
    by_key = {k[0] for k in ex._compiled}
    assert by_key == {ks, kp}


def test_scheduler_percall_tenant_flushes_as_jax(monkeypatch):
    """A stream of a per-call tenant through the port's scheduler and JAX's
    (all queued at t=0): the same flushes (request ids, reasons, rungs),
    outputs within SERVE_TOL, and no flushed batch carries a plan."""
    jcfg, tcfg = small_config("gat")
    jp, tp = converted(jcfg)
    graphs = raw_graphs(10, nodes=(5, 14), seed=7)
    teng = TEngine(tcfg, tp, buckets=((16, 32),), share_layout=False, device="cpu")
    jeng = JEngine(jcfg, jp, buckets=((16, 32),), share_layout=False)
    layouts = []
    run = teng.executor.run_async

    def spy(p, model=None):
        layouts.append(p.layout)
        return run(p, model=model)

    monkeypatch.setattr(teng.executor, "run_async", spy)
    trep = TScheduler(teng, capacity=2).run(graphs, qps=0.0)
    jrep = JScheduler(jeng, capacity=2).run(graphs, qps=0.0)
    shape = lambda rep: [(f.rids, f.reason, f.rung_multiple) for f in rep.flush_log]
    assert shape(trep) == shape(jrep) and len(trep.flush_log) > 1
    assert layouts and all(lay is None for lay in layouts)
    np.testing.assert_allclose(np.concatenate(trep.outputs),
                               np.concatenate([np.asarray(o) for o in jrep.outputs]),
                               **SERVE_TOL)

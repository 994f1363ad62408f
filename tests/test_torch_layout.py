"""Parity of the PyTorch port's graph layer with the JAX package.

The same numpy inputs go through ``repro`` (JAX, CPU) and ``repro_torch``
(PyTorch, CPU):

  * layout plans (``perm``, ``ids_sorted``, ``offsets``, ``src_sorted``,
    ``in_degree``) from ``build_layout`` and ``host_layout`` on random
    padded, batched and packed graphs are bitwise equal;
  * GCN's ``gcn_inv_sqrt`` agrees within 2 ulp: XLA:CPU lowers
    ``lax.rsqrt`` to a hardware reciprocal-square-root estimate refined by
    Newton steps (up to 2 ulp off the correctly rounded value), while
    ``torch.rsqrt`` on the CPU rounds correctly;
  * segment reductions (every op, padding ids, empty segments): atol 1e-6;
  * PNA's ``pna_scalers`` within rtol 1e-6 (``log`` may differ by an ulp)
    and DGN's ``dgn_w_e`` / ``dgn_denom`` / ``dgn_wsum`` within rtol 1e-5,
    from the same eigenvector;
  * graph construction, packing and unpacking, the molecule stream, DGN's
    ``laplacian_eigvec`` and ``pack_eigvecs`` are identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batching as JB
from repro.core import graph as JG
from repro.core import layout as JLY
from repro.core import message_passing as JMP
from repro.core import scatter_gather as JSG
from repro.data import pipeline as JP
from repro.kernels import ref as JREF
from repro_torch.core import batching as TB
from repro_torch.core import graph as TG
from repro_torch.core import layout as TLY
from repro_torch.core import message_passing as TMP
from repro_torch.core import scatter_gather as TSG
from repro_torch.data import pipeline as TP
from repro_torch.kernels import ref as TREF

torch.set_num_threads(1)

PLAN_FIELDS = ("perm", "ids_sorted", "offsets", "src_sorted", "in_degree")
GRAPH_FIELDS = ("node_feat", "edge_index", "edge_feat", "node_mask",
                "edge_mask", "graph_id", "n_graph")


def _raw_graphs(rng, n_graphs):
    gs = []
    for _ in range(n_graphs):
        n = int(rng.integers(3, 14))
        e = int(rng.integers(0, 2 * n))
        gs.append((rng.integers(0, n, e).astype(np.int32),
                   rng.integers(0, n, e).astype(np.int32),
                   rng.normal(size=(n, 9)).astype(np.float32),
                   rng.normal(size=(e, 3)).astype(np.float32)))
    return gs


def _graph_pair(kind, seed):
    """(JAX Graph, torch Graph) built from the same numpy inputs."""
    rng = np.random.default_rng(seed)
    if kind == "single":
        s, r, nf, ef = _raw_graphs(rng, 1)[0]
        args = (s, r, nf, ef)
        kw = dict(n_pad=nf.shape[0] + 5, e_pad=len(s) + 7)
        return JG.from_numpy(*args, **kw), TG.from_numpy(*args, **kw)
    if kind == "batched":
        gs = _raw_graphs(rng, 4)
        return (JG.batch_graphs(gs, n_pad=64, e_pad=128),
                TG.batch_graphs(gs, n_pad=64, e_pad=128))
    gs = [g[:4] for g in JP.MoleculeStream(JP.MOLHIV, seed=seed).take(6)]
    budget = JB.BucketBudget(n_pad=256, e_pad=768, g_pad=8)
    jg, _ = JB.pack_graphs(gs, budget)
    tg, _ = TB.pack_graphs(gs, TB.BucketBudget(256, 768, 8))
    return jg, tg


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("kind", ["single", "batched", "packed"])
def test_graph_construction_identical(kind):
    jg, tg = _graph_pair(kind, 0)
    for name in GRAPH_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tg, name)),
                                      _np(getattr(jg, name)), err_msg=name)


@pytest.mark.parametrize("make", ["build_layout", "host_layout"])
@pytest.mark.parametrize("kind", ["single", "batched", "packed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_layout_plan_bitwise(kind, make, seed):
    jg, tg = _graph_pair(kind, seed)
    jl = getattr(JLY, make)(jg)
    tl = getattr(TLY, make)(tg)
    for name in PLAN_FIELDS:
        got, want = _np(getattr(tl, name)), _np(getattr(jl, name))
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("kind", ["single", "batched", "packed"])
def test_host_and_device_plans_agree(kind):
    _, tg = _graph_pair(kind, 3)
    a, b = TLY.build_layout(tg), TLY.host_layout(tg)
    for name in PLAN_FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("kind", ["single", "batched", "packed"])
def test_gcn_norms_within_two_ulp(kind):
    jg, tg = _graph_pair(kind, 2)
    want = _np(JLY.for_model(None, jg, "gcn").gcn_inv_sqrt)
    got = _np(TLY.for_model(None, tg, "gcn").gcn_inv_sqrt)
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 2


def test_edge_plan_without_layout_matches_jax():
    jg, tg = _graph_pair("batched", 4)
    for got, want in zip(TLY.edge_plan(None, tg), JLY.edge_plan(None, jg)):
        np.testing.assert_array_equal(_np(got), _np(want))


def _segment_inputs(seed, e=90, f=5, n=20):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(e, f)).astype(np.float32)
    # ids outside [0, n) are padding; ids n-4..n-1 stay empty
    ids = rng.integers(0, n - 4, e).astype(np.int32)
    ids[rng.random(e) < 0.2] = n
    ids[:3] = n + 7
    return values, ids, n


@pytest.mark.parametrize("op", JSG.REDUCTIONS)
@pytest.mark.parametrize("presorted", [False, True])
def test_segment_reduce_matches_jax(op, presorted):
    values, ids, n = _segment_inputs(5)
    if presorted:
        order = np.argsort(ids, kind="stable")
        values, ids = values[order], ids[order]
    want = np.asarray(JSG.segment_reduce(jnp.asarray(values), jnp.asarray(ids),
                                         n, op, indices_are_sorted=presorted))
    got = TSG.segment_reduce(torch.from_numpy(values), torch.from_numpy(ids),
                             n, op).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[n - 4:] == 0).all()


@pytest.mark.parametrize("op", ["sum", "mean", "sqsum", "max", "min"])
def test_segment_reduce_sorted_ref_matches_jax(op):
    values, ids, n = _segment_inputs(6)
    order = np.argsort(ids, kind="stable")
    values, ids = values[order], ids[order]
    want = np.asarray(JREF.segment_reduce_sorted_ref(
        jnp.asarray(values), jnp.asarray(ids), n, op))
    got = TREF.segment_reduce_sorted_ref(
        torch.from_numpy(values), torch.from_numpy(ids), n, op).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_sorted_segment_reduce_matches_jax(op):
    values, ids, n = _segment_inputs(7)
    want = np.asarray(JSG.sorted_segment_reduce(
        jnp.asarray(values), jnp.asarray(ids), n, op))
    got = TSG.sorted_segment_reduce(
        torch.from_numpy(values), torch.from_numpy(ids), n, op).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("ops", [("sum",), ("mean", "max", "min", "std")])
@pytest.mark.parametrize("with_layout", [False, True])
def test_gather_scatter_matches_jax(ops, with_layout):
    jg, tg = _graph_pair("batched", 8)
    msg = np.random.default_rng(8).normal(size=(jg.num_edges, 4)).astype(np.float32)
    jl = JLY.build_layout(jg) if with_layout else None
    tl = TLY.build_layout(tg) if with_layout else None
    want = np.asarray(JMP.gather_scatter(jg, jnp.asarray(msg), ops, layout=jl))
    got = TMP.gather_scatter(tg, torch.from_numpy(msg), ops, layout=tl).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("op", ["mean", "sum"])
def test_global_pool_drops_padded_nodes(op):
    jg, tg = _graph_pair("packed", 9)
    x = np.random.default_rng(9).normal(size=(jg.num_nodes, 6)).astype(np.float32)
    want = np.asarray(JMP.global_pool(jg, jnp.asarray(x), op, num_graphs=8))
    got = TMP.global_pool(tg, torch.from_numpy(x), op, num_graphs=8).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_pack_and_unpack_identical():
    gs = [g[:4] for g in JP.MoleculeStream(JP.MOLHIV, seed=3).take(5)]
    jg, jm = JB.pack_graphs(gs, JB.BucketBudget(192, 512, 8))
    tg, tm = TB.pack_graphs(gs, TB.BucketBudget(192, 512, 8))
    assert (tm.node_counts, tm.edge_counts, tm.node_offsets) == \
        (jm.node_counts, jm.edge_counts, jm.node_offsets)
    for name in GRAPH_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tg, name)),
                                      _np(getattr(jg, name)), err_msg=name)
    jl, tl = JB.pack_layout(jg), TB.pack_layout(tg)
    for name in PLAN_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tl, name)),
                                      _np(getattr(jl, name)), err_msg=name)
    out = np.random.default_rng(3).normal(size=(192, 2)).astype(np.float32)
    for level, arr in (("graph", out[:8]), ("node", out)):
        for a, b in zip(TB.unpack_outputs(arr, tm, level),
                        JB.unpack_outputs(arr, jm, level)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        TB.pack_graphs(gs, TB.BucketBudget(8, 8, 1))
    assert TB.BucketBudget(64, 192, 2).admits(0, 0, 1, 64, 192)


def test_molecule_stream_identical():
    for stats in ("MOLHIV", "MOLPCBA"):
        jt = JP.MoleculeStream(getattr(JP, stats), seed=11).take(4)
        tt = TP.MoleculeStream(getattr(TP, stats), seed=11).take(4)
        for ja, ta in zip(jt, tt):
            for x, y in zip(ja, ta):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("kind", ["single", "batched", "packed"])
def test_pna_scalers_match_jax(kind):
    jg, tg = _graph_pair(kind, 10)
    want = _np(JLY.for_model(None, jg, "pna", avg_degree=2.2).pna_scalers)
    got = TLY.for_model(None, tg, "pna", avg_degree=2.2).pna_scalers
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=0)


def _eigvec(tg, seed):
    """A per-node vector with padding rows 0, as DGN's input has."""
    vec = np.random.default_rng(seed).normal(size=(tg.num_nodes,)).astype(np.float32)
    return np.where(_np(tg.node_mask), vec, 0.0).astype(np.float32)


@pytest.mark.parametrize("kind", ["single", "batched", "packed"])
def test_dgn_weights_match_jax(kind):
    jg, tg = _graph_pair(kind, 11)
    eig = _eigvec(tg, 11)
    jl = JLY.for_model(None, jg, "dgn", eigvec=jnp.asarray(eig))
    tl = TLY.for_model(None, tg, "dgn", eigvec=torch.from_numpy(eig))
    for name in ("dgn_w_e", "dgn_denom", "dgn_wsum"):
        got, want = _np(getattr(tl, name)), _np(getattr(jl, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=name)
    # the plan-less weights of the JAX package agree with the cached ones
    w_e, wsum = JMP.dgn_directional_weights(jg, jnp.asarray(eig))
    np.testing.assert_allclose(_np(tl.dgn_w_e), _np(w_e), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(tl.dgn_wsum), _np(wsum), rtol=1e-5, atol=1e-7)
    # attached once: a second call keeps the plan's values
    assert TLY.for_model(tl, tg, "dgn", eigvec=None) is tl


def test_dgn_needs_its_eigenvector():
    _, tg = _graph_pair("single", 12)
    with pytest.raises(ValueError, match="eigenvector"):
        TLY.for_model(None, tg, "dgn")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_laplacian_eigvec_and_pack_identical(seed):
    gs = [g[:4] for g in JP.MoleculeStream(JP.MOLHIV, seed=seed).take(4)]
    for s, r, nf, _ in gs:
        n = nf.shape[0]
        for n_pad in (None, n + 7):
            np.testing.assert_array_equal(TP.laplacian_eigvec(s, r, n, n_pad),
                                          JP.laplacian_eigvec(s, r, n, n_pad))
    vecs = [TP.laplacian_eigvec(g[0], g[1], g[2].shape[0]) for g in gs]
    _, jm = JB.pack_graphs(gs, JB.BucketBudget(256, 768, 8))
    _, tm = TB.pack_graphs(gs, TB.BucketBudget(256, 768, 8))
    got = TB.pack_eigvecs(vecs, tm)
    np.testing.assert_array_equal(got, JB.pack_eigvecs(vecs, jm))
    assert got.dtype == np.float32 and not got[sum(tm.node_counts):].any()

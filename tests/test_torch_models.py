"""The six models through the PyTorch port against the JAX package, end to
end (GCN, GIN, GIN+VN, GAT, PNA, DGN at 3 layers, hidden 16, GAT 2 heads
x 8).

  * ``apply`` logits for every model x {single, batched, packed} x
    {fused, unfused} match JAX ``apply`` (its default CPU mode, the
    reference path) at rtol 1e-4, atol 1e-6 (PNA 5e-3, the std tolerance
    of ``tests/test_fused_mp.py``) — the same params, converted by
    ``repro_torch.convert.from_jax_params``, and the same numpy inputs;
    DGN gets the same eigenvector array on both sides;
  * the port's fused and unfused forwards agree within 1e-6, and both
    match the port's dense oracle ``gnn.reference.apply_dense`` and
    JAX's;
  * ``GNNEngine.infer_stream`` / ``infer_packed`` / ``infer_batched``
    match JAX's engine on the same 8 graphs (DGN with its eigenvector);
  * entry points raise without CUDA unless ``device="cpu"`` is given;
  * no module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
    ``jax`` or ``repro`` (an AST walk).
"""
import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import batching as JB
from repro.core import graph as JG
from repro.data import pipeline as JP
from repro.gnn import models as JM
from repro.gnn import reference as JR
from repro.serve.gnn_engine import GNNEngine as JEngine
from repro_torch.configs.gengnn_models import get_gnn_config
from repro_torch.convert import from_jax_params
from repro_torch.core import batching as TB
from repro_torch.core import graph as TG
from repro_torch.gnn import models as TM
from repro_torch.gnn import reference as TR
from repro_torch.launch import serve as TS
from repro_torch.serve.executor import Executor
from repro_torch.serve.gnn_engine import GNNEngine as TEngine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MODELS = ("gcn", "gin", "gin_vn", "gat", "pna", "dgn")
KINDS = ("single", "batched", "packed")
RTOL, ATOL = 1e-4, 1e-6


def _tol(model):
    """PNA's std amplifies one rounding of sqsum/c - mean^2."""
    return dict(rtol=5e-3, atol=5e-3) if model == "pna" else dict(rtol=RTOL, atol=ATOL)


def _configs(name):
    small = dict(num_layers=3, hidden=16, heads=2, head_features=8)
    jcfg = (JM.paper_config("gin", virtual_node=True, **small) if name == "gin_vn"
            else JM.paper_config(name, **small))
    return jcfg, get_gnn_config(name, **small)


def _params(jcfg, seed=0):
    jp = JM.init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    # GIN's eps and the virtual node's embedding and last VN layer are 0 at
    # init; make them matter
    for lp in jp["layers"]:
        if "eps" in lp:
            lp["eps"] = lp["eps"] + 0.25
    if jcfg.virtual_node:
        jp["vn_embed"] = rng.normal(size=jp["vn_embed"].shape).astype(np.float32)
        for m in jp["vn_mlp"]:
            m[-1]["w"] = (0.2 * rng.normal(size=m[-1]["w"].shape)).astype(np.float32)
    return jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp))


def _eig(g, n_pad=None):
    return JP.laplacian_eigvec(g[0], g[1], g[2].shape[0], n_pad)


def _inputs(kind, seed=0):
    """-> (jax graph, torch graph, num_graphs, jax layout, torch layout,
    eigvec as numpy)."""
    gs = [g[:4] for g in JP.MoleculeStream(JP.MOLHIV, seed=seed).take(5)]
    if kind == "single":
        s, r, nf, ef = gs[0]
        kw = dict(n_pad=64, e_pad=192)
        return JG.from_numpy(s, r, nf, ef, **kw), TG.from_numpy(s, r, nf, ef, **kw), \
            None, None, None, _eig(gs[0], 64)
    if kind == "batched":
        eig = np.zeros((256,), np.float32)
        eig[:sum(g[2].shape[0] for g in gs)] = np.concatenate([_eig(g) for g in gs])
        return JG.batch_graphs(gs, 256, 768), TG.batch_graphs(gs, 256, 768), \
            len(gs), None, None, eig
    jg, jm = JB.pack_graphs(gs, JB.BucketBudget(256, 768, 8))
    tg, _ = TB.pack_graphs(gs, TB.BucketBudget(256, 768, 8))
    eig = JB.pack_eigvecs([_eig(g) for g in gs], jm)
    return jg, tg, 8, JB.pack_layout(jg), TB.pack_layout(tg), eig


def _eig_for(model, eig):
    """(JAX eigvec, torch eigvec): DGN's input, None for the others."""
    if model != "dgn":
        return None, None
    return eig, torch.from_numpy(eig)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("model", MODELS)
def test_apply_matches_jax(model, kind, fused):
    jcfg, tcfg = _configs(model)
    jp, tp = _params(jcfg)
    jg, tg, m, jl, tl, eig = _inputs(kind)
    je, te = _eig_for(tcfg.model, eig)
    want = np.asarray(JM.apply(jp, jg, jcfg, eigvec=je, num_graphs=m, layout=jl,
                               fused=fused))
    got = TM.apply(tp, tg, tcfg, eigvec=te, num_graphs=m, layout=tl,
                   fused=fused).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **_tol(model))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("model", MODELS)
def test_fused_matches_unfused(model, kind):
    _, tcfg = _configs(model)
    _, tp = _params(_configs(model)[0], seed=1)
    _, tg, m, _, tl, eig = _inputs(kind, seed=1)
    te = _eig_for(tcfg.model, eig)[1]
    a = TM.apply(tp, tg, tcfg, eigvec=te, num_graphs=m, layout=tl, fused=True)
    b = TM.apply(tp, tg, tcfg, eigvec=te, num_graphs=m, layout=tl, fused=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["single", "packed"])
@pytest.mark.parametrize("model", MODELS)
def test_apply_matches_dense_oracles(model, kind):
    """The sparse forward, fused and unfused, against the port's dense
    oracle, which in turn matches JAX's (row i of the dense output is
    graph i)."""
    jcfg, tcfg = _configs(model)
    jp, tp = _params(jcfg, seed=2)
    jg, tg, m, _, tl, eig = _inputs(kind, seed=2)
    je, te = _eig_for(tcfg.model, eig)
    dense = TR.apply_dense(tp, tg, tcfg, eigvec=te).numpy()
    np.testing.assert_allclose(
        dense, np.asarray(JR.apply_dense(jp, jg, jcfg, eigvec=je)), **_tol(model))
    for fused in (False, True):
        got = TM.apply(tp, tg, tcfg, eigvec=te, num_graphs=m, layout=tl,
                       fused=fused).numpy()
        np.testing.assert_allclose(got, dense[: got.shape[0]], **_tol(model))


def test_gat_softmax_is_per_edge_instance():
    """A repeated edge counts once per instance in GAT's softmax, as the
    dense oracle weights it by its multiplicity."""
    _, tcfg = _configs("gat")
    _, tp = _params(_configs("gat")[0], seed=3)
    rng = np.random.default_rng(3)
    s = np.array([0, 1, 1, 1, 2, 3], np.int32)
    r = np.array([1, 0, 2, 2, 1, 1], np.int32)  # 1 -> 2 twice
    g = TG.from_numpy(s, r, rng.normal(size=(4, 9)).astype(np.float32),
                      rng.normal(size=(6, 3)).astype(np.float32), n_pad=8, e_pad=10)
    got = TM.apply(tp, g, tcfg, num_graphs=1)
    np.testing.assert_allclose(got.numpy(), TR.apply_dense(tp, g, tcfg)[:1].numpy(),
                               rtol=RTOL, atol=ATOL)


def test_plan_sharing_does_not_change_logits():
    _, tcfg = _configs("gin")
    _, tp = _params(_configs("gin")[0])
    _, tg, m, _, tl, _ = _inputs("packed")
    shared = TM.apply(tp, tg, tcfg, num_graphs=m, layout=tl)
    built = TM.apply(tp, tg, tcfg, num_graphs=m)
    assert torch.equal(shared, built)
    program = TM.forward_program(tcfg, num_graphs=m, fused=True)
    assert torch.equal(program(tp, tg, None, tl),
                       TM.apply(tp, tg, tcfg, num_graphs=m, layout=tl, fused=True))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("model", MODELS)
def test_engine_matches_jax_engine(model, fused):
    jcfg, tcfg = _configs(model)
    jp, tp = _params(jcfg)
    tol = _tol(model)
    dgn = tcfg.model == "dgn"
    graphs = [g[:4] for g in JP.MoleculeStream(JP.MOLHIV, seed=2).take(8)]
    jeng = JEngine(jcfg, jp, fused=fused)
    teng = TEngine(tcfg, tp, fused=fused, device="cpu")
    jouts, _, _ = jeng.infer_stream(graphs, with_eigvec=dgn)
    touts, lats, _ = teng.infer_stream(graphs, with_eigvec=dgn)
    assert len(touts) == 8 and (lats >= 0).all()
    np.testing.assert_allclose(np.concatenate(touts), np.concatenate(jouts), **tol)
    budget = (512, 1536, 8)
    jpk, jmeta = JB.pack_graphs(graphs, JB.BucketBudget(*budget))
    tpk, tmeta = TB.pack_graphs(graphs, TB.BucketBudget(*budget))
    eig = TB.pack_eigvecs([_eig(g) for g in graphs], tmeta) if dgn else None
    jout, _ = jeng.infer_packed(jpk, JB.BucketBudget(*budget), eigvec=eig)
    tout, _ = teng.infer_packed(tpk, TB.BucketBudget(*budget), eigvec=eig)
    for a, b in zip(TB.unpack_outputs(tout, tmeta), JB.unpack_outputs(jout, jmeta)):
        np.testing.assert_allclose(a, b, **tol)
    bout, per_graph = teng.infer_batched(graphs, batch_size=4, n_pad=256,
                                         e_pad=768, with_eigvec=dgn)
    np.testing.assert_allclose(bout, np.concatenate(jouts), **tol)
    assert per_graph >= 0


def test_fused_gin_wider_than_the_kernel_serves_on_cpu():
    """GIN at F = 300, past the CUDA ``fused_mp``'s ``MAX_FEATURES``: on the
    CPU the fused engine serves through the plain version and matches JAX's
    fused engine (which takes its reference path above its VMEM budget).
    On the card the same engine refuses it
    (``tests/test_torch_on_card.py::test_fused_gin_wider_than_the_kernel_is_refused``)."""
    from repro_torch.kernels import fused_mp as FM

    small = dict(num_layers=2, hidden=300)
    jcfg, tcfg = JM.paper_config("gin", **small), get_gnn_config("gin", **small)
    assert tcfg.width > FM.MAX_FEATURES
    jp, tp = _params(jcfg)
    graphs = [g[:4] for g in JP.MoleculeStream(JP.MOLHIV, seed=2).take(4)]
    jouts, _, _ = JEngine(jcfg, jp, fused=True).infer_stream(graphs)
    touts, _, _ = TEngine(tcfg, tp, fused=True, device="cpu").infer_stream(graphs)
    np.testing.assert_allclose(np.concatenate(touts), np.concatenate(jouts),
                               **_tol("gin"))


def test_executor_caches_programs_and_warms_once():
    _, tcfg = _configs("gin")
    _, tp = _params(_configs("gin")[0])
    ex = Executor(device="cpu")
    ex.register("a", tcfg, tp, fused=True)
    ex.register("b", tcfg, tp, fused=True)
    graphs = [g[:4] for g in JP.MoleculeStream(JP.MOLHIV, seed=4).take(3)]
    p = ex.prepare_stream(graphs[0])
    out_a, _ = ex.run(p, model="a")
    warm = ex.warm_seconds
    out_b, _ = ex.run(p, model="b")
    warm_both = ex.warm_seconds
    ex.run(p, model="a")
    ex.run(p, model="b")
    assert np.array_equal(out_a, out_b)
    # same architecture: one program record; each tenant warms its own
    # signature once (on the card a captured graph holds its tenant's
    # params), and neither warms again
    assert len(ex._compiled) == 1 and warm_both > warm > 0
    assert ex.warm_seconds == warm_both
    assert len(next(iter(ex._compiled.values())).warm) == 2
    with pytest.raises(KeyError):
        ex.run(p)  # two tenants: the name is required
    with pytest.raises(ValueError):
        ex.register("a", tcfg, tp)
    with pytest.raises(ValueError):
        ex.bucket_for(10_000, 10)


def test_executor_memoises_eigvecs(monkeypatch):
    """DGN's host eigensolve runs once per graph shape; the LRU is bounded."""
    _, tcfg = _configs("dgn")
    _, tp = _params(_configs("dgn")[0])
    ex = Executor(device="cpu")
    ex.register("dgn", tcfg, tp, fused=True)
    monkeypatch.setattr(Executor, "_EIGVEC_LRU_SIZE", 2)
    graphs = [g[:4] for g in JP.MoleculeStream(JP.MOLHIV, seed=6).take(3)]
    a = ex.prepare_stream(graphs[0], with_eigvec=True)
    b = ex.prepare_stream(graphs[0], with_eigvec=True)
    assert len(ex._eigvec_lru) == 1 and torch.equal(a.eigvec, b.eigvec)
    s, r, nf, _ = graphs[0]
    np.testing.assert_array_equal(
        a.eigvec.numpy(), JP.laplacian_eigvec(s, r, nf.shape[0], a.graph.num_nodes))
    assert a.signature[0] == ("eig", True) and a.signature == b.signature
    assert ex.prepare_stream(graphs[0]).signature[0] == ("eig", False)
    for g in graphs[1:]:
        ex.prepare_stream(g, with_eigvec=True)
    assert len(ex._eigvec_lru) == 2
    batched = ex.prepare_batched(graphs, 3, 256, 768, with_eigvec=True)
    n0 = nf.shape[0]
    np.testing.assert_array_equal(batched.eigvec[:n0].numpy(),
                                  JP.laplacian_eigvec(s, r, n0))


# --------------------------------------------------------- entry points


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs("gcn")
    _, tp = _params(_configs("gcn")[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(tcfg, tp)
    with pytest.raises(RuntimeError, match="CUDA"):
        Executor()
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.main(["--gnn", "gcn", "--n-graphs", "1"])
    assert TEngine(tcfg, tp, device="cpu").device == torch.device("cpu")


def test_launcher_serves_on_cpu(capsys):
    TS.main(["--gnn", "gin", "--fused", "--n-graphs", "2", "--device", "cpu"])
    TS.main(["--gnn", "gcn", "--batched", "--batch", "2", "--n-graphs", "2",
             "--device", "cpu"])
    TS.main(["--gnn", "dgn", "--fused", "--n-graphs", "2", "--device", "cpu"])
    TS.main(["--gnn", "dgn", "--batched", "--batch", "2", "--n-graphs", "2",
             "--device", "cpu"])
    out = capsys.readouterr().out
    assert "gin: 2 graphs, mean" in out and "p99" in out
    assert "gcn batched(bs=2): 2 graphs" in out
    assert "dgn: 2 graphs, mean" in out and "dgn batched(bs=2): 2 graphs" in out


@pytest.mark.parametrize("name", ["gin_vn", "gat", "pna", "dgn"])
def test_later_slice_models_raise(name):
    """The models the first slice refused now serve at paper width on the
    CPU; what still raises is DGN without its eigenvector input."""
    cfg = get_gnn_config(name)
    params = TM.init(torch.Generator().manual_seed(0), cfg)
    graphs = [g[:4] for g in JP.MoleculeStream(JP.MOLHIV, seed=5).take(2)]
    eng = TEngine(cfg, params, fused=True, device="cpu")
    outs, _, _ = eng.infer_stream(graphs, with_eigvec=name == "dgn")
    assert all(o.shape == (1, 1) and np.isfinite(o).all() for o in outs)
    if name == "dgn":
        with pytest.raises(ValueError, match="eigenvector"):
            eng.infer_stream(graphs)


def test_quantized_serving_waits_for_int8_slice():
    """Quantized serving now runs: the engine serves int8 as JAX's engine
    does (within the quantization-noise bound of
    ``tests/test_torch_quant.py``), and a tree holding ``QuantizedLinear``
    nodes, converted from JAX's, runs through ``apply`` on both paths."""
    from repro.quant import apply as JQA
    from repro_torch.quant import QuantizedLinear

    jcfg, tcfg = _configs("gin")
    jp, tp = _params(jcfg)
    graphs = [g[:4] for g in JP.MoleculeStream(JP.MOLHIV, seed=2).take(4)]
    fp32, _, _ = JEngine(jcfg, jp).infer_stream(graphs)
    want, _, _ = JEngine(jcfg, jp, precision="int8", fused=True).infer_stream(graphs)
    got, _, _ = TEngine(tcfg, tp, precision="int8", fused=True,
                        device="cpu").infer_stream(graphs)
    got, want, fp32 = (np.concatenate(a) for a in (got, want, fp32))
    assert np.abs(got - want).mean() <= 0.2 * np.abs(want - fp32).mean() + 1e-5
    jq, _ = JQA.quantize_model(jp, jcfg, (), JQA.precision_qconfig("int8"))
    tq = from_jax_params(jax.tree_util.tree_map(np.asarray, jq))
    assert isinstance(tq["encoder"], QuantizedLinear)
    assert tq["encoder"].w_q.dtype == torch.int8
    _, tg, _, _, _, _ = _inputs("single")
    fused = TM.apply(tq, tg, tcfg, num_graphs=1, fused=True)
    unfused = TM.apply(tq, tg, tcfg, num_graphs=1)
    assert fused.shape == unfused.shape == (1, 1)
    assert np.isfinite(fused.numpy()).all() and np.isfinite(unfused.numpy()).all()


def test_layer_helpers_match_jax():
    from repro.gnn import layers as JL
    from repro_torch.gnn import layers as TL

    rng = np.random.default_rng(12)
    x = rng.normal(size=(7, 5)).astype(np.float32)
    bn = {"scale": rng.normal(size=(5,)).astype(np.float32),
          "shift": rng.normal(size=(5,)).astype(np.float32)}
    want = np.asarray(JL.batch_norm_apply(bn, x))
    got = TL.batch_norm_apply(from_jax_params(bn), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ident = TL.batch_norm_init(5)
    assert torch.equal(TL.batch_norm_apply(ident, torch.from_numpy(x)),
                       torch.from_numpy(x))
    mlp = [{"w": w, "b": np.zeros(w.shape[1], np.float32)} for w in
           (rng.normal(size=(5, 8)).astype(np.float32),
            rng.normal(size=(8, 3)).astype(np.float32))]
    want = np.asarray(JL.mlp_apply(mlp, x, activation="gelu"))
    got = TL.mlp_apply(from_jax_params(mlp), torch.from_numpy(x),
                       activation="gelu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    w = TL.glorot(gen, (100, 200))
    assert w.shape == (100, 200) and abs(float(w.std()) - (2 / 300) ** 0.5) < 0.01


def test_port_init_shapes_match_jax():
    for model in MODELS:
        jcfg, _ = _configs(model)
        jcfg = JM.paper_config(jcfg.model, virtual_node=jcfg.virtual_node)
        tcfg = get_gnn_config(model)
        jshapes = [np.shape(x) for x in jax.tree_util.tree_leaves(
            JM.init(jax.random.PRNGKey(0), jcfg))]
        tp = TM.init(torch.Generator().manual_seed(0), tcfg)
        tshapes = [tuple(x.shape) for x in jax.tree_util.tree_leaves(tp)]
        assert tshapes == [tuple(s) for s in jshapes]
        if tcfg.virtual_node:  # the VN update starts as a no-op
            assert all(not m[-1]["w"].any() for m in tp["vn_mlp"])


def test_convert_carries_every_leaf():
    """``from_jax_params`` carries GAT's, PNA's and GIN+VN's leaves as they
    are, values and nesting."""
    for name, keys in (("gat", ("proj", "att_src", "att_dst")),
                       ("pna", ("pre", "post")), ("gin_vn", ("edge", "eps", "mlp"))):
        jp, tp = _params(_configs(name)[0], seed=4)
        assert set(tp) == set(jp) and all(k in tp["layers"][0] for k in keys)
        jl = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jp))
        tl = jax.tree_util.tree_leaves_with_path(tp)
        assert [p for p, _ in tl] == [p for p, _ in jl]
        for (_, a), (_, b) in zip(tl, jl):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), b)
    _, tp = _params(_configs("gin_vn")[0])
    assert tp["vn_embed"].shape == (16,) and len(tp["vn_mlp"]) == 2


# ---------------------------------------------------------------- guard


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_never_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad

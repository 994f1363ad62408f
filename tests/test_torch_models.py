"""GCN / GIN through the PyTorch port against the JAX package, end to end.

  * ``apply`` logits for GCN and GIN x {single, batched, packed} x
    {fused, unfused} match JAX ``apply`` (its default CPU mode, the
    reference path) at rtol 1e-4 — the same params, converted by
    ``repro_torch.convert.from_jax_params``, and the same numpy inputs;
  * the port's fused and unfused forwards agree within 1e-6;
  * ``GNNEngine.infer_stream`` / ``infer_packed`` match JAX's engine on
    the same 8 graphs at rtol 1e-4;
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
from repro.serve.gnn_engine import GNNEngine as JEngine
from repro_torch.configs.gengnn_models import get_gnn_config
from repro_torch.convert import from_jax_params
from repro_torch.core import batching as TB
from repro_torch.core import graph as TG
from repro_torch.gnn import models as TM
from repro_torch.launch import serve as TS
from repro_torch.serve.executor import Executor
from repro_torch.serve.gnn_engine import GNNEngine as TEngine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MODELS = ("gcn", "gin")
KINDS = ("single", "batched", "packed")
RTOL, ATOL = 1e-4, 1e-6


def _configs(model):
    small = dict(num_layers=3, hidden=16)
    return JM.paper_config(model, **small), TM.paper_config(model, **small)


def _params(jcfg, seed=0):
    jp = JM.init(jax.random.PRNGKey(seed), jcfg)
    # GIN's eps is 0 at init; make it matter
    for lp in jp["layers"]:
        if "eps" in lp:
            lp["eps"] = lp["eps"] + 0.25
    return jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp))


def _inputs(kind, seed=0):
    """-> (jax graph, torch graph, num_graphs, jax layout, torch layout)."""
    gs = [g[:4] for g in JP.MoleculeStream(JP.MOLHIV, seed=seed).take(5)]
    if kind == "single":
        s, r, nf, ef = gs[0]
        kw = dict(n_pad=64, e_pad=192)
        return JG.from_numpy(s, r, nf, ef, **kw), TG.from_numpy(s, r, nf, ef, **kw), \
            None, None, None
    if kind == "batched":
        return JG.batch_graphs(gs, 256, 768), TG.batch_graphs(gs, 256, 768), \
            len(gs), None, None
    jg, _ = JB.pack_graphs(gs, JB.BucketBudget(256, 768, 8))
    tg, _ = TB.pack_graphs(gs, TB.BucketBudget(256, 768, 8))
    return jg, tg, 8, JB.pack_layout(jg), TB.pack_layout(tg)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("model", MODELS)
def test_apply_matches_jax(model, kind, fused):
    jcfg, tcfg = _configs(model)
    jp, tp = _params(jcfg)
    jg, tg, m, jl, tl = _inputs(kind)
    want = np.asarray(JM.apply(jp, jg, jcfg, num_graphs=m, layout=jl, fused=fused))
    got = TM.apply(tp, tg, tcfg, num_graphs=m, layout=tl, fused=fused).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("model", MODELS)
def test_fused_matches_unfused(model, kind):
    _, tcfg = _configs(model)
    _, tp = _params(_configs(model)[0], seed=1)
    _, tg, m, _, tl = _inputs(kind, seed=1)
    a = TM.apply(tp, tg, tcfg, num_graphs=m, layout=tl, fused=True)
    b = TM.apply(tp, tg, tcfg, num_graphs=m, layout=tl, fused=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_plan_sharing_does_not_change_logits():
    _, tcfg = _configs("gin")
    _, tp = _params(_configs("gin")[0])
    _, tg, m, _, tl = _inputs("packed")
    shared = TM.apply(tp, tg, tcfg, num_graphs=m, layout=tl)
    built = TM.apply(tp, tg, tcfg, num_graphs=m)
    assert torch.equal(shared, built)
    program = TM.forward_program(tcfg, num_graphs=m, fused=True)
    assert torch.equal(program(tp, tg, tl),
                       TM.apply(tp, tg, tcfg, num_graphs=m, layout=tl, fused=True))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("model", MODELS)
def test_engine_matches_jax_engine(model, fused):
    jcfg, tcfg = _configs(model)
    jp, tp = _params(jcfg)
    graphs = [g[:4] for g in JP.MoleculeStream(JP.MOLHIV, seed=2).take(8)]
    jeng = JEngine(jcfg, jp, fused=fused)
    teng = TEngine(tcfg, tp, fused=fused, device="cpu")
    jouts, _, _ = jeng.infer_stream(graphs)
    touts, lats, _ = teng.infer_stream(graphs)
    assert len(touts) == 8 and (lats >= 0).all()
    np.testing.assert_allclose(np.concatenate(touts), np.concatenate(jouts),
                               rtol=RTOL, atol=ATOL)
    budget = (512, 1536, 8)
    jpk, jmeta = JB.pack_graphs(graphs, JB.BucketBudget(*budget))
    tpk, tmeta = TB.pack_graphs(graphs, TB.BucketBudget(*budget))
    jout, _ = jeng.infer_packed(jpk, JB.BucketBudget(*budget))
    tout, _ = teng.infer_packed(tpk, TB.BucketBudget(*budget))
    for a, b in zip(TB.unpack_outputs(tout, tmeta), JB.unpack_outputs(jout, jmeta)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    bout, per_graph = teng.infer_batched(graphs, batch_size=4, n_pad=256, e_pad=768)
    np.testing.assert_allclose(bout, np.concatenate(jouts), rtol=RTOL, atol=ATOL)
    assert per_graph >= 0


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
    ex.run(p, model="a")
    assert np.array_equal(out_a, out_b)
    # same architecture and params structure: one program, warmed once
    assert len(ex._programs) == 1 and ex.warm_seconds == warm > 0
    assert len(next(iter(ex._programs.values())).warm) == 1
    with pytest.raises(KeyError):
        ex.run(p)  # two tenants: the name is required
    with pytest.raises(ValueError):
        ex.register("a", tcfg, tp)
    with pytest.raises(ValueError):
        ex.bucket_for(10_000, 10)


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
    out = capsys.readouterr().out
    assert "gin: 2 graphs, mean" in out and "p99" in out
    assert "gcn batched(bs=2): 2 graphs" in out


@pytest.mark.parametrize("name", ["gin_vn", "gat", "pna", "dgn"])
def test_later_slice_models_raise(name):
    cfg = get_gnn_config(name)
    with pytest.raises(NotImplementedError, match="slice"):
        TM.init(torch.Generator().manual_seed(0), cfg)


def test_quantized_serving_waits_for_int8_slice():
    _, tcfg = _configs("gin")
    _, tp = _params(_configs("gin")[0])
    with pytest.raises(NotImplementedError):
        TEngine(tcfg, tp, precision="int8", device="cpu")
    # a linear that is not a plain {w, b} dict is a quantized one
    tp["encoder"] = {"w_q": tp["encoder"]["w"], "b": tp["encoder"]["b"]}
    _, tg, m, _, _ = _inputs("single")
    with pytest.raises(NotImplementedError, match="int8"):
        TM.apply(tp, tg, tcfg, num_graphs=m)


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
        jcfg = JM.paper_config(model)
        tcfg = get_gnn_config(model)
        jshapes = [np.shape(x) for x in jax.tree_util.tree_leaves(
            JM.init(jax.random.PRNGKey(0), jcfg))]
        tp = TM.init(torch.Generator().manual_seed(0), tcfg)
        tshapes = [tuple(x.shape) for x in jax.tree_util.tree_leaves(tp)]
        assert tshapes == [tuple(s) for s in jshapes]


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

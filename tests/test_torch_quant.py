"""Quantized serving in the PyTorch port against the JAX package, on the CPU.

Same numpy inputs through ``repro`` and ``repro_torch``:

  * transform: ``quantize_weight`` (per channel, per tensor, fixed),
    ``quantize_int8`` (ties round half to even, zero-points, saturation),
    ``affine_act_params``, ``symmetric_scale``, ``fixed_round``,
    ``dequantize_int8`` and the static-int8 fold (``w_q``, ``w_scale``,
    ``b_eff``, ``x_premul``, ``x_scale``, ``x_zero``, SmoothQuant on and
    off) are bitwise equal, given the same observer data;
  * observers match JAX's exactly on the same data; calibration of the
    same parameters on the same graphs collects the same ranges (within
    1e-4 of each layer's range, PNA 5e-3: the fp32 forwards' tolerance of
    ``tests/test_torch_models.py``); ``QuantReport`` and
    ``precision_qconfig`` match;
  * ``quant_node_mlp_ref`` is bitwise JAX's ``quant_node_mlp_ref`` (gelu:
    rtol 1e-6, two tanh implementations) and within rtol 1e-6, atol 1e-6
    of JAX's Pallas kernel (interpret mode; the tolerance of JAX's own
    kernel test); the accumulation is the exact int64 product;
  * the int8-dynamic linear in one call (``kops.quant_node_mlp_dynamic``,
    the port's ``quantized_linear``) is bitwise JAX's ``quantized_linear``
    (gelu: rtol 1e-6), all-zero and tie rows included; the shared row
    helper ``kernels.ref.quantize_rows`` leaves the fused int8 gamma
    bitwise as it was;
  * ``fused_mp_ref`` int8 (gin, pna, dgn) on inputs whose aggregates are
    exact in fp32 (``exact_operands``): the gamma towers and their int8
    quantization ``q`` are bitwise JAX's, the output within 2e-5 (JAX's
    ``INT8_TOL``); a GIN probe shows ``q * rs`` bitwise;
  * logits of the six models x {single, packed} x {fused, unfused} in
    int8, and GIN in int8-static and fixed, from the same quantized tree
    (``from_jax_params``) against JAX ``apply`` in reference mode:
    ``MAE(port - jax) <= 0.2 * MAE(jax int8 - jax fp32) + 1e-5``, the
    quantization-noise bound; the encoder's int8 operands and int32
    accumulators are bitwise;
  * ``Executor.register`` / ``GNNEngine`` for every precision quantize
    the tree as JAX does and serve within the same bound; a second pass
    adds no program and warms nothing new.

The CUDA kernels are held against these plain versions in
``tests/test_torch_on_card.py`` (it skips without a card) and by
``python3 chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import message_passing as JMP
from repro.data import pipeline as JP
from repro.gnn import models as JM
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.quant import apply as JQA
from repro.quant import observers as JO
from repro.quant import qconfig as JQ
from repro.serve.gnn_engine import GNNEngine as JEngine
from repro_torch.convert import from_jax_params
from repro_torch.core.ieee import div_rn
from repro_torch.core import message_passing as TMP
from repro_torch.gnn import models as TM
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as TREF
from repro_torch.quant import apply as TQA
from repro_torch.quant import observers as TO
from repro_torch.quant import qconfig as TQ
from repro_torch.serve.executor import Executor
from repro_torch.serve.gnn_engine import GNNEngine as TEngine
from test_torch_models import MODELS, _configs, _eig_for, _inputs, _params, _tol
from test_torch_on_card import (PLAN_ARGS, exact_operands, exact_plan_arrays,
                                gin_probe_weights, to_t)

torch.set_num_threads(1)

INT8_TOL = 2e-5
PLAN_NAMES = ("ids_sorted", "src_sorted", "in_degree", "node_mask")


def _bitwise(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _calib_graphs(n=3, seed=11):
    return [g[:4] for g in JP.MoleculeStream(JP.MOLHIV, seed=seed).take(n)]


def _noise_bound(got, want, jax_fp32):
    """The served-model bound: the port's distance from JAX's int8 logits
    is a fifth of JAX's own int8-vs-fp32 distance (MAE), plus 1e-5."""
    got, want, ref32 = (np.asarray(a, np.float64) for a in (got, want, jax_fp32))
    mae = np.abs(got - want).mean()
    noise = np.abs(want - ref32).mean()
    assert np.isfinite(got).all() and got.shape == want.shape
    assert mae <= 0.2 * noise + 1e-5, (mae, noise)
    return mae, noise


# ------------------------------------------------------------- transform


@pytest.mark.parametrize("granularity", ["per_channel", "per_tensor", "fixed"])
def test_quantize_weight_matches_jax(granularity):
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(37, 21)) * 0.3).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel takes the _EPS floor
    kw = (dict(scheme="fixed", word_bits=8, int_bits=2) if granularity == "fixed"
          else dict(granularity=granularity))
    jq, js = JQ.quantize_weight(jnp.asarray(w), JQ.QConfig(**kw))
    tq, ts = TQ.quantize_weight(torch.from_numpy(w), TQ.QConfig(**kw))
    _bitwise(tq, jq, "w_q")
    _bitwise(ts, js, "w_scale")
    _bitwise(TQ.dequantize_int8(tq, ts), JQ.dequantize_int8(jq, js), "dequant")


def test_quantize_int8_and_fixed_round_match_jax():
    rng = np.random.default_rng(2)
    scale = np.float32(0.05)
    # exact ties (k + 1/2) * scale, saturating values, and random ones
    ties = ((np.arange(-8, 8) + 0.5) * scale).astype(np.float32)
    x = np.concatenate([ties, np.float32([9.0, -9.0, 1e-9, -0.0]),
                        rng.normal(size=200).astype(np.float32)]).reshape(-1, 4)
    for zero in (0.0, -37.0, 12.0):
        for s in (scale, rng.uniform(0.01, 0.1, size=(1, 4)).astype(np.float32)):
            _bitwise(TQ.quantize_int8(torch.from_numpy(x), torch.as_tensor(s), zero),
                     JQ.quantize_int8(jnp.asarray(x), jnp.asarray(s), zero),
                     f"quantize_int8 zero={zero}")
    for wb, ib in ((16, 6), (8, 3), (12, 1)):
        y = (x * 40).astype(np.float32)
        _bitwise(TQ.fixed_round(torch.from_numpy(y), wb, ib),
                 JQ.fixed_round(jnp.asarray(y), wb, ib), f"fixed<{wb},{ib}>")


@pytest.mark.parametrize("lo, hi", [(-1.5, 2.0), (0.0, 3.7), (-0.2, 5.0),
                                    (-4.0, 0.5), (-1e-12, 1e-12), (0.3, 0.9)])
def test_affine_act_params_match_jax(lo, hi):
    for asym in (True, False):
        assert TQ.affine_act_params(lo, hi, asym) == JQ.affine_act_params(lo, hi, asym)
    _bitwise(TQ.symmetric_scale(lo, hi), JQ.symmetric_scale(lo, hi))


def _observer_pair(kind, data):
    j, t = JO.make_observer(kind), TO.make_observer(kind)
    for x in data:
        j.update(x)
        t.update(x)
    return j, t


@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("asymmetric", [False, True])
def test_static_int8_fold_matches_jax(skewed, asymmetric):
    """The static transform (SmoothQuant migration, zero-point, bias fold)
    gives bitwise JAX's fields from the same observer data."""
    rng = np.random.default_rng(3)
    k, n = 24, 10
    data = [np.abs(rng.normal(size=(30, k))).astype(np.float32) for _ in range(3)]
    if skewed:
        for x in data:
            x[:, 5] *= 40.0  # one hot column: max/median >= 8
    if not asymmetric:
        data = [x - 1.0 for x in data]
    w = rng.normal(size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    jobs, tobs = _observer_pair("minmax", data)
    qcfg = dict(act_mode="static", asymmetric_acts=asymmetric)
    jq = JQA._quantize_int8_linear(jnp.asarray(w), jnp.asarray(b), jobs,
                                   JQ.QConfig(**qcfg))
    tq = TQA._quantize_int8_linear(torch.from_numpy(w), torch.from_numpy(b),
                                   tobs, TQ.QConfig(**qcfg))
    for field in ("w_q", "w_scale", "b", "x_scale", "x_premul", "x_zero"):
        _bitwise(getattr(tq, field), getattr(jq, field), field)
    assert (tq.x_premul.ndim == 1) == skewed
    jd = JQA._quantize_dynamic_linear(jnp.asarray(w), jnp.asarray(b), JQ.QConfig())
    td = TQA._quantize_dynamic_linear(torch.from_numpy(w), torch.from_numpy(b),
                                      TQ.QConfig())
    for field in ("w_q", "w_scale", "b", "x_scale"):
        _bitwise(getattr(td, field), getattr(jd, field), field)


# ------------------------------------------------------------- observers


@pytest.mark.parametrize("kind", ["minmax", "percentile"])
def test_observers_match_jax(kind):
    rng = np.random.default_rng(4)
    data = [rng.normal(size=(int(rng.integers(1, 300)), 6)).astype(np.float32) * 3
            for _ in range(6)] + [np.zeros((0, 6), np.float32)]
    if kind == "percentile":  # the reservoir's re-subsampling path
        data.append(rng.normal(size=(70_000, 6)).astype(np.float32))
    j, t = _observer_pair(kind, data)
    assert t.range() == j.range() and t.count == j.count
    for a, b in zip(t.col_range(), j.col_range()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        TO.make_observer("histogram")


def test_collector_hook_keys_by_weight_identity():
    from repro_torch.gnn import layers as TL

    p1 = {"w": torch.ones(4, 2), "b": torch.zeros(2)}
    p2 = {"w": torch.ones(4, 2), "b": torch.zeros(2)}
    coll = TO.Collector(TO.MinMaxObserver)
    with TO.collecting(coll):
        TL.linear_apply(p1, torch.ones(3, 4))
        TL.linear_apply(p2, 2.0 * torch.ones(5, 4))
        TL.linear_apply(p1, -torch.ones(3, 4))
    assert set(coll.observers) == {id(p1["w"]), id(p2["w"])}
    assert coll.observers[id(p1["w"])].range() == (-1.0, 1.0)
    assert coll.observers[id(p2["w"])].range() == (2.0, 2.0)
    TL.linear_apply(p1, 5.0 * torch.ones(3, 4))  # inert outside the context
    assert coll.observers[id(p1["w"])].range() == (-1.0, 1.0)


@pytest.mark.parametrize("model", MODELS)
def test_calibration_matches_jax(model):
    """Each model's calibration forward reports the same linears, in the
    same order, with the same ranges as JAX's."""
    jcfg, tcfg = _configs(model)
    jp, tp = _params(jcfg)
    graphs = _calib_graphs()
    jc = JQA.calibrate(jp, jcfg, graphs)
    tc = TQA.calibrate(tp, tcfg, graphs)
    jobs, tobs = list(jc.observers.values()), list(tc.observers.values())
    assert len(tobs) == len(jobs) > 0
    for t, j in zip(tobs, jobs):
        assert t.count == j.count
        # relative to the layer's range, which sets its int8 step
        atol = _tol(tcfg.model)["rtol"] * max(abs(v) for v in j.range())
        np.testing.assert_allclose(t.range(), j.range(), rtol=0, atol=atol)
        for a, b in zip(t.col_range(), j.col_range()):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("precision", ["int8", "int8-static", "fixed"])
def test_quant_report_matches_jax(precision):
    jcfg = JM.paper_config("gin")
    jp = JM.init(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    tcfg = TM.paper_config("gin")
    graphs = _calib_graphs()
    jq, jr = JQA.quantize_model(jp, jcfg, graphs, JQA.precision_qconfig(precision))
    tq, tr = TQA.quantize_model(tp, tcfg, graphs, TQA.precision_qconfig(precision))
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert (tr.quantized, tr.kept_fp32, tr.skipped_paths) == (16, 1, ("head/0",))
    assert isinstance(tq["encoder"], TQ.QuantizedLinear)
    assert isinstance(tq["head"][0], dict) and isinstance(tp["encoder"], dict)
    # int8 and fixed need no calibration: the whole tree is JAX's, bitwise
    if precision != "int8-static":
        conv = from_jax_params(jax.tree_util.tree_map(np.asarray, jq))
        for path, a, b in _quant_pairs(tq, conv):
            _bitwise(a, b.numpy(), path)


def _quant_pairs(a, b, path=""):
    """(path, tensor of a, tensor of b) over two trees of one structure."""
    if isinstance(a, TQ.QuantizedLinear):
        assert (a.scheme, a.act_mode) == (b.scheme, b.act_mode)
        for f in ("w_q", "w_scale", "b", "x_scale"):
            yield f"{path}/{f}", getattr(a, f), getattr(b, f)
    elif isinstance(a, dict):
        for k in a:
            yield from _quant_pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _quant_pairs(x, y, f"{path}/{i}")
    else:
        yield path, a, b


def test_precision_qconfig_matches_jax():
    for name in ("int8", "int8-static", "fixed"):
        assert (dataclasses.asdict(TQA.precision_qconfig(name))
                == dataclasses.asdict(JQA.precision_qconfig(name)))
    for mod in (TQA, JQA):
        with pytest.raises(ValueError):
            mod.precision_qconfig("int4")
    with pytest.raises(ValueError):
        TQ.QConfig(scheme="int4")
    with pytest.raises(ValueError):
        TQ.QConfig(word_bits=8, int_bits=8)


# ---------------------------------------------------- kernel plain versions


def _qmlp_inputs(rng, m, k, n, row_scale):
    x_q = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    w_q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    scale = rng.uniform(1e-3, 1e-2, size=(n,)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    rs = (rng.uniform(1e-3, 1e-1, size=(m, 1)).astype(np.float32)
          if row_scale else None)
    return x_q, w_q, scale, b, rs


@pytest.mark.parametrize("row_scale", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu", "none"])
@pytest.mark.parametrize("shape", [(37, 9, 100), (64, 100, 200), (5, 1100, 3)])
def test_quant_node_mlp_ref_matches_jax(shape, activation, row_scale):
    """Bitwise JAX's plain version (K = 1100 takes the chunked int64
    accumulation past the exact-f32 bound); gelu within rtol 1e-6."""
    rng = np.random.default_rng(sum(shape))
    x_q, w_q, scale, b, rs = _qmlp_inputs(rng, *shape, row_scale)
    jrs = None if rs is None else jnp.asarray(rs)
    want = JREF.quant_node_mlp_ref(jnp.asarray(x_q), jnp.asarray(w_q),
                                   jnp.asarray(scale), jnp.asarray(b),
                                   activation, row_scale=jrs)
    trs = None if rs is None else to_t(rs)
    got = kops.quant_node_mlp(to_t(x_q), to_t(w_q), to_t(scale), to_t(b),
                              activation, row_scale=trs)
    if activation == "gelu":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        _bitwise(got, want)


@pytest.mark.parametrize("activation", ["relu", "gelu", "none"])
def test_quant_node_mlp_ref_matches_jax_pallas_kernel(activation):
    """Against the TPU kernel itself, run by Pallas in interpret mode."""
    rng = np.random.default_rng(7)
    for m, k, n, row_scale in ((37, 130, 50, True), (64, 9, 100, False)):
        x_q, w_q, scale, b, rs = _qmlp_inputs(rng, m, k, n, row_scale)
        want = JOPS.quant_node_mlp(
            jnp.asarray(x_q), jnp.asarray(w_q), jnp.asarray(scale),
            jnp.asarray(b), activation,
            row_scale=None if rs is None else jnp.asarray(rs), mode="kernel")
        got = TREF.quant_node_mlp_ref(to_t(x_q), to_t(w_q), to_t(scale), to_t(b),
                                      activation,
                                      row_scale=None if rs is None else to_t(rs))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_quant_node_mlp_ref_accumulates_exactly():
    """scale 1, bias 0, no activation: the output is the exact integer
    product (computed in int64), also past the f32-exact depth."""
    rng = np.random.default_rng(8)
    for k in (96, 1024, 2100):
        x_q = rng.integers(-128, 128, size=(40, k)).astype(np.int8)
        w_q = np.full((k, 6), -128, np.int8)
        w_q[:, 3:] = rng.integers(-127, 128, size=(k, 3))
        got = kops.quant_node_mlp(to_t(x_q), to_t(w_q), torch.tensor(1.0),
                                  torch.zeros(6), "none")
        exact = x_q.astype(np.int64) @ w_q.astype(np.int64)
        assert np.abs(exact).max() < 2 ** 24 or k > 1032
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      exact.astype(np.float32).astype(np.int64))


def _dynamic_rows(rng, m, k):
    """fp32 rows for the int8-dynamic recipe: normal values at per-row
    ranges 1e-3 .. 1e2; row 0 all zero (the 1e-8 floor); and, from row 1
    every third row, ties: (j + 1/2) 2^-e with one +-127 2^-e, so that
    rs = 2^-e exactly and x / rs = j + 1/2 (round half to even)."""
    x = (rng.normal(size=(m, k)) * 10.0 ** rng.uniform(-3, 2, size=(m, 1))).astype(np.float32)
    x[0] = 0.0
    for r in range(1, m, 3):
        e = int(rng.integers(-3, 20))
        x[r] = (rng.integers(-127, 127, size=k) + 0.5) * 2.0 ** -e
        x[r, rng.integers(0, k)] = (-1) ** r * 127 * 2.0 ** -e
    return x


@pytest.mark.parametrize("granularity", ["per_channel", "per_tensor"])
@pytest.mark.parametrize("activation", ["relu", "gelu", "none"])
@pytest.mark.parametrize("shape", [(37, 9, 100), (64, 100, 200), (5, 960, 80), (1, 3, 100)])
def test_quant_node_mlp_dynamic_matches_jax_quantized_linear(shape, activation, granularity):
    """``kops.quant_node_mlp_dynamic`` (plain, CPU) and the port's
    ``quantized_linear`` on a dynamic ``QuantizedLinear`` are bitwise JAX's
    ``quantized_linear`` (gelu within rtol 1e-6, two tanh implementations),
    all-zero rows and ties included."""
    m, k, n = shape
    rng = np.random.default_rng(m * k + n)
    x = _dynamic_rows(rng, m, k)
    w = (rng.normal(size=(k, n)) * 0.2).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    qcfg = dict(granularity=granularity)
    jq = JQA._quantize_dynamic_linear(jnp.asarray(w), jnp.asarray(b), JQ.QConfig(**qcfg))
    tq = TQA._quantize_dynamic_linear(torch.from_numpy(w), torch.from_numpy(b),
                                      TQ.QConfig(**qcfg))
    want = np.asarray(JQ.quantized_linear(jq, jnp.asarray(x), activation))
    got = kops.quant_node_mlp_dynamic(to_t(x), tq.w_q, tq.w_scale, tq.b, activation)
    via_qconfig = TQ.quantized_linear(tq, to_t(x), activation)
    assert torch.equal(got, via_qconfig)
    if activation == "gelu":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        _bitwise(got, want)
    # the row recipe itself: q and rs bitwise JAX's
    q, rs = TREF.quantize_rows(to_t(x))
    jrs = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x)), axis=1, keepdims=True), JQ._EPS) / 127.0
    _bitwise(rs, jrs, "rs")
    _bitwise(q.to(torch.int8), JQ.quantize_int8(jnp.asarray(x), jrs), "x_q")


@pytest.mark.parametrize("k", [9, 100])
def test_quantize_rows_gives_fused_gamma_unchanged(k):
    """The shared row helper leaves ``fused_mp_ref``'s int8 gamma as it was:
    bitwise the former inline recipe (its tail order ``acc * (rs * w_scale)
    + b``) and bitwise JAX's ``_fused_gamma_linear``, on random, all-zero
    and tie rows."""
    rng = np.random.default_rng(k)
    x = _dynamic_rows(rng, 40, k)
    w1 = rng.integers(-127, 128, size=(k, 24)).astype(np.int8)
    s1 = rng.uniform(1e-3, 1e-2, size=(24,)).astype(np.float32)
    b1 = rng.normal(size=(24,)).astype(np.float32)
    xt = to_t(x)
    got = TREF._fused_gamma_linear(xt, to_t(w1), to_t(b1), to_t(s1), "int8")
    rs = div_rn(torch.clamp(torch.abs(xt).amax(dim=-1, keepdim=True), min=TREF._ROW_EPS),
                127.0)
    q = torch.clamp(torch.round(xt / rs), -128.0, 127.0)
    former = torch.clamp(TREF._int8_accumulate(q, to_t(w1)) * (rs * to_t(s1)) + to_t(b1),
                         min=0.0)
    assert torch.equal(got, former)
    _bitwise(got, JREF._fused_gamma_linear(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1),
                                           jnp.asarray(s1), "int8"))


def _capture_towers(monkeypatch, module, store):
    original = module._fused_gamma_linear

    def spy(x, *args):
        store.append(x)
        return original(x, *args)

    monkeypatch.setattr(module, "_fused_gamma_linear", spy)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("gamma", ["gin", "pna", "dgn"])
def test_fused_mp_ref_int8_matches_jax(monkeypatch, gamma, seed):
    rng = np.random.default_rng(seed)
    plan = exact_plan_arrays(rng)
    n, e = plan["in_degree"].shape[0], plan["ids_sorted"].shape[0]
    (phi, ops, _), kw = exact_operands(rng, gamma, n, e)
    jt, tt = [], []
    _capture_towers(monkeypatch, JREF, jt)
    _capture_towers(monkeypatch, TREF, tt)
    want = JREF.fused_mp_ref(JMP.MPSpec(phi, ops, gamma, "int8"),
                             *(jnp.asarray(plan[k]) for k in PLAN_NAMES),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    got = kops.fused_mp(TMP.MPSpec(phi, ops, gamma, "int8"),
                        *(to_t(plan[k]) for k in PLAN_ARGS),
                        **{k: to_t(v) for k, v in kw.items()})
    # the gamma tower and its per-row int8 quantization are JAX's, bitwise
    _bitwise(tt[0], jt[0], "tower")
    jrs = jnp.maximum(jnp.max(jnp.abs(jt[0]), axis=-1, keepdims=True),
                      JREF._ROW_EPS) / 127.0
    trs = torch.clamp(tt[0].abs().amax(-1, keepdim=True), min=TREF._ROW_EPS) / 127.0
    _bitwise(torch.clamp(torch.round(tt[0] / trs), -128, 127),
             jnp.clip(jnp.round(jt[0] / jrs), -128, 127), "q")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=INT8_TOL)
    assert (got.numpy()[~plan["node_mask"]] == 0).all()


def test_fused_mp_ref_int8_gin_probe_shows_q_bitwise():
    rng = np.random.default_rng(9)
    plan = exact_plan_arrays(rng)
    n, e = plan["in_degree"].shape[0], plan["ids_sorted"].shape[0]
    (phi, ops, gamma), kw = exact_operands(rng, "gin", n, e)
    kw.update(gin_probe_weights())
    want = JREF.fused_mp_ref(JMP.MPSpec(phi, ops, gamma, "int8"),
                             *(jnp.asarray(plan[k]) for k in PLAN_NAMES),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    got = kops.fused_mp(TMP.MPSpec(phi, ops, gamma, "int8"),
                        *(to_t(plan[k]) for k in PLAN_ARGS),
                        **{k: to_t(v) for k, v in kw.items()})
    _bitwise(got, want, "q * rs")
    assert np.abs(want).max() > 0


def test_row_eps_is_qconfig_eps():
    assert TREF._ROW_EPS == TQ._EPS == JQ._EPS


# ----------------------------------------------------------------- logits


def _quantized_pair(model, precision, seed=0):
    jcfg, tcfg = _configs(model)
    jp, _ = _params(jcfg, seed)
    jq, _ = JQA.quantize_model(jp, jcfg, _calib_graphs(),
                               JQA.precision_qconfig(precision))
    return jcfg, tcfg, jp, jq, from_jax_params(jax.tree_util.tree_map(np.asarray, jq))


def _logit_case(model, kind, fused, precision):
    jcfg, tcfg, jp, jq, tq = _quantized_pair(model, precision)
    jg, tg, m, jl, tl, eig = _inputs(kind)
    je, te = _eig_for(tcfg.model, eig)
    fp32 = np.asarray(JM.apply(jp, jg, jcfg, eigvec=je, num_graphs=m, layout=jl))
    want = np.asarray(JM.apply(jq, jg, jcfg, eigvec=je, num_graphs=m, layout=jl,
                               fused=fused))
    got = TM.apply(tq, tg, tcfg, eigvec=te, num_graphs=m, layout=tl,
                   fused=fused).numpy()
    _noise_bound(got, want, fp32)
    return jq, tq, jg, tg


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["single", "packed"])
@pytest.mark.parametrize("model", MODELS)
def test_int8_apply_matches_jax(model, kind, fused):
    jq, tq, jg, tg = _logit_case(model, kind, fused, "int8")
    # the encoder's int8 operands and int32 accumulators are bitwise JAX's
    jx, tx = jg.node_feat, tg.node_feat
    jrs = jnp.maximum(jnp.max(jnp.abs(jx), axis=1, keepdims=True), JQ._EPS) / 127.0
    trs = torch.clamp(tx.abs().amax(1, keepdim=True), min=TQ._EPS) / 127.0
    jxq, txq = JQ.quantize_int8(jx, jrs), TQ.quantize_int8(tx, trs)
    _bitwise(txq, jxq, "encoder x_q")
    _bitwise(TREF._int8_accumulate(txq, tq["encoder"].w_q),
             JREF._int8_accumulate(jxq, jq["encoder"].w_q), "encoder acc")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["single", "packed"])
@pytest.mark.parametrize("precision", ["int8-static", "fixed"])
def test_unfusable_precisions_match_jax(precision, kind, fused):
    _logit_case("gin", kind, fused, precision)


@pytest.mark.parametrize("precision", ["int8-static", "fixed"])
def test_unfusable_precisions_fall_back_bitwise(precision):
    """int8-static and fixed linears do not lower into fused_mp: fused=True
    runs the unfused computation, bit for bit."""
    _, tcfg, _, _, tq = _quantized_pair("gin", precision)
    _, tg, m, _, tl, _ = _inputs("packed")
    a = TM.apply(tq, tg, tcfg, num_graphs=m, layout=tl, fused=True)
    b = TM.apply(tq, tg, tcfg, num_graphs=m, layout=tl, fused=False)
    assert torch.equal(a, b)


# --------------------------------------------------------------- executor


@pytest.mark.parametrize("precision", ["fp32", "int8", "int8-static", "fixed"])
def test_executor_register_matches_jax(precision):
    jcfg, tcfg = _configs("gin")
    jp, tp = _params(jcfg)
    calib = _calib_graphs() if precision == "int8-static" else None
    graphs = [g[:4] for g in JP.MoleculeStream(JP.MOLHIV, seed=2).take(6)]
    fp32, _, _ = JEngine(jcfg, jp).infer_stream(graphs)
    jeng = JEngine(jcfg, jp, precision=precision, calib_graphs=calib, fused=True)
    want, _, _ = jeng.infer_stream(graphs)
    ex = Executor(device="cpu")
    tenant = ex.register("gin", tcfg, tp, precision=precision,
                         calib_graphs=calib, fused=True)
    # JAX's key: (cfg, precision, share_layout, fused)
    assert tenant.program_key == (tcfg, precision, True, True)
    assert isinstance(tp["encoder"], dict)  # the caller's tree is untouched
    if precision == "fp32":
        assert tenant.quant_report is None
    else:
        assert (dataclasses.asdict(tenant.quant_report)
                == dataclasses.asdict(jeng.quant_report))
        assert tenant.params["encoder"].w_q.dtype == (
            torch.float32 if precision == "fixed" else torch.int8)
    got = [ex.run(ex.prepare_stream(g))[0][:1] for g in graphs]
    _noise_bound(np.concatenate(got), np.concatenate(want), np.concatenate(fp32))
    programs = len(ex._compiled)
    warm = {k: set(p.warm) for k, p in ex._compiled.items()}
    again = [ex.run(ex.prepare_stream(g))[0][:1] for g in graphs]
    assert len(ex._compiled) == programs
    assert {k: p.warm for k, p in ex._compiled.items()} == warm
    np.testing.assert_array_equal(np.concatenate(again), np.concatenate(got))


def test_static_int8_needs_calibration_graphs():
    _, tcfg = _configs("gin")
    _, tp = _params(_configs("gin")[0])
    with pytest.raises(ValueError, match="calib_graphs"):
        TEngine(tcfg, tp, precision="int8-static", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        TEngine(tcfg, tp, precision="int4", device="cpu")
    eng = TEngine(tcfg, tp, precision="int8", device="cpu")
    assert eng.precision == "int8" and eng.quant_report.scheme == "int8"


@pytest.mark.parametrize("precision", ["int8", "int8-static", "fixed"])
def test_launcher_precision_on_cpu(capsys, precision):
    from repro_torch.launch import serve as TS

    TS.main(["--gnn", "gin", "--fused", "--precision", precision,
             "--n-graphs", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[quant] {precision}: 16 linears quantized, 1 fp32" in out
    assert "gin: 2 graphs, mean" in out

"""GNN gradients of the PyTorch port against ``jax.value_and_grad``, on the
CPU.

For each of the six models (GCN, GIN, GIN+VN, GAT, PNA, DGN at 2 layers,
hidden 16, GAT 2 heads x 8), fused and unfused, one batch of 4 MolHIV
graphs: the BCE-with-logits loss of ``examples/train_gin_molhiv.py:43-44``
on the same params (JAX's, converted by ``convert.from_jax_params``) and
the same numpy inputs, and its gradient leaf by leaf (JAX's order: sorted
dict keys) against JAX's, fp32, at rtol 1e-4 / atol 1e-6 (PNA 5e-3 /
5e-5: its std amplifies one rounding of sqsum / c - mean^2, as in
``tests/test_torch_models.py``).  JAX runs its default CPU mode, the jnp
reference path (its interpret-mode Pallas kernels do not trace in JAX
0.9.0).  The port runs mode ``auto`` (the plain versions here) and the
kernel branch of ``kernels/ops.py`` forced with stand-in kernels
(``tests/torch_kernel_standins.py``): the autograd Function's gradients.

``jnp.sqrt`` has an infinite derivative at 0, so JAX's PNA gradient is NaN
wherever a node's std is over equal values (degree 0 or 1); the port's
``core.ieee.sqrt_rn`` passes 0 there.  The JAX side of these tests takes
the same rule (a ``custom_jvp`` square root in place of ``jnp.sqrt`` in
``repro.core.scatter_gather`` and ``repro.kernels.ref``, nothing edited):
everywhere the variance is positive both rules are ``0.5 / sqrt``.  One
case shows JAX's own gradient non-finite for PNA; two more hold PNA's
gradient against JAX as it is, with no rule, on every leaf where JAX's is
finite (the readout head and the last layer's gamma).

Then three AdamW steps of the training example's ``step_fn`` (GIN at 2
layers, hidden 16, batches of 4 graphs from ``MoleculeStream(MOLHIV,
seed=0)``) against JAX's example step on the same params: the losses at
rtol 1e-5, the parameters after the steps at rtol 1e-4 / atol 1e-6.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.scatter_gather as JSG
import repro.kernels.ref as JREF
from repro.core import graph as JG
from repro.data import pipeline as JP
from repro.gnn import models as JM
from repro.optim import adamw as JA
from repro_torch.configs.gengnn_models import get_gnn_config
from repro_torch.convert import from_jax_params
from repro_torch.core import graph as TG
from repro_torch.gnn import models as TM
from repro_torch.optim import adamw as TA
from torch_kernel_standins import forced_kernels

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MODELS = ("gcn", "gin", "gin_vn", "gat", "pna", "dgn")
SMALL = dict(num_layers=2, hidden=16, heads=2, head_features=8)
N_PAD, E_PAD, B = 256, 768, 4


def _tol(model):
    return dict(rtol=5e-3, atol=5e-5) if model == "pna" else dict(rtol=1e-4, atol=1e-6)


@jax.custom_jvp
def _sqrt_zero_grad(x):
    return jnp.sqrt(x)


@_sqrt_zero_grad.defjvp
def _sqrt_zero_grad_jvp(primals, tangents):
    (x,), (t,) = primals, tangents
    r = jnp.sqrt(x)
    return r, jnp.where(r > 0, t * (0.5 / jnp.where(r > 0, r, 1.0)), 0.0)


class _JnpSqrtZeroGrad:
    """``jax.numpy`` with ``sqrt`` passing 0 back at a root of 0."""

    sqrt = staticmethod(_sqrt_zero_grad)

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def jax_sqrt_rule(monkeypatch):
    for mod in (JSG, JREF):
        monkeypatch.setattr(mod, "jnp", _JnpSqrtZeroGrad())


def _configs(name):
    jcfg = (JM.paper_config("gin", virtual_node=True, **SMALL) if name == "gin_vn"
            else JM.paper_config(name, **SMALL))
    return jcfg, get_gnn_config(name, **SMALL)


def _params(jcfg, seed=0):
    """JAX's init, with GIN's eps and the virtual node's zero-initialised
    parts made non-zero (so their gradients matter), and the port's copy."""
    jp = jax.tree_util.tree_map(np.asarray, JM.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for lp in jp["layers"]:
        if "eps" in lp:
            lp["eps"] = lp["eps"] + np.float32(0.25)
    if jcfg.virtual_node:
        jp["vn_embed"] = rng.normal(size=jp["vn_embed"].shape).astype(np.float32)
        for m in jp["vn_mlp"]:
            m[-1]["w"] = (0.2 * rng.normal(size=m[-1]["w"].shape)).astype(np.float32)
    return jp, from_jax_params(jp)


def _batch(first=0):
    raw = JP.MoleculeStream(JP.MOLHIV, seed=0).take(first + B)[first:]
    gs = [g[:4] for g in raw]
    y = np.asarray([g[4] for g in raw], np.float32)
    eig = np.zeros((N_PAD,), np.float32)
    eig[:sum(g[2].shape[0] for g in gs)] = np.concatenate(
        [JP.laplacian_eigvec(g[0], g[1], g[2].shape[0]) for g in gs])
    return (JG.batch_graphs(gs, N_PAD, E_PAD), TG.batch_graphs(gs, N_PAD, E_PAD), y, eig)


def _bce_jax(logits, y):
    return jnp.mean(jnp.maximum(logits, 0) - logits * y + jnp.log1p(jnp.exp(-jnp.abs(logits))))


def _bce_torch(logits, y):
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def _jax_grads(model, fused, jp, jg, y, eig):
    jcfg = _configs(model)[0]
    e = jnp.asarray(eig) if model == "dgn" else None

    def loss(p):
        return _bce_jax(JM.apply(p, jg, jcfg, eigvec=e, num_graphs=B, fused=fused)[:B, 0], y)

    val, grads = jax.value_and_grad(loss)(jp)
    return float(val), [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


def _port_grads(model, fused, tp, tg, y, eig):
    tcfg = _configs(model)[1]
    flat = TA.leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    try:
        e = torch.from_numpy(eig) if model == "dgn" else None
        out = TM.apply(tp, tg, tcfg, eigvec=e, num_graphs=B, fused=fused)[:B, 0]
        loss = _bce_torch(out, torch.from_numpy(y))
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    finally:
        for p in flat:
            p.requires_grad_(False)
    return float(loss.detach()), [g.numpy() for g in grads]


def _check(model, fused, got, want):
    (lg, gg), (lw, gw) = got, want
    np.testing.assert_allclose(lg, lw, rtol=1e-5)
    assert len(gg) == len(gw)
    for i, (a, b) in enumerate(zip(gg, gw)):
        assert a.shape == b.shape, (model, i)
        assert np.all(np.isfinite(a)), (model, fused, i)
        np.testing.assert_allclose(a, b, err_msg=f"{model} fused={fused} leaf {i}",
                                   **_tol(model))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("model", MODELS)
def test_gradients_match_jax(jax_sqrt_rule, model, fused):
    jcfg, _ = _configs(model)
    jp, tp = _params(jcfg)
    jg, tg, y, eig = _batch()
    want = _jax_grads(model, fused, jp, jg, y, eig)
    _check(model, fused, _port_grads(model, fused, tp, tg, y, eig), want)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("model", MODELS)
def test_kernel_branch_gradients_match_jax(jax_sqrt_rule, monkeypatch, model, fused):
    """The same through ``ops.KernelFunction`` (the kernels stood in by their
    plain versions under ``no_grad``), with every kernel of the model's path
    run under grad."""
    jcfg, _ = _configs(model)
    jp, tp = _params(jcfg)
    jg, tg, y, eig = _batch()
    want = _jax_grads(model, fused, jp, jg, y, eig)
    calls = forced_kernels(monkeypatch)
    _check(model, fused, _port_grads(model, fused, tp, tg, y, eig), want)
    path = {"gat": ("node_mlp", "edge_softmax", "segment_reduce")}.get(
        model, ("node_mlp", "fused_mp") if fused else ("node_mlp",))
    assert all(calls[k] > 0 for k in path), dict(calls)


def test_jax_pna_gradient_is_not_finite_without_the_rule():
    """Why the JAX side takes the square-root rule: JAX's own PNA gradient
    has NaNs (std over equal values), the port's is finite."""
    jcfg, _ = _configs("pna")
    jp, tp = _params(jcfg)
    jg, tg, y, eig = _batch()
    _, want = _jax_grads("pna", False, jp, jg, y, eig)
    _, got = _port_grads("pna", False, tp, tg, y, eig)
    assert not all(np.all(np.isfinite(g)) for g in want)
    assert all(np.all(np.isfinite(g)) for g in got)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_pna_gradients_match_unmodified_jax_where_finite(fused):
    """PNA against JAX's own ``jnp.sqrt``: the loss, and each leaf whose JAX
    gradient is finite (no NaN from a std over equal values reaches it),
    leaf for leaf; the square-root rule only decides the other leaves."""
    jcfg, _ = _configs("pna")
    jp, tp = _params(jcfg)
    jg, tg, y, eig = _batch()
    lw, gw = _jax_grads("pna", fused, jp, jg, y, eig)
    lg, gg = _port_grads("pna", fused, tp, tg, y, eig)
    np.testing.assert_allclose(lg, lw, rtol=1e-5)
    finite = [i for i, b in enumerate(gw) if np.all(np.isfinite(b))]
    # the head's three linears and the last layer's gamma linear
    assert len(finite) >= 8, finite
    for i in finite:
        np.testing.assert_allclose(gg[i], gw[i], err_msg=f"pna fused={fused} leaf {i}",
                                   **_tol("pna"))


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_train_gin_molhiv", ROOT / "examples" / "torch_train_gin_molhiv.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_three_adamw_steps_match_jax():
    ex = _example()
    jcfg, tcfg = _configs("gin")
    jp, tp = _params(jcfg, seed=1)
    jopt_cfg = JA.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=3, weight_decay=0.01)
    topt_cfg = TA.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=3, weight_decay=0.01)
    jopt, topt = JA.init(jp), TA.init(tp)
    stream = JP.MoleculeStream(JP.MOLHIV, seed=0)

    def jloss(p, g, y):
        return _bce_jax(JM.apply(p, g, jcfg)[: y.shape[0], 0], y)

    @jax.jit
    def jstep(p, o, g, y):
        loss, grads = jax.value_and_grad(jloss)(p, g, y)
        p, o, _ = JA.update(jopt_cfg, grads, o, p)
        return p, o, loss

    rng = np.random.default_rng(0)
    for step in range(3):
        tg, ty = ex.make_batch(stream, rng, step, batch=B)
        raw = [stream.graph_at(step * B + i) for i in range(B)]
        jg = JG.batch_graphs([r[:4] for r in raw], B * 64, B * 192)
        jp, jopt, jl = jstep(jp, jopt, jg, jnp.asarray([r[4] for r in raw]))
        tp, topt, tl, _ = ex.step_fn(tp, topt, topt_cfg, tcfg, tg, ty)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, err_msg=f"step {step}")
    for a, b in zip(TA.leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)

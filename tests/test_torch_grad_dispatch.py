"""Gradients through the kernel branch of ``kernels/ops.py``, on the CPU.

On a CUDA tensor each GNN wrapper (``node_mlp``, ``segment_reduce``,
``edge_softmax``, ``quant_node_mlp``, ``quant_node_mlp_dynamic``,
``fused_mp``) launches its kernel, whose output has no history of its own.
Where a gradient is needed the launch runs inside
``ops.KernelFunction``, whose backward is the plain version's gradient.
There is no card here, so the kernel branch is forced two ways
(``tests/torch_kernel_standins.py``): ``ops._resolve`` sends every mode
but ``reference`` there, and each CUDA wrapper is replaced by its plain
version run under ``torch.no_grad()`` (a detached output, as the ctypes
launch gives).  Then, for every op:

  * the gradient of every floating operand equals mode ``reference``'s
    (autograd of the plain version) at rtol 1e-6 / atol 1e-7 in fp32 (the
    same products recomputed: in practice bit for bit), in its dtype;
  * the output's ``grad_fn`` is the Function's, the wrapper ran once, and
    the dispatch census counted one decision (the backward's recompute is
    no dispatch);
  * under ``torch.no_grad()`` and ``torch.inference_mode()`` the bare
    wrapper runs and the output has no ``grad_fn`` (serving, its graphs).

``max`` / ``min`` run on values with ties: the tied elements share the
gradient as ``scatter_reduce`` shares it.  ``perm`` gathers sit outside the
Function and stay differentiable (COO-order values get their gradient).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import graph as TG
from repro_torch.core import layout as LY
from repro_torch.core.message_passing import MPSpec
from repro_torch.data import pipeline as TP
from repro_torch.kernels import ops as kops
from torch_kernel_standins import forced_kernels

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-7)
F, H = 8, 16  # features, gamma's hidden width


def _graph():
    gs = [g[:4] for g in TP.MoleculeStream(TP.MOLHIV, seed=3).take(3)]
    g = TG.batch_graphs(gs, 128, 320)
    return g, LY.build_layout(g)


def _t(rng, shape, ties=False):
    a = (rng.integers(-3, 4, size=shape) if ties else rng.normal(size=shape))
    return torch.from_numpy(np.asarray(a, np.float32))


def _i8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, size=shape).astype(np.int8))


def _case_node_mlp(rng, activation="relu", dtype=torch.float32):
    x, w, b = _t(rng, (40, 9)).to(dtype), _t(rng, (9, F)), _t(rng, (F,))
    return (lambda o, mode: kops.node_mlp(o["x"], o["w"], o["b"], activation, mode=mode),
            dict(x=x, w=w, b=b))


def _case_segment_reduce(rng, op):
    g, lay = _graph()
    n, e = g.num_nodes, lay.perm.shape[0]
    v = _t(rng, (e, F), ties=op in ("max", "min"))
    return (lambda o, mode: kops.segment_reduce(o["v"], lay.ids_sorted, lay.offsets, n,
                                                op, mode=mode, perm=lay.perm),
            dict(v=v))


def _case_edge_softmax(rng):
    g, lay = _graph()
    z = _t(rng, (lay.perm.shape[0], 4))
    return (lambda o, mode: kops.edge_softmax(o["z"], lay.ids_sorted, lay.offsets,
                                              g.num_nodes, mode=mode, perm=lay.perm),
            dict(z=z))


def _case_quant_node_mlp(rng):
    x_q, w_q = _i8(rng, (40, 12)), _i8(rng, (12, F))
    scale = torch.abs(_t(rng, (F,))) * 1e-3
    rs = torch.abs(_t(rng, (40, 1))) * 1e-2
    return (lambda o, mode: kops.quant_node_mlp(x_q, w_q, o["scale"], o["b"], "relu",
                                                row_scale=o["rs"], mode=mode),
            dict(scale=scale, b=_t(rng, (F,)), rs=rs))


def _case_quant_node_mlp_dynamic(rng):
    w_q = _i8(rng, (12, F))
    return (lambda o, mode: kops.quant_node_mlp_dynamic(o["x"], w_q, o["w_scale"], o["b"],
                                                        "relu", mode=mode),
            dict(x=_t(rng, (40, 12)), w_scale=torch.abs(_t(rng, (F,))) * 1e-2,
                 b=_t(rng, (F,))))


def _case_fused_mp(rng, gamma, precision="fp32"):
    g, lay = _graph()
    n, e = g.num_nodes, lay.perm.shape[0]
    ops_ = {"gcn": ("sum",), "gin": ("sum",), "pna": ("sum", "sqsum", "max", "min"),
            "dgn": ("sum", "wsum")}[gamma]
    spec = MPSpec(phi="add_relu" if gamma == "gin" else "copy", ops=ops_, gamma=gamma,
                  precision=precision)
    k1 = {"gin": F, "pna": 12 * F, "dgn": 3 * F}.get(gamma)
    o = dict(msrc=_t(rng, (n, F)), x_res=_t(rng, (n, F)))
    if gamma in ("gcn", "pna", "dgn"):
        o["nop"] = torch.abs(_t(rng, (n, 3 if gamma == "pna" else 1)))
    if gamma == "gin":
        o["eop"] = _t(rng, (e, F))
    if gamma == "dgn":
        o["ew"] = _t(rng, (e, 1))
    fixed = {}
    if k1 is not None:
        out1 = H if gamma == "gin" else F
        if precision == "int8":
            fixed["w1"] = _i8(rng, (k1, out1))
            o["w1_scale"] = torch.abs(_t(rng, (out1,))) * 1e-2
        else:
            o["w1"] = _t(rng, (k1, out1)) * 0.3
        o["b1"] = _t(rng, (out1,))
    if gamma == "gin":
        o["w2"], o["b2"] = _t(rng, (H, F)) * 0.3, _t(rng, (F,))
    return (lambda ops, mode: kops.fused_mp(
        spec, lay.ids_sorted, lay.offsets, lay.src_sorted, lay.in_degree, g.node_mask,
        mode=mode, **fixed, **ops), o)


CASES = {
    "node_mlp-relu": (_case_node_mlp, {}),
    "node_mlp-gelu": (_case_node_mlp, dict(activation="gelu")),
    "node_mlp-f16-input": (_case_node_mlp, dict(dtype=torch.float16)),
    **{f"segment_reduce-{op}": (_case_segment_reduce, dict(op=op))
       for op in ("sum", "mean", "sqsum", "max", "min")},
    "edge_softmax": (_case_edge_softmax, {}),
    "quant_node_mlp": (_case_quant_node_mlp, {}),
    "quant_node_mlp_dynamic": (_case_quant_node_mlp_dynamic, {}),
    **{f"fused_mp-{gm}-{pr}": (_case_fused_mp, dict(gamma=gm, precision=pr))
       for gm, pr in (("gcn", "fp32"), ("gin", "fp32"), ("gin", "int8"), ("pna", "fp32"),
                      ("pna", "int8"), ("dgn", "fp32"), ("dgn", "int8"))},
}
WRAPPER = {"node_mlp": "node_mlp", "segment_reduce": "segment_reduce",
           "edge_softmax": "edge_softmax", "quant_node_mlp": "quant_node_mlp",
           "quant_node_mlp_dynamic": "quant_node_mlp_dynamic", "fused_mp": "fused_mp"}


def _op(case: str) -> str:
    return case.split("-")[0]


def _build(case, seed=0):
    make, kw = CASES[case]
    return make(np.random.default_rng(seed), **kw)


def _grads(call, operands, mode, seed=1):
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in operands.items()}
    out = call(leaves, mode)
    w = torch.from_numpy(np.random.default_rng(seed).normal(size=out.shape)
                         .astype(np.float32))
    loss = (out.float() * w).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return out, dict(zip(leaves, grads))


def _census(op: str) -> float:
    c = kops.default_registry().counter("kernels_dispatch_total")
    return c.value(op=op, path="kernel")


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_branch_gradient_equals_reference_mode(monkeypatch, case):
    calls = forced_kernels(monkeypatch)
    call, operands = _build(case)
    census_op = "quant_node_mlp" if _op(case).startswith("quant") else _op(case)
    before = _census(census_op)
    out, got = _grads(call, operands, "auto")
    assert type(out.grad_fn).__name__ == "KernelFunctionBackward"
    assert calls[WRAPPER[_op(case)]] == 1 and sum(calls.values()) == 1
    assert _census(census_op) == before + 1  # the forward's one decision; no more
    ref_out, want = _grads(call, operands, "reference")
    assert sum(calls.values()) == 1
    torch.testing.assert_close(out, ref_out, **TOL)
    nonzero = 0
    for k, w in want.items():
        assert w is not None, f"the plain version gives {k} no gradient"
        assert got[k] is not None, f"{case}: no gradient for {k}"
        assert got[k].dtype == w.dtype == operands[k].dtype, k
        torch.testing.assert_close(got[k], w, **TOL, msg=lambda m: f"{case} d{k}: {m}")
        nonzero += int(bool(torch.any(w != 0)))
    assert nonzero >= 1


@pytest.mark.parametrize("case", list(CASES))
def test_without_grad_the_bare_kernel_runs(monkeypatch, case):
    calls = forced_kernels(monkeypatch)
    call, operands = _build(case, seed=2)
    leaves = {k: v.requires_grad_(True) for k, v in operands.items()}
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            out = call(leaves, "auto")
        assert out.grad_fn is None and not out.requires_grad, ctx.__name__
    # operands that need no gradient: the bare kernel under grad mode too
    plain_ops = {k: v.detach() for k, v in operands.items()}
    assert call(plain_ops, "auto").grad_fn is None
    assert calls[WRAPPER[_op(case)]] == 3 and sum(calls.values()) == 3

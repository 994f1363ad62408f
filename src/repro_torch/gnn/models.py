"""The paper's six GNN models on the generic message-passing core, PyTorch
port of ``repro.gnn.models``.  A parameter tree quantized by
``quant.apply`` runs through the same bodies (``gnn/layers.linear_apply``
dispatches on each linear).

Configurations default to the paper's §5.1 settings:

  GCN / GIN / GIN+VN : 5 layers, dim 100, mean pool, linear head
  PNA                : 4 layers, dim 80,  mean pool, MLP head (40, 20, 1)
  DGN                : 4 layers, dim 100, mean pool, MLP head (50, 25, 1)
  GAT                : 5 layers, 4 heads x 16 features, mean pool, linear head
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as Fn

from repro_torch.core import graph as G
from repro_torch.core import layout as LY
from repro_torch.core import message_passing as mp
from repro_torch.gnn import layers as L
from repro_torch.kernels import ops as kops

@dataclasses.dataclass(frozen=True)
class GNNConfig:
    model: str = "gin"  # gcn | gin | gat | pna | dgn
    num_layers: int = 5
    hidden: int = 100
    feat_dim: int = 9  # OGB mol atom features (as floats)
    edge_dim: int = 3  # OGB mol bond features
    out_dim: int = 1
    heads: int = 4  # GAT
    head_features: int = 16  # GAT per-head features
    avg_degree: float = 2.2  # PNA scaler constant (MolHIV train stat)
    task: str = "graph"  # graph | node
    virtual_node: bool = False
    head_hidden: tuple = ()  # () = single linear head
    kernel_mode: str = "auto"

    @property
    def width(self) -> int:
        return self.heads * self.head_features if self.model == "gat" else self.hidden


def paper_config(model: str, virtual_node: bool = False, **kw) -> GNNConfig:
    base = dict(model=model, virtual_node=virtual_node)
    if model in ("gcn", "gin"):
        base.update(num_layers=5, hidden=100)
    elif model == "gat":
        base.update(num_layers=5, heads=4, head_features=16)
    elif model == "pna":
        base.update(num_layers=4, hidden=80, head_hidden=(40, 20))
    elif model == "dgn":
        base.update(num_layers=4, hidden=100, head_hidden=(50, 25))
    else:
        raise ValueError(model)
    base.update(kw)
    return GNNConfig(**base)


def init(gen: torch.Generator, cfg: GNNConfig, device="cpu") -> dict:
    """Random parameters drawn from ``gen`` (the port's generator draws
    differ from ``jax.random``; parity tests convert JAX params with
    ``repro_torch.convert.from_jax_params`` instead)."""
    w = cfg.width
    params: dict = {"encoder": L.linear_init(gen, cfg.feat_dim, w, device),
                    "layers": []}
    for _ in range(cfg.num_layers):
        if cfg.model == "gcn":
            lp = {"lin": L.linear_init(gen, w, w, device)}
        elif cfg.model == "gin":
            lp = {"edge": L.linear_init(gen, cfg.edge_dim, w, device),
                  "eps": torch.zeros((), device=device),
                  "mlp": L.mlp_init(gen, (w, 2 * w, w), device)}
        elif cfg.model == "gat":
            h, f = cfg.heads, cfg.head_features
            lp = {"proj": L.linear_init(gen, w, h * f, device),
                  "att_src": L.glorot(gen, (h, f), device),
                  "att_dst": L.glorot(gen, (h, f), device)}
        elif cfg.model == "pna":
            lp = {"pre": L.linear_init(gen, w, w, device),
                  "post": L.linear_init(gen, 12 * w, w, device)}
        elif cfg.model == "dgn":
            lp = {"post": L.linear_init(gen, 3 * w, w, device)}
        else:
            raise ValueError(f"unknown model {cfg.model!r}")
        params["layers"].append(lp)
    if cfg.virtual_node:
        params["vn_embed"] = torch.zeros((w,), device=device)
        vn_mlps = []
        for _ in range(cfg.num_layers - 1):
            m = L.mlp_init(gen, (w, 2 * w, w), device)
            # the VN update's output layer starts at 0, so the virtual-node
            # branch starts as a no-op (as in the JAX package)
            m[-1]["w"] = torch.zeros_like(m[-1]["w"])
            vn_mlps.append(m)
        params["vn_mlp"] = vn_mlps
    head_sizes = (w,) + tuple(cfg.head_hidden) + (cfg.out_dim,)
    params["head"] = L.mlp_init(gen, head_sizes, device)
    return params


# ---------------------------------------------------------------------------
# per-model layer bodies: (phi, A, gamma) over the shared GraphLayout; with
# ``extras["fused"]`` a body declares an ``mp.MPSpec`` + operands and runs
# the whole layer as one fused_mp pass.  Bodies whose linears cannot lower
# (int8-static, ap_fixed: the operand probes return None) keep the closure
# form; GAT opts out structurally.  Without a plan (``share_layout=False``,
# the per-call-sort path) ``extras["layout"]`` is None: every body takes the
# closure form, its graph-static values come from the graph, and each
# reduction sorts privately, as in JAX.
# ---------------------------------------------------------------------------


def _spec_precision(lin1) -> str:
    return "int8" if lin1["kind"] == "int8" else "fp32"


def _lin1_operands(lin1) -> dict:
    """fused_linear_operands dict -> the kernel's w1 / b1 / w1_scale."""
    if lin1["kind"] == "int8":
        return dict(w1=lin1["w_q"], b1=lin1["b"], w1_scale=lin1["w_scale"])
    return dict(w1=lin1["w"], b1=lin1["b"])


def _gcn_layer(g: G.Graph, x, lp, cfg, extras):
    # x' = W^T sum_{j in N(i) U {i}} x_j / sqrt((d_i+1)(d_j+1)) + b
    layout = extras["layout"]
    if layout is not None:
        inv_sqrt = layout.gcn_inv_sqrt
    else:
        inv_sqrt = torch.rsqrt(G.in_degree(g).to(torch.float32) + 1.0)
    xw = L.linear_apply(lp["lin"], x, mode=cfg.kernel_mode)
    xs = xw * inv_sqrt[:, None]

    if extras["fused"] and layout is not None:
        spec = mp.MPSpec(phi="copy", ops=("sum",), gamma="gcn")
        return mp.mp_layer(
            g, xs, layout=layout, spec=spec, mode=cfg.kernel_mode,
            operands=dict(msrc=xs, x_res=xs, nop=inv_sqrt[:, None]),
        )

    def phi(x_src, x_dst, e):
        return x_src

    def gamma(xs_, agg):
        return (agg + xs_) * inv_sqrt[:, None]  # self loop folded in

    return mp.mp_layer(g, xs, phi, gamma, ops=("sum",), layout=layout)


def _gin_self(eps: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(1 + eps) * x, promoted as JAX promotes it: eps is a typed f32
    scalar, so an f16 x gives f32 (torch would keep a 0-d operand out of
    the promotion and round the product to f16)."""
    return (1.0 + eps) * x.to(torch.promote_types(x.dtype, eps.dtype))


def _gin_layer(g: G.Graph, x, lp, cfg, extras):
    # phi(x, e) = relu(x_src + edge_embed)
    layout = extras["layout"]
    lin1 = edge_wb = lin2_wb = None
    if extras["fused"] and layout is not None:
        lin1 = L.fused_linear_operands(lp["mlp"][0])
        edge_wb = L.fused_dequant_weights(lp["edge"])
        lin2_wb = L.fused_dequant_weights(lp["mlp"][1])
    if lin1 is not None and edge_wb is not None and lin2_wb is not None:
        # edge features gather into plan order first, so the edge
        # embedding lands pre-sorted as the kernel's phi operand
        ef_sorted = g.edge_feat[layout.perm.long()]
        e_emb = kops.node_mlp(ef_sorted, edge_wb[0], edge_wb[1],
                              activation="none", mode=cfg.kernel_mode)
        spec = mp.MPSpec(phi="add_relu", ops=("sum",), gamma="gin",
                         precision=_spec_precision(lin1))
        return mp.mp_layer(
            g, x, layout=layout, spec=spec, mode=cfg.kernel_mode,
            operands=dict(
                msrc=x, x_res=_gin_self(lp["eps"], x), eop=e_emb,
                w2=lin2_wb[0], b2=lin2_wb[1], **_lin1_operands(lin1),
            ),
        )

    e_emb = L.linear_apply(lp["edge"], g.edge_feat, mode=cfg.kernel_mode)

    def phi(x_src, x_dst, e):
        return torch.relu(x_src + e)

    def gamma(x_, agg):
        return L.mlp_apply(lp["mlp"], _gin_self(lp["eps"], x_) + agg,
                           mode=cfg.kernel_mode)

    return mp.mp_layer(g, x, phi, gamma, ops=("sum",), edge_feat=e_emb,
                       layout=layout)


def _gat_layer(g: G.Graph, x, lp, cfg, extras):
    """GAT's A(.) is an edge softmax, not a plain reduction, so GAT does not
    lower to ``fused_mp`` (it ignores ``extras["fused"]``): phi gives
    per-edge logits, ``mp.gat_attention`` normalises and reduces over the
    plan with the ``edge_softmax`` and ``segment_reduce`` kernels, and
    gamma is the elu tail."""
    h, f = cfg.heads, cfg.head_features
    n = g.num_nodes
    xp = L.linear_apply(lp["proj"], x, mode=cfg.kernel_mode).reshape(n, h, f)
    a_src = (xp * lp["att_src"]).sum(-1)  # (N, H)
    a_dst = (xp * lp["att_dst"]).sum(-1)
    xp_src = xp
    if g.shard is not None:  # the sources' features and scores: one all-gather
        table = mp.source_rows(g, torch.cat([xp.reshape(n, h * f), a_src], dim=-1))
        xp_src, a_src = table[:, :h * f].reshape(-1, h, f), table[:, h * f:]
    logits = Fn.leaky_relu(a_src[g.src.long()] + a_dst[g.dst.long()], 0.2)
    agg = mp.gat_attention(g, logits, xp_src, layout=extras["layout"],
                           mode=cfg.kernel_mode)
    out = Fn.elu(agg)
    return torch.where(g.node_mask[:, None], out, torch.zeros_like(out))


def _pna_layer(g: G.Graph, x, lp, cfg, extras):
    layout = extras["layout"]
    xp = L.linear_apply(lp["pre"], x, activation="relu", mode=cfg.kernel_mode)

    fusable = extras["fused"] and layout is not None
    lin1 = L.fused_linear_operands(lp["post"]) if fusable else None
    if lin1 is not None:
        spec = mp.MPSpec(phi="copy", ops=("sum", "sqsum", "max", "min"),
                         gamma="pna", precision=_spec_precision(lin1))
        return mp.mp_layer(
            g, xp, layout=layout, spec=spec, mode=cfg.kernel_mode,
            operands=dict(msrc=xp, x_res=x, nop=layout.pna_scalers,
                          **_lin1_operands(lin1)),
        )

    def phi(x_src, x_dst, e):
        return x_src

    def aggregate(graph, messages, layout_):
        return mp.pna_aggregate(graph, messages, cfg.avg_degree, layout=layout_)

    def gamma(xp_, tower):
        out = L.linear_apply(lp["post"], tower, activation="relu",
                             mode=cfg.kernel_mode)
        return out + x  # skip connection (§4.3) from the layer input

    return mp.mp_layer(g, xp, phi, gamma, aggregate=aggregate, layout=layout)


def _dgn_layer(g: G.Graph, x, lp, cfg, extras):
    """mean + directional-derivative aggregation along eigenvector phi1 (§4.4):
    y_dx_i = | sum_j w_ij x_j  -  x_i sum_j w_ij |, with the directional
    weights off the plan (computed once per forward).  Fused, the weighted
    sum is ``fused_mp``'s "wsum" accumulator over plan-ordered weights."""
    layout = extras["layout"]
    if layout is not None:
        w_e, wsum = layout.dgn_w_e, layout.dgn_wsum
    else:  # the per-call path recomputes them in every layer, as JAX does
        w_e, _, wsum = mp.dgn_directional_weights(g, extras["eigvec"])

    fusable = extras["fused"] and layout is not None
    lin1 = L.fused_linear_operands(lp["post"]) if fusable else None
    if lin1 is not None:
        spec = mp.MPSpec(phi="copy", ops=("sum", "wsum"), gamma="dgn",
                         precision=_spec_precision(lin1))
        return mp.mp_layer(
            g, x, layout=layout, spec=spec, mode=cfg.kernel_mode,
            operands=dict(msrc=x, x_res=x, nop=wsum[:, None],
                          ew=w_e[layout.perm.long()][:, None],
                          **_lin1_operands(lin1)),
        )

    def phi(x_src, x_dst, e):
        return x_src

    def aggregate(graph, messages, layout_):
        return mp.dgn_aggregate(graph, messages, w_e, layout_)

    def gamma(x_, agg):
        d = x_.shape[-1]
        mean_agg, wx = agg[:, :d], agg[:, d:]
        dx_agg = torch.abs(wx - x_ * wsum[:, None])
        tower = torch.cat([x_, mean_agg, dx_agg], dim=-1)
        out = L.linear_apply(lp["post"], tower, activation="relu",
                             mode=cfg.kernel_mode)
        return out + x_  # skip connection, as in PNA (§4.4)

    return mp.mp_layer(g, x, phi, gamma, aggregate=aggregate, layout=layout)


_LAYERS = {"gcn": _gcn_layer, "gin": _gin_layer, "gat": _gat_layer,
           "pna": _pna_layer, "dgn": _dgn_layer}


# ---------------------------------------------------------------------------
# full forward pass
# ---------------------------------------------------------------------------


def apply(
    params: dict,
    g: G.Graph,
    cfg: GNNConfig,
    eigvec: Optional[torch.Tensor] = None,
    num_graphs: Optional[int] = None,
    layout: Optional[LY.GraphLayout] = None,
    share_layout: bool = True,
    fused: bool = False,
) -> torch.Tensor:
    """Forward pass -> (num_graphs, out_dim) for graph tasks or
    (N_pad, out_dim) for node tasks.

    ``eigvec`` is DGN's (N_pad,) Laplacian eigenvector input.  ``layout``
    is the shared edge plan: pass one built at pack time for a zero-sort
    forward, or leave it ``None`` to build it here (one sort).
    ``share_layout=False`` drops the plan (a given one too) and takes the
    per-call-sort path: every aggregation sorts its own edges, bit for bit
    the shared forward; kept for the parity tests and the sort-count A/B,
    as in JAX.  ``fused`` runs each layer as one ``fused_mp`` pass over the
    plan (GAT, layers whose quantized linears cannot lower, and every layer
    without a plan keep the unfused path).

    A rank's part of a sharded batch (``g.shard`` set, with ``eigvec`` and
    ``layout`` from ``core.message_passing.shard_inputs``) runs the same
    bodies on its rows: the layers all-gather their source rows, the
    pools all-reduce, and a node task's output is all-gathered, so every
    rank returns the whole batch's output.
    """
    rows = g.num_nodes if g.shard is None else g.shard.n
    m = rows if num_graphs is None else num_graphs
    layer_fn = _LAYERS[cfg.model]
    if share_layout:
        layout = LY.for_model(layout, g, cfg.model, avg_degree=cfg.avg_degree,
                              eigvec=eigvec)
    else:
        if cfg.model == "dgn" and eigvec is None:
            raise ValueError("dgn needs its Laplacian eigenvector input: pass "
                             "eigvec= (serving: with_eigvec=True)")
        layout = None
    extras = {"eigvec": eigvec, "layout": layout, "fused": fused}
    x = L.linear_apply(params["encoder"], g.node_feat, mode=cfg.kernel_mode)
    # promotes as jnp.where(mask, x, 0.0): an integer encoder output -> f32
    x = torch.where(g.node_mask[:, None], x, 0.0)
    vn = None  # (m, w) per-graph virtual-node state
    if cfg.virtual_node:
        vn = params["vn_embed"].expand(m, x.shape[-1])
        gid = torch.clamp(g.graph_id, 0, m - 1).long()
    for li in range(cfg.num_layers):
        if cfg.virtual_node:
            # the virtual node broadcasts its state to its graph's nodes
            x = x + vn[gid] * g.node_mask[:, None]
        x = layer_fn(g, x, params["layers"][li], cfg, extras)
        if cfg.virtual_node and li < cfg.num_layers - 1:
            # vn_{l+1} = MLP(vn_l + sum-pool of that graph's nodes)
            pooled = mp.global_pool(g, x, op="sum", num_graphs=m)
            vn = L.mlp_apply(params["vn_mlp"][li], pooled + vn,
                             mode=cfg.kernel_mode)
    if cfg.task == "graph":
        pooled = mp.global_pool(g, x, op="mean", num_graphs=m)
        return L.mlp_apply(params["head"], pooled, mode=cfg.kernel_mode)
    out = L.mlp_apply(params["head"], x, mode=cfg.kernel_mode)
    return out if g.shard is None else g.shard.gather(out)


def forward_program(
    cfg: GNNConfig,
    num_graphs: Optional[int] = None,
    share_layout: bool = True,
    fused: bool = False,
) -> Callable:
    """:func:`apply` with its statics bound: a ``(params, graph, eigvec,
    layout) -> logits`` closure, built once per program-cache entry by
    ``serve.executor.Executor``.  ``share_layout`` and ``fused`` change
    which ops the program runs, never its positional signature."""

    def program(params, g: G.Graph, eigvec, layout):
        return apply(params, g, cfg, eigvec=eigvec, num_graphs=num_graphs,
                     layout=layout, share_layout=share_layout, fused=fused)

    return program

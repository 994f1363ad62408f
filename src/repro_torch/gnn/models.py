"""The paper's GNN models on the generic message-passing core, PyTorch
port of ``repro.gnn.models`` — GCN and GIN in fp32 in this slice.

Configurations default to the paper's §5.1 settings (GCN / GIN: 5 layers,
dim 100, mean pool, linear head).  GIN+VN, PNA, DGN and GAT keep their
configs here but raise ``NotImplementedError`` at ``init`` / ``apply``:
they arrive with a later slice (ROADMAP queue 1, item 3).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import graph as G
from repro_torch.core import layout as LY
from repro_torch.core import message_passing as mp
from repro_torch.gnn import layers as L
from repro_torch.kernels import ops as kops

PORTED_MODELS = ("gcn", "gin")


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


def _require_ported(cfg: GNNConfig) -> None:
    if cfg.model not in PORTED_MODELS or cfg.virtual_node:
        name = "gin_vn" if cfg.virtual_node else cfg.model
        raise NotImplementedError(
            f"{name} arrives with the GIN+VN/PNA/DGN/GAT port slice "
            f"(ROADMAP queue 1, item 3); this slice ports {PORTED_MODELS}"
        )


def init(gen: torch.Generator, cfg: GNNConfig, device="cpu") -> dict:
    """Random parameters drawn from ``gen`` (the port's generator draws
    differ from ``jax.random``; parity tests convert JAX params with
    ``repro_torch.convert.from_jax_params`` instead)."""
    _require_ported(cfg)
    w = cfg.width
    params: dict = {"encoder": L.linear_init(gen, cfg.feat_dim, w, device),
                    "layers": []}
    for _ in range(cfg.num_layers):
        if cfg.model == "gcn":
            lp = {"lin": L.linear_init(gen, w, w, device)}
        else:
            lp = {"edge": L.linear_init(gen, cfg.edge_dim, w, device),
                  "eps": torch.zeros((), device=device),
                  "mlp": L.mlp_init(gen, (w, 2 * w, w), device)}
        params["layers"].append(lp)
    head_sizes = (w,) + tuple(cfg.head_hidden) + (cfg.out_dim,)
    params["head"] = L.mlp_init(gen, head_sizes, device)
    return params


# ---------------------------------------------------------------------------
# per-model layer bodies: (phi, A, gamma) over the shared GraphLayout; with
# ``extras["fused"]`` a body declares an ``mp.MPSpec`` + operands and runs
# the whole layer as one fused_mp pass
# ---------------------------------------------------------------------------


def _gcn_layer(g: G.Graph, x, lp, cfg, extras):
    # x' = W^T sum_{j in N(i) U {i}} x_j / sqrt((d_i+1)(d_j+1)) + b
    layout = extras["layout"]
    inv_sqrt = layout.gcn_inv_sqrt
    xw = L.linear_apply(lp["lin"], x, mode=cfg.kernel_mode)
    xs = xw * inv_sqrt[:, None]

    if extras["fused"]:
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


def _gin_layer(g: G.Graph, x, lp, cfg, extras):
    # phi(x, e) = relu(x_src + edge_embed)
    layout = extras["layout"]
    if extras["fused"]:
        lin1 = L.fused_linear_operands(lp["mlp"][0])
        edge_w, edge_b = L.fused_dequant_weights(lp["edge"])
        w2, b2 = L.fused_dequant_weights(lp["mlp"][1])
        # edge features gather into plan order first, so the edge
        # embedding lands pre-sorted as the kernel's phi operand
        ef_sorted = g.edge_feat[layout.perm.long()]
        e_emb = kops.node_mlp(ef_sorted, edge_w, edge_b, activation="none",
                              mode=cfg.kernel_mode)
        spec = mp.MPSpec(phi="add_relu", ops=("sum",), gamma="gin")
        return mp.mp_layer(
            g, x, layout=layout, spec=spec, mode=cfg.kernel_mode,
            operands=dict(
                msrc=x, x_res=(1.0 + lp["eps"]) * x, eop=e_emb,
                w1=lin1["w"], b1=lin1["b"], w2=w2, b2=b2,
            ),
        )

    e_emb = L.linear_apply(lp["edge"], g.edge_feat, mode=cfg.kernel_mode)

    def phi(x_src, x_dst, e):
        return torch.relu(x_src + e)

    def gamma(x_, agg):
        return L.mlp_apply(lp["mlp"], (1.0 + lp["eps"]) * x_ + agg,
                           mode=cfg.kernel_mode)

    return mp.mp_layer(g, x, phi, gamma, ops=("sum",), edge_feat=e_emb,
                       layout=layout)


_LAYERS = {"gcn": _gcn_layer, "gin": _gin_layer}


# ---------------------------------------------------------------------------
# full forward pass
# ---------------------------------------------------------------------------


def apply(
    params: dict,
    g: G.Graph,
    cfg: GNNConfig,
    num_graphs: Optional[int] = None,
    layout: Optional[LY.GraphLayout] = None,
    fused: bool = False,
) -> torch.Tensor:
    """Forward pass -> (num_graphs, out_dim) for graph tasks or
    (N_pad, out_dim) for node tasks.

    ``layout`` is the shared edge plan: pass one built at pack time for a
    zero-sort forward, or leave it ``None`` to build it here (one sort).
    ``fused`` runs each layer as one ``fused_mp`` pass over the plan.
    """
    _require_ported(cfg)
    m = g.num_nodes if num_graphs is None else num_graphs
    layer_fn = _LAYERS[cfg.model]
    layout = LY.for_model(layout, g, cfg.model)
    extras = {"layout": layout, "fused": fused}
    x = L.linear_apply(params["encoder"], g.node_feat, mode=cfg.kernel_mode)
    x = torch.where(g.node_mask[:, None], x, torch.zeros_like(x))
    for li in range(cfg.num_layers):
        x = layer_fn(g, x, params["layers"][li], cfg, extras)
    if cfg.task == "graph":
        pooled = mp.global_pool(g, x, op="mean", num_graphs=m)
        return L.mlp_apply(params["head"], pooled, mode=cfg.kernel_mode)
    return L.mlp_apply(params["head"], x, mode=cfg.kernel_mode)


def forward_program(
    cfg: GNNConfig,
    num_graphs: Optional[int] = None,
    fused: bool = False,
) -> Callable:
    """:func:`apply` with its statics bound: a ``(params, graph, layout)
    -> logits`` closure, built once per program-cache entry by
    ``serve.executor.Executor``."""

    def program(params, g: G.Graph, layout):
        return apply(params, g, cfg, num_graphs=num_graphs,
                     layout=layout, fused=fused)

    return program

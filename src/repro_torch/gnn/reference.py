"""Dense-adjacency oracle for every GNN model, PyTorch port of
``repro.gnn.reference``.

The sparse, plan-based, kernel-backed forward (``gnn.models.apply``) is
cross-checked against an independent dense formulation: the adjacency is an
(N, N) matrix and every aggregation is a dense matmul or masked reduction.
It shares only the parameter dicts with the sparse path, no code.
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn

from repro_torch.core.graph import Graph
from repro_torch.gnn.models import GNNConfig


def dense_adjacency(g: Graph) -> torch.Tensor:
    """(N, N) with A[dst, src] = multiplicity of each real edge (in-edges)."""
    n = g.num_nodes
    a = torch.zeros((n, n), device=g.device)
    return a.index_put_((g.dst.long(), g.src.long()), g.edge_mask.float(),
                        accumulate=True)


def _lin(p, x, act="none"):
    y = x @ p["w"] + p["b"]
    return torch.relu(y) if act == "relu" else y


def _mlp(ps, x):
    """relu between layers, none after the last."""
    for i, p in enumerate(ps):
        x = _lin(p, x, "relu" if i < len(ps) - 1 else "none")
    return x


def _masked_pool(g: Graph, x, op="mean"):
    """Per-graph pool into N rows (graph ids index rows; padded nodes drop)."""
    n = g.num_nodes
    gid = torch.where(g.node_mask, g.graph_id, torch.full_like(g.graph_id, n))
    onehot = (gid[:, None] == torch.arange(n, device=g.device)[None, :]).float()
    total = onehot.T @ x
    if op == "sum":
        return total
    return total / torch.clamp(onehot.sum(0)[:, None], min=1.0)


def apply_dense(params, g: Graph, cfg: GNNConfig, eigvec=None) -> torch.Tensor:
    """Forward pass -> (N_pad, out_dim); for graph tasks row i is graph i."""
    a = dense_adjacency(g)  # a[i, j] = multiplicity of edge j -> i
    n = g.num_nodes
    nm = g.node_mask[:, None].float()
    x = _lin(params["encoder"], g.node_feat) * nm
    vn = None  # (N, w) per-graph virtual-node state
    if cfg.virtual_node:
        vn = params["vn_embed"].expand(n, x.shape[-1])
    for li, lp in enumerate(params["layers"]):
        if cfg.virtual_node:
            x = x + vn[torch.clamp(g.graph_id, 0, n - 1).long()] * nm
        if cfg.model == "gcn":
            inv = torch.rsqrt(a.sum(1) + 1.0)[:, None]
            xs = _lin(lp["lin"], x) * inv
            x = (a @ xs + xs) * inv * nm
        elif cfg.model == "gin":
            # per-edge messages, summed densely with a one-hot destination map
            msg = torch.relu(x[g.src.long()] + _lin(lp["edge"], g.edge_feat))
            msg = msg * g.edge_mask[:, None].float()
            onehot = (g.dst[:, None] == torch.arange(n, device=g.device)[None, :]).float()
            x = _mlp(lp["mlp"], (1.0 + lp["eps"]) * x + onehot.T @ msg) * nm
        elif cfg.model == "gat":
            h, f = cfg.heads, cfg.head_features
            xp = _lin(lp["proj"], x).reshape(n, h, f)
            a_src = torch.einsum("nhf,hf->nh", xp, lp["att_src"])
            a_dst = torch.einsum("nhf,hf->nh", xp, lp["att_dst"])
            logits = Fn.leaky_relu(a_src[None, :, :] + a_dst[:, None, :], 0.2)
            mask = (a > 0)[:, :, None]  # (dst, src, 1)
            # per-edge-instance softmax: a multi-edge weights the numerator
            # and the denominator by its multiplicity a[i, j]
            zmax = torch.where(mask, logits, float("-inf")).amax(dim=1, keepdim=True)
            zmax = torch.where(torch.isfinite(zmax), zmax, 0.0)
            num = a[:, :, None] * torch.exp(logits - zmax) * mask
            alpha = num / torch.clamp(num.sum(dim=1, keepdim=True), min=1e-30)
            out = torch.einsum("ijh,jhf->ihf", alpha, xp).reshape(n, h * f)
            x = Fn.elu(out) * nm
        elif cfg.model == "pna":
            xp = _lin(lp["pre"], x, "relu")
            deg = a.sum(1)
            cnt = torch.clamp(deg, min=1.0)[:, None]
            mean = (a @ xp) / cnt
            std = torch.sqrt(torch.clamp((a @ (xp * xp)) / cnt - mean * mean, min=0.0))
            has = (a > 0)[:, :, None]
            big = torch.where(has, xp[None], float("-inf"))
            small = torch.where(has, xp[None], float("inf"))
            live = deg[:, None] > 0
            mx = torch.where(live, big.amax(dim=1), torch.zeros_like(mean))
            mn = torch.where(live, small.amin(dim=1), torch.zeros_like(mean))
            aggs = torch.cat([mean, std, mx, mn], dim=-1)
            logd = torch.log(deg + 1.0)
            logdavg = torch.log(torch.tensor(cfg.avg_degree, device=g.device) + 1.0)
            amp = (logd / logdavg)[:, None]
            att = torch.where(deg > 0, logdavg / torch.clamp(logd, min=1e-6),
                              torch.zeros_like(logd))[:, None]
            tower = torch.cat([aggs, aggs * amp, aggs * att], dim=-1)
            x = (_lin(lp["post"], tower, "relu") + x) * nm
        elif cfg.model == "dgn":
            # multiplicity-weighted directional weights, [i, j] = phi_j - phi_i
            dphi = (eigvec[None, :] - eigvec[:, None]) * a
            w = dphi / torch.clamp(dphi.abs().sum(1, keepdim=True), min=1e-6)
            mean = (a @ x) / torch.clamp(a.sum(1), min=1.0)[:, None]
            dx = torch.abs(w @ x - x * w.sum(1, keepdim=True))
            tower = torch.cat([x, mean, dx], dim=-1)
            x = (_lin(lp["post"], tower, "relu") + x) * nm
        else:
            raise ValueError(f"unknown model {cfg.model!r}")
        if cfg.virtual_node and li < len(params["layers"]) - 1:
            vn = _mlp(params["vn_mlp"][li], _masked_pool(g, x, "sum") + vn)
    if cfg.task == "graph":
        return _mlp(params["head"], _masked_pool(g, x, "mean"))
    return _mlp(params["head"], x)

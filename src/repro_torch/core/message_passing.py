"""Generic message-passing layer (paper §3.3), PyTorch port of
``repro.core.message_passing``.

    x_i^{l+1} = gamma( x_i^l , A_{j in N(i)} ( phi(x_j^l, e_ij^l) ) )

Masking contract (as in the JAX package): padding edges are masked by the
plan — they carry the out-of-range destination id ``N_pad``, which the
segment reductions drop — so per-edge messages are never masked by value.
Padded node rows are zeroed on the way out of every layer.

**Sharded over a mesh** (the paper's large-graph extension, §4.6, on
several ranks).  :func:`shard_inputs` gives a rank its part of a padded
batch: an even block of the node rows, ``[r N/P, (r+1) N/P)``, and the
edges whose destination it owns, which are one contiguous range of the
plan (``layout.offsets`` at the block's ends), in plan order, held in a
window of the plan's length E_pad that starts there (the start stays on
the device: nothing is read back, so the forward can be captured), its
slots past the range masked.  The rank's ``Graph`` carries a
``runtime.partitioning.RowShard``; its edges' sources stay global node
ids.  Every layer form then reads its source
rows through :func:`source_rows`, one all-gather of the rows it reads as
sources, and aggregates only its own destination rows, in the plan's edge
order, so a node's reduction runs in the same order as on one rank:
``mp_layer`` (fused and closure), GAT's ``gat_attention`` (its softmax is
per destination), PNA's scalers and GCN's norms (per destination, from
the rank's in-degrees), DGN's weights (the source's eigenvector entry,
all-gathered once a forward).  ``global_pool`` sums a rank's rows, then
all-reduces.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.core import layout as LY
from repro_torch.core import scatter_gather as sg
from repro_torch.core.graph import Graph, in_degree
from repro_torch.kernels import ops as kops

PhiFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
GammaFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
AggregateFn = Callable[[Graph, torch.Tensor, Optional[LY.GraphLayout]], torch.Tensor]

AGGREGATORS = ("sum", "mean", "max", "min", "std", "var")

FUSED_AGGREGATORS = ("sum", "sqsum", "max", "min", "wsum")
FUSED_PHIS = ("copy", "add_relu")
FUSED_GAMMAS = ("gcn", "gin", "pna", "dgn")
FUSED_PRECISIONS = ("fp32", "int8")


@dataclasses.dataclass(frozen=True)
class MPSpec:
    """Declarative (phi, A, gamma) layer contract for the fused kernel.

      phi:        "copy" or "add_relu" (GIN: relu(x_src + edge operand))
      ops:        accumulator tuple, a non-empty subset of
                  ``FUSED_AGGREGATORS``
      gamma:      "gcn", "gin", "pna" or "dgn"
      precision:  "fp32" or "int8" (gamma's first linear in W8A8: the input
                  quantized per row inside the pass, int8 x int8 -> int32,
                  one requantize tail; gcn's gamma has no linear)
    """

    phi: str = "copy"
    ops: tuple = ("sum",)
    gamma: str = "gcn"
    precision: str = "fp32"

    def __post_init__(self):
        if self.phi not in FUSED_PHIS:
            raise ValueError(f"unknown phi {self.phi!r}; expected {FUSED_PHIS}")
        bad = [op for op in self.ops if op not in FUSED_AGGREGATORS]
        if bad or not self.ops:
            raise ValueError(
                f"fused aggregators {self.ops!r} must be a non-empty subset "
                f"of {FUSED_AGGREGATORS}"
            )
        if self.gamma not in FUSED_GAMMAS:
            raise ValueError(
                f"unknown gamma {self.gamma!r}; expected {FUSED_GAMMAS}"
            )
        if self.precision not in FUSED_PRECISIONS:
            raise ValueError(
                f"unknown precision {self.precision!r}; "
                f"expected {FUSED_PRECISIONS}"
            )


def source_rows(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """The table a layer's sources index: ``x`` itself, or on a shard every
    rank's rows of it (one all-gather)."""
    return x if graph.shard is None else graph.shard.gather(x)


def gather_scatter(
    graph: Graph,
    messages: torch.Tensor,
    ops: Sequence[str] = ("sum",),
    layout: Optional[LY.GraphLayout] = None,
) -> torch.Tensor:
    """Reduce (E_pad, F) COO-order messages into (N_pad, len(ops) * F)
    per-destination aggregates.  Plain PyTorch (``index_add_`` /
    ``scatter_reduce_``), as the JAX package leaves it to XLA.  Without a
    plan every op sorts privately (the per-call-sort path)."""
    if layout is not None:
        msg_sorted = messages[layout.perm.long()]
        outs = [LY.segment_reduce(layout, msg_sorted, op, presorted=True)
                for op in ops]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
    n = graph.num_nodes
    dst = torch.where(graph.edge_mask, graph.dst, torch.full_like(graph.dst, n))
    outs = [sg.sorted_segment_reduce(messages, dst, n, op) for op in ops]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def mp_layer(
    graph: Graph,
    x: torch.Tensor,
    phi: Optional[PhiFn] = None,
    gamma: Optional[GammaFn] = None,
    ops: Sequence[str] = ("sum",),
    edge_feat: torch.Tensor | None = None,
    layout: Optional[LY.GraphLayout] = None,
    aggregate: Optional[AggregateFn] = None,
    spec: Optional[MPSpec] = None,
    operands: Optional[Dict[str, torch.Tensor]] = None,
    mode: str = "auto",
) -> torch.Tensor:
    """One message-passing layer: the closure form (``phi``/``gamma``
    callables; gather, transform, reduce, update as separate ops) or the
    spec form (``spec`` + ``operands``; one ``kernels.ops.fused_mp`` pass
    over the layout plan, which it requires).  In the closure form
    ``aggregate(graph, messages, layout)`` replaces ``gather_scatter`` where
    a model's A(.) is more than a concatenation of reductions (PNA's scaled
    tower, DGN's directional derivative).  On a shard the sources come from
    every rank's rows (``operands["msrc"]`` / ``x`` all-gathered once)."""
    if spec is not None:
        if layout is None:
            raise ValueError(
                "fused mp_layer (spec=...) requires a GraphLayout plan; "
                "pass layout= or use the closure form"
            )
        if graph.shard is not None:
            operands = dict(operands, msrc=source_rows(graph, operands["msrc"]))
        return kops.fused_mp(
            spec, layout.ids_sorted, layout.offsets, layout.src_sorted,
            layout.in_degree, graph.node_mask, mode=mode, **operands,
        )
    e = graph.edge_feat if edge_feat is None else edge_feat
    x_src = source_rows(graph, x)[graph.src.long()]
    x_dst = x[graph.dst.long()]
    messages = phi(x_src, x_dst, e)
    if aggregate is not None:
        agg = aggregate(graph, messages, layout)
    else:
        agg = gather_scatter(graph, messages, ops=ops, layout=layout)
    out = gamma(x, agg)
    return torch.where(graph.node_mask[:, None], out, torch.zeros_like(out))


def pna_scalers(degree: torch.Tensor, avg_degree: float) -> torch.Tensor:
    """(N_pad, 3) PNA scalers [1, amplification, attenuation] from the
    plan's in-degree; ``avg_degree`` is the training set's mean degree (a
    model hyperparameter), taken in float32 as the JAX package does."""
    deg = degree.to(torch.float32)
    logd = torch.log(deg + 1.0)
    # made on the device by a fill, not copied from the host: a copy would
    # synchronise, which a CUDA-graph capture refuses
    log_davg = torch.log(torch.full((), avg_degree, dtype=torch.float32,
                                    device=deg.device) + 1.0)
    amp = logd / log_davg
    att = log_davg / torch.clamp(logd, min=1e-6)
    att = torch.where(deg > 0, att, torch.zeros_like(att))
    return torch.stack([torch.ones_like(logd), amp, att], dim=-1)


def pna_aggregate(graph: Graph, messages: torch.Tensor, avg_degree: float,
                  layout: Optional[LY.GraphLayout] = None) -> torch.Tensor:
    """PNA's A(.): 4 aggregators x 3 degree scalers -> (N_pad, 12 F).  With
    a plan the four reductions share one permuted message stream and the
    scalers come off the plan (``pna_scalers``, else its in-degree); without
    one each reduction sorts privately and the scalers come from the
    graph's in-degree (the same integers, so the same bits)."""
    agg = gather_scatter(graph, messages, ops=("mean", "std", "max", "min"),
                         layout=layout)
    n, f4 = agg.shape
    if layout is not None and layout.pna_scalers is not None:
        scalers = layout.pna_scalers
    else:
        degree = layout.in_degree if layout is not None else in_degree(graph)
        scalers = pna_scalers(degree, avg_degree)
    out = agg[:, None, :] * scalers[:, :, None]  # (N, 3, 4F)
    return out.reshape(n, 3 * f4)


def gat_attention(
    graph: Graph,
    logits: torch.Tensor,
    xp: torch.Tensor,
    layout: Optional[LY.GraphLayout] = None,
    mode: str = "auto",
) -> torch.Tensor:
    """GAT's A(.): per-destination softmax, then the attention-weighted sum.

    ``logits`` (E_pad, H) in COO order; ``xp`` (N_pad, H, F) per-head
    features of the sources (on a shard every rank's rows,
    :func:`source_rows`); returns (N_pad, H * F) for the graph's rows.
    The softmax normaliser couples all of
    a destination's edges before any message folds in, so GAT does not
    lower to ``fused_mp``: its two segment kernels run over the plan here,
    or, without one, over a plan sorted once in this call.  Padding edges
    get weight 0, so their messages are 0 (and past ``offsets[N]``, where
    the kernel never reads).
    """
    n = graph.num_nodes
    perm, ids_sorted, offsets, src_sorted = LY.csr_plan(layout, graph)
    alpha = kops.edge_softmax(logits, ids_sorted, offsets, n, mode=mode,
                              perm=perm)  # (E, H) sorted
    msg = xp[src_sorted.long()] * alpha[:, :, None]
    h_f = xp.shape[1] * xp.shape[2]
    return kops.segment_reduce(msg.reshape(-1, h_f), ids_sorted, offsets, n,
                               op="sum", mode=mode)


def dgn_directional_weights(graph: Graph, eigvec: torch.Tensor,
                            layout: Optional[LY.GraphLayout] = None):
    """-> (w_e (E,), denom (N,), wsum (N,)): DGN's directional weights
    w_ij = (phi_j - phi_i) / sum_k |phi_k - phi_i| per in-edge (COO order),
    their per-destination |dphi| normaliser and sum of weights.  The plan
    caches them (``core.layout.with_dgn_weights``); without one both sums
    sort privately, bit for bit the cached values.  On a shard ``eigvec``
    holds the rank's rows and the sources' entries are all-gathered."""
    src, dst = graph.src.long(), graph.dst.long()
    dphi = source_rows(graph, eigvec)[src] - eigvec[dst]
    dphi = torch.where(graph.edge_mask, dphi, torch.zeros_like(dphi))
    denom = gather_scatter(graph, torch.abs(dphi)[:, None], layout=layout)[:, 0]
    w_e = dphi / torch.clamp(denom[dst], min=1e-6)
    wsum = gather_scatter(graph, w_e[:, None], layout=layout)[:, 0]
    return w_e, denom, wsum


def dgn_aggregate(graph: Graph, messages: torch.Tensor, w_e: torch.Tensor,
                  layout: Optional[LY.GraphLayout] = None) -> torch.Tensor:
    """DGN's A(.): [mean, w-weighted sum] -> (N_pad, 2 F); ``w_e`` is the
    (E,) COO-order directional weight vector."""
    mean_agg = gather_scatter(graph, messages, ops=("mean",), layout=layout)
    wx = gather_scatter(graph, messages * w_e[:, None], ops=("sum",),
                        layout=layout)
    return torch.cat([mean_agg, wx], dim=-1)


def global_pool(
    graph: Graph,
    x: torch.Tensor,
    op: str = "mean",
    num_graphs: int | None = None,
) -> torch.Tensor:
    """Pool node embeddings per graph id -> (num_graphs, F).  Padded nodes
    get id ``num_graphs`` and land in the dropped sink row.  On a shard
    ("sum" and "mean") each rank reduces its rows and one all-reduce of
    the sums (and counts) completes the pool on every rank."""
    m = graph.num_nodes if num_graphs is None else num_graphs
    gid = torch.where(graph.node_mask, graph.graph_id,
                      torch.full_like(graph.graph_id, m))
    xm = torch.where(graph.node_mask[:, None], x, torch.zeros_like(x))
    if graph.shard is None:
        return sg.segment_reduce(xm, gid, m, op)
    if op == "sum":
        return graph.shard.sum(sg.segment_sum(xm, gid, m))
    if op != "mean":
        raise ValueError(f"sharded global_pool takes sum and mean, not {op!r}")
    ones = torch.ones_like(xm[:, :1])
    both = graph.shard.sum(sg.segment_sum(torch.cat([xm, ones], dim=-1), gid, m))
    return both[:, :-1] / torch.clamp(both[:, -1:], min=1.0)


@dataclasses.dataclass(frozen=True)
class OwnedEdges:
    """A rank's window of the plan, as long as the plan (E_pad, known when
    the bucket is prepared): ``index`` (E_pad,) int64 plan positions from
    the rank's start ``offsets[row0]`` on (a device value, clamped to the
    plan), ``owned`` (E_pad,) bool, true on the first ``offsets[-1]``
    slots: the rank's destinations' in-edges, in plan order (the plan
    sorts masked edges past every node); ``offsets`` (n_local + 1,) int32
    CSR ranges relative to the window."""

    index: torch.Tensor
    owned: torch.Tensor
    offsets: torch.Tensor


def owned_edges(layout: LY.GraphLayout, shard) -> OwnedEdges:
    """The plan range of ``shard``'s destinations, ``offsets[row0]`` to
    ``offsets[row0 + n_local]``, as a window of the plan's own length that
    starts there.  Nothing is read back to the host, so a sharded forward
    can be captured; the window costs each rank E_pad edge slots where it
    owns about E / P edges, the slots past its last owned edge masked."""
    n0, nl = shard.row0, shard.n_local
    bounds = layout.offsets[n0:n0 + nl + 1]
    w = layout.ids_sorted.shape[0]
    pos = bounds[0].long() + torch.arange(w, device=bounds.device)
    return OwnedEdges(index=pos.clamp(max=w - 1), owned=pos < bounds[-1],
                      offsets=(bounds - bounds[0]).to(torch.int32))


def shard_graph(graph: Graph, layout: LY.GraphLayout, edges: OwnedEdges,
                shard) -> Graph:
    """The rank's graph: its node rows, and its destinations' in-edges in
    plan order (sources global, destinations rank-local), then the
    window's masked slots: false ``edge_mask``, pointing at the rank's last
    row as the padding edges of a graph point at its last padded node."""
    dst = torch.where(edges.owned, layout.ids_sorted[edges.index] - shard.row0,
                      shard.n_local - 1)
    src = layout.src_sorted[edges.index]
    perm = layout.perm[edges.index].long()
    return dataclasses.replace(
        graph,
        node_feat=shard.rows(graph.node_feat),
        edge_index=torch.stack([src, dst.to(src.dtype)]),
        edge_feat=graph.edge_feat[perm],
        node_mask=shard.rows(graph.node_mask),
        edge_mask=edges.owned,
        graph_id=shard.rows(graph.graph_id),
        shard=shard,
    )


def shard_layout(layout: LY.GraphLayout, edges: OwnedEdges, shard) -> LY.GraphLayout:
    """The rank's plan over :func:`shard_graph`'s edges, which are already
    in plan order (``perm`` the identity); the masked slots carry the
    out-of-range destination ``n_local`` (as the plan's masked edges carry
    ``N_pad``), which the segment reductions drop, and lie past
    ``offsets[-1]``, which the CSR kernels never walk."""
    return LY.GraphLayout(
        perm=torch.arange(edges.index.shape[0], dtype=torch.int32,
                          device=edges.index.device),
        ids_sorted=torch.where(edges.owned, layout.ids_sorted[edges.index] - shard.row0,
                               shard.n_local).to(layout.ids_sorted.dtype),
        offsets=edges.offsets,
        src_sorted=layout.src_sorted[edges.index],
        in_degree=shard.rows(layout.in_degree),
    )


def shard_inputs(graph: Graph, eigvec: Optional[torch.Tensor],
                 layout: Optional[LY.GraphLayout], shard):
    """-> (graph, eigvec, layout) of ``shard``'s rank; without a plan
    (the per-call-sort path) one is built for the ownership and None is
    returned in its place."""
    plan = LY.build_layout(graph) if layout is None else layout
    edges = owned_edges(plan, shard)
    local = shard_graph(graph, plan, edges, shard)
    eig = None if eigvec is None else shard.rows(eigvec)
    return local, eig, (None if layout is None else shard_layout(plan, edges, shard))

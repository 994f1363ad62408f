"""The shared graph-layout plan: one sort per graph, reused everywhere.

PyTorch port of ``repro.core.layout``.  ``GraphLayout`` holds the
destination-ordered edge plan every layer consumes:

  * ``perm``        (E_pad,) int32 — stable argsort of the masked
                    destination ids (padding edges carry key ``N_pad``);
  * ``ids_sorted``  (E_pad,) int32 — destination ids in sorted order,
                    padding rows hold ``N_pad`` (out of range);
  * ``offsets``     (N_pad+1,) int32 — per-destination row offsets: the
                    CSR ranges the ``fused_mp`` CUDA kernel walks;
  * ``src_sorted``  (E_pad,) int32 — source ids in sorted-edge order;
  * ``in_degree``   (N_pad,) int32 — real-edge in-degree;

plus the lazily attached model-static derivatives: GCN's ``gcn_inv_sqrt``,
PNA's ``pna_scalers`` and DGN's ``dgn_w_e`` / ``dgn_denom`` / ``dgn_wsum``
(directional weights from the eigenvector input, computed once per forward
instead of once per layer).  All plan arrays stay int32
with the same values as the JAX plan; indexing ops convert to int64 where
they need it.  ``build_layout`` sorts on the graph's device;
``host_layout`` is its numpy twin, run at pack time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core import scatter_gather as sg

@dataclasses.dataclass(frozen=True)
class GraphLayout:
    """Destination-ordered edge plan for one (possibly packed) ``Graph``."""

    perm: torch.Tensor
    ids_sorted: torch.Tensor
    offsets: torch.Tensor
    src_sorted: torch.Tensor
    in_degree: torch.Tensor
    gcn_inv_sqrt: Optional[torch.Tensor] = None  # (N_pad,) f32
    pna_scalers: Optional[torch.Tensor] = None  # (N_pad, 3) f32
    dgn_w_e: Optional[torch.Tensor] = None  # (E_pad,) f32, COO order
    dgn_denom: Optional[torch.Tensor] = None  # (N_pad,) f32 |dphi| in-sums
    dgn_wsum: Optional[torch.Tensor] = None  # (N_pad,) f32 per-dst sum of w_e

    @property
    def num_nodes(self) -> int:
        return self.in_degree.shape[0]

    @property
    def num_edges(self) -> int:
        return self.perm.shape[0]


def build_layout(graph: G.Graph) -> GraphLayout:
    """Plan construction on the graph's device: the single stable sort."""
    n = graph.num_nodes
    dst = torch.where(graph.edge_mask, graph.dst, torch.full_like(graph.dst, n))
    perm, ids_sorted, offsets = sg.sort_by_segment(dst, n)
    return GraphLayout(
        perm=perm,
        ids_sorted=ids_sorted,
        offsets=offsets,
        src_sorted=graph.src[perm.long()],
        in_degree=G.in_degree(graph),
    )


def host_layout(graph: G.Graph) -> GraphLayout:
    """Numpy twin of :func:`build_layout` (``kind="stable"`` argsort over
    the same int32 keys gives the same permutation); the plan's tensors
    land on the graph's device."""
    n = graph.num_nodes
    edge_mask = graph.edge_mask.cpu().numpy()
    dst_raw = graph.dst.cpu().numpy()
    dst = np.where(edge_mask, dst_raw, n).astype(np.int32)
    src = graph.src.cpu().numpy().astype(np.int32)
    perm = np.argsort(dst, kind="stable").astype(np.int32)
    ids_sorted = dst[perm]
    offsets = np.searchsorted(
        ids_sorted, np.arange(n + 1, dtype=np.int32), side="left"
    ).astype(np.int32)
    deg = np.zeros((n,), np.int32)
    np.add.at(deg, dst_raw[edge_mask], 1)
    dev = graph.device
    as_t = lambda a: torch.from_numpy(a).to(dev)
    return GraphLayout(
        perm=as_t(perm),
        ids_sorted=as_t(ids_sorted),
        offsets=as_t(offsets),
        src_sorted=as_t(src[perm]),
        in_degree=as_t(deg),
    )


def ensure_layout(layout: Optional[GraphLayout], graph: G.Graph) -> GraphLayout:
    """Return ``layout`` if supplied (0 sorts) else build it (1 sort)."""
    return build_layout(graph) if layout is None else layout


def csr_plan(
    layout: Optional[GraphLayout], graph: G.Graph
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(perm, ids_sorted, offsets, src_sorted) — from the plan, or freshly
    sorted (one sort: the per-call-sort path).  ``offsets`` are the CSR
    ranges the segment kernels walk."""
    if layout is not None:
        return layout.perm, layout.ids_sorted, layout.offsets, layout.src_sorted
    n = graph.num_nodes
    dst = torch.where(graph.edge_mask, graph.dst, torch.full_like(graph.dst, n))
    perm, ids_sorted, offsets = sg.sort_by_segment(dst, n)
    return perm, ids_sorted, offsets, graph.src[perm.long()]


def edge_plan(
    layout: Optional[GraphLayout], graph: G.Graph
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(perm, ids_sorted, src_sorted) — from the plan, or freshly sorted
    (JAX's three-value contract; :func:`csr_plan` adds the offsets)."""
    perm, ids_sorted, _, src_sorted = csr_plan(layout, graph)
    return perm, ids_sorted, src_sorted


def segment_reduce(
    layout: GraphLayout,
    values: torch.Tensor,
    op: str = "sum",
    presorted: bool = False,
) -> torch.Tensor:
    """Reduce per-edge ``values`` (COO order, or plan order when
    ``presorted``) into per-destination rows; padding ids are dropped."""
    vals = values if presorted else values[layout.perm.long()]
    return sg.segment_reduce(vals, layout.ids_sorted, layout.num_nodes, op)


def with_gcn_norms(layout: GraphLayout) -> GraphLayout:
    """Attach GCN's symmetric norm 1/sqrt(d_in + 1) (self-loop folded in)."""
    if layout.gcn_inv_sqrt is not None:
        return layout
    deg = layout.in_degree.to(torch.float32) + 1.0
    return dataclasses.replace(layout, gcn_inv_sqrt=torch.rsqrt(deg))


def with_pna_scalers(layout: GraphLayout, avg_degree: float) -> GraphLayout:
    """Attach PNA's (N, 3) [identity, amplification, attenuation] scalers."""
    if layout.pna_scalers is not None:
        return layout
    from repro_torch.core import message_passing as mp

    scalers = mp.pna_scalers(layout.in_degree, avg_degree)
    return dataclasses.replace(layout, pna_scalers=scalers)


def with_dgn_weights(
    layout: GraphLayout, graph: G.Graph, eigvec: torch.Tensor
) -> GraphLayout:
    """Attach DGN's directional weights, computed once from the eigenvector
    (``message_passing.dgn_directional_weights``)."""
    if layout.dgn_w_e is not None:
        return layout
    from repro_torch.core import message_passing as mp

    w_e, denom, wsum = mp.dgn_directional_weights(graph, eigvec, layout)
    return dataclasses.replace(layout, dgn_w_e=w_e, dgn_denom=denom,
                               dgn_wsum=wsum)


def for_model(
    layout: Optional[GraphLayout],
    graph: G.Graph,
    model: str,
    avg_degree: float = 1.0,
    eigvec: Optional[torch.Tensor] = None,
) -> GraphLayout:
    """Ensure the plan exists and carries ``model``'s static derivatives
    (at most one sort; none when ``layout`` was supplied).  DGN needs its
    eigenvector input."""
    layout = ensure_layout(layout, graph)
    if model == "gcn":
        layout = with_gcn_norms(layout)
    elif model == "pna":
        layout = with_pna_scalers(layout, avg_degree)
    elif model == "dgn":
        if eigvec is None and layout.dgn_w_e is None:
            raise ValueError(
                "dgn needs its Laplacian eigenvector input: pass eigvec= "
                "(serving: with_eigvec=True or infer_packed(eigvec=...))"
            )
        layout = with_dgn_weights(layout, graph, eigvec)
    return layout

"""Graph data representation (paper §3.2), PyTorch port of ``repro.core.graph``.

Graphs arrive as raw COO edge lists and are padded to bucketed
(N_pad, E_pad) capacities.  ``node_mask`` / ``edge_mask`` mark the real
entries; padding edges point at the last padded node (``n_pad - 1``) so
they never reach a real aggregate, and padded nodes of a batch carry
``graph_id == n_graphs`` (out of range for pooling).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import scatter_gather as sg


@dataclasses.dataclass(frozen=True)
class Graph:
    """A (possibly batched, padded) graph in COO form.

    Attributes:
      node_feat:  (N_pad, F) float32 node features.
      edge_index: (2, E_pad) int32; row 0 = src, row 1 = dst.
      edge_feat:  (E_pad, D) float32 edge features.
      node_mask:  (N_pad,) bool, True for real nodes.
      edge_mask:  (E_pad,) bool, True for real edges.
      graph_id:   (N_pad,) int32 graph membership for batched pooling.
      n_graph:    () int32 number of real graphs in the batch.
      shard:      None for a whole graph; on one rank of a mesh, the
                  ``runtime.partitioning.RowShard`` whose node rows this
                  graph holds (``core.message_passing.shard_inputs``): its
                  edges are those rows' in-edges, their sources global
                  node ids.
    """

    node_feat: torch.Tensor
    edge_index: torch.Tensor
    edge_feat: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    graph_id: torch.Tensor
    n_graph: torch.Tensor
    shard: Optional[object] = dataclasses.field(default=None, compare=False)

    @property
    def num_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_index.shape[1]

    @property
    def src(self) -> torch.Tensor:
        return self.edge_index[0]

    @property
    def dst(self) -> torch.Tensor:
        return self.edge_index[1]

    @property
    def device(self) -> torch.device:
        return self.node_feat.device


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Adjacency in compressed form, produced on the device from COO.

    ``order="csr"``: edges sorted by src (out-edges contiguous per node),
    the layout of the paper's merged scatter-gather (§3.4).
    ``order="csc"``: edges sorted by dst (in-edges contiguous), the layout
    of the gather-only variant.  ``perm`` maps a sorted edge's position to
    its COO position, so edge features can be gathered lazily.
    """

    offsets: torch.Tensor  # (N_pad + 1,) int32 row offsets
    perm: torch.Tensor  # (E_pad,) int32 permutation into the COO arrays
    src_sorted: torch.Tensor  # (E_pad,) int32
    dst_sorted: torch.Tensor  # (E_pad,) int32
    degree: torch.Tensor  # (N_pad,) int32 out-degree (csr) / in-degree (csc)


def coo_to_compressed(graph: Graph, order: str = "csr") -> CSRGraph:
    """COO -> CSR / CSC on the graph's device (the paper's on-chip
    converter), once a streamed graph; every layer reuses the result.

    A stable sort keeps the edge order deterministic; padding edges carry
    key ``N_pad`` and so sort to the end."""
    if order not in ("csr", "csc"):
        raise ValueError(f"order must be 'csr' or 'csc', got {order!r}")
    n_pad = graph.num_nodes
    key_row = 0 if order == "csr" else 1
    perm, _, offsets = sg.sort_by_segment(graph.edge_index[key_row], n_pad,
                                          valid=graph.edge_mask)
    idx = perm.long()
    return CSRGraph(
        offsets=offsets,
        perm=perm,
        src_sorted=graph.edge_index[0][idx],
        dst_sorted=graph.edge_index[1][idx],
        degree=(offsets[1:] - offsets[:-1]).to(torch.int32),
    )


def in_degree(graph: Graph) -> torch.Tensor:
    """(N_pad,) int32 in-degree over real edges."""
    ones = graph.edge_mask.to(torch.int32)
    return sg.segment_sum(ones, graph.dst, graph.num_nodes)


def out_degree(graph: Graph) -> torch.Tensor:
    """(N_pad,) int32 out-degree over real edges."""
    ones = graph.edge_mask.to(torch.int32)
    return sg.segment_sum(ones, graph.src, graph.num_nodes)


def _to_graph(nf, ei, ef, node_mask, edge_mask, gid, n_graph, device) -> Graph:
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Graph(
        node_feat=as_t(nf),
        edge_index=as_t(ei),
        edge_feat=as_t(ef),
        node_mask=as_t(node_mask),
        edge_mask=as_t(edge_mask),
        graph_id=as_t(gid),
        n_graph=torch.tensor(n_graph, dtype=torch.int32, device=device),
    )


# ``jnp.asarray``'s dtypes with x64 off (the JAX package's setting): 64-bit
# node features narrow to 32 bits, every other dtype stays as it is
_X32 = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
        np.dtype(np.uint64): np.uint32}


def from_numpy(
    senders: np.ndarray,
    receivers: np.ndarray,
    node_feat: np.ndarray,
    edge_feat: Optional[np.ndarray] = None,
    n_pad: Optional[int] = None,
    e_pad: Optional[int] = None,
    device="cpu",
) -> Graph:
    """Build a single padded ``Graph`` from raw COO numpy arrays."""
    n = node_feat.shape[0]
    e = senders.shape[0]
    n_pad = n_pad or n
    e_pad = e_pad or e
    if n_pad < n or e_pad < e:
        raise ValueError(f"padding too small: ({n_pad},{e_pad}) < ({n},{e})")
    f = node_feat.shape[1]
    d = 0 if edge_feat is None else edge_feat.shape[1]
    nf = np.zeros((n_pad, f), dtype=_X32.get(node_feat.dtype, node_feat.dtype))
    nf[:n] = node_feat
    ef = np.zeros((e_pad, max(d, 1)), dtype=np.float32)
    if edge_feat is not None:
        ef[:e, :d] = edge_feat
    ei = np.full((2, e_pad), n_pad - 1 if n_pad > n else 0, dtype=np.int32)
    ei[0, :e] = senders
    ei[1, :e] = receivers
    node_mask = np.arange(n_pad) < n
    edge_mask = np.arange(e_pad) < e
    gid = np.zeros((n_pad,), np.int32)
    return _to_graph(nf, ei, ef, node_mask, edge_mask, gid, 1, device)


def batch_graphs(graphs: list, n_pad: int, e_pad: int, device="cpu") -> Graph:
    """Pack a list of small host graphs ``(s, r, nf, ef)`` into one padded
    batch.  Node ids are shifted per graph; padding edges point at the
    final padded node, which belongs to no real graph."""
    nfs, eis, efs, gids = [], [], [], []
    offset = 0
    for gi, g in enumerate(graphs):
        s, r, nf, ef = g
        nfs.append(nf)
        eis.append(np.stack([s + offset, r + offset]))
        efs.append(ef if ef is not None else np.zeros((len(s), 1), np.float32))
        gids.append(np.full((nf.shape[0],), gi, np.int32))
        offset += nf.shape[0]
    n = offset
    e = sum(x.shape[1] for x in eis)
    if n_pad < n or e_pad < e:
        raise ValueError(f"padding too small: ({n_pad},{e_pad}) < ({n},{e})")
    f = nfs[0].shape[1]
    d = efs[0].shape[1]
    nf = np.zeros((n_pad, f), np.float32)
    nf[:n] = np.concatenate(nfs)
    ei = np.full((2, e_pad), n_pad - 1, np.int32)
    ei[:, :e] = np.concatenate(eis, axis=1)
    ef = np.zeros((e_pad, d), np.float32)
    ef[:e] = np.concatenate(efs)
    gid = np.full((n_pad,), len(graphs), np.int32)  # padding -> out-of-range id
    gid[:n] = np.concatenate(gids)
    return _to_graph(nf, ei, ef, np.arange(n_pad) < n, np.arange(e_pad) < e,
                     gid, len(graphs), device)

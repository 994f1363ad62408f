"""Multi-graph packing: many small graphs -> one padded ``Graph``
(numpy port of ``repro.core.batching``).

A ``BucketBudget`` is the static capacity of one packed batch:
``(N_pad, E_pad, G_pad)``.  ``pack_graphs`` concatenates raw COO graphs
against a budget and returns the padded ``Graph`` plus a ``PackMeta`` that
makes unpacking exact; ``pack_prepared`` adds the eigenvectors and the
layout plan and stages the batch for the executor.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.core import layout as LY

RawGraph = tuple  # (senders, receivers, node_feat[, edge_feat])


@dataclasses.dataclass(frozen=True, order=True)
class BucketBudget:
    """Static capacity of one packed batch."""

    n_pad: int  # total padded node rows
    e_pad: int  # total padded edge rows
    g_pad: int  # graph slots (sizes the pooled buffer)

    def admits(self, n_used: int, e_used: int, g_used: int,
               n: int, e: int) -> bool:
        """Would a graph of (n nodes, e edges) still fit?"""
        return (
            g_used + 1 <= self.g_pad
            and n_used + n <= self.n_pad
            and e_used + e <= self.e_pad
        )


@dataclasses.dataclass(frozen=True)
class PackMeta:
    """Exact bookkeeping for unpacking a packed batch."""

    budget: BucketBudget
    node_counts: Tuple[int, ...]
    edge_counts: Tuple[int, ...]

    @property
    def num_graphs(self) -> int:
        return len(self.node_counts)

    @property
    def node_offsets(self) -> Tuple[int, ...]:
        return tuple(np.concatenate([[0], np.cumsum(self.node_counts)]))


def graph_sizes(raw: RawGraph) -> Tuple[int, int]:
    """(num_nodes, num_edges) of a raw COO tuple."""
    s, nf = raw[0], raw[2]
    return nf.shape[0], s.shape[0]


def pack_graphs(graphs: Sequence[RawGraph], budget: BucketBudget,
                device="cpu") -> Tuple[G.Graph, PackMeta]:
    """Concatenate raw graphs into one padded ``Graph`` against ``budget``."""
    if not graphs:
        raise ValueError("pack_graphs needs at least one graph")
    sizes = [graph_sizes(g) for g in graphs]
    n_tot = sum(n for n, _ in sizes)
    e_tot = sum(e for _, e in sizes)
    if len(graphs) > budget.g_pad or n_tot > budget.n_pad or e_tot > budget.e_pad:
        raise ValueError(
            f"pack of {len(graphs)} graphs ({n_tot} nodes, {e_tot} edges) "
            f"exceeds budget {budget}"
        )
    gs = [(g[0], g[1], g[2], g[3] if len(g) > 3 else None) for g in graphs]
    packed = G.batch_graphs(gs, n_pad=budget.n_pad, e_pad=budget.e_pad,
                            device=device)
    meta = PackMeta(
        budget=budget,
        node_counts=tuple(n for n, _ in sizes),
        edge_counts=tuple(e for _, e in sizes),
    )
    return packed, meta


def pack_layout(packed: G.Graph) -> LY.GraphLayout:
    """The packed batch's ``GraphLayout`` plan, built on the host at pack
    time so the forward itself runs no sort."""
    return LY.host_layout(packed)


def pack_prepared(
    graphs: Sequence[RawGraph],
    budget: BucketBudget,
    eigvecs: Optional[Sequence[np.ndarray]] = None,
    with_layout: bool = True,
    device="cpu",
    stage: bool = False,
):
    """Pack raw graphs and emit the whole pack-time payload as one
    ``serve.executor.PreparedBatch``: padded graph, packed eigenvectors,
    host-built ``GraphLayout`` plan, bucket key and warm signature; returns
    ``(prepared, meta)``.  This is the packed mode's prepare stage: the
    flushed program receives everything ready-made and runs no sort.

    Everything is built on the host first (the plan from the host arrays,
    so no device-to-host copy waits behind runs in flight), then the batch
    is made ready for ``device`` at once (``serve.executor.staged``): on a
    card its tensors are pinned, and ``Executor.run_async`` copies them
    into its graph's static buffers without blocking (one host-to-device
    copy a leaf).  ``stage=True`` also copies them to the card here, on the
    current stream, as JAX's ``stage`` does with ``jax.device_put``; the
    replay then copies them once more, device to device."""
    from repro_torch.serve import executor as X  # deferred: serve imports core

    packed, meta = pack_graphs(graphs, budget)
    eig = None
    if eigvecs is not None:
        eig = torch.from_numpy(pack_eigvecs(eigvecs, meta))
    layout = pack_layout(packed) if with_layout else None
    prep = X.prepared(
        packed, eig, layout,
        ("packed", budget.n_pad, budget.e_pad, budget.g_pad), budget.g_pad,
    )
    return X.staged(prep, device, copy=stage), meta


def pack_eigvecs(eigvecs: Sequence[np.ndarray], meta: PackMeta) -> np.ndarray:
    """Concatenate per-graph node vectors (DGN's Laplacian eigenvectors)
    into the packed (N_pad,) layout; padding rows are zero."""
    out = np.zeros((meta.budget.n_pad,), np.float32)
    off = 0
    for vec, n in zip(eigvecs, meta.node_counts):
        out[off : off + n] = np.asarray(vec, np.float32)[:n]
        off += n
    return out


def unpack_outputs(outputs: np.ndarray, meta: PackMeta,
                   level: str = "graph") -> List[np.ndarray]:
    """Exact inverse of packing: one array per real graph (``graph``:
    slot i of (G_pad, F); ``node``: node-offset slices of (N_pad, F))."""
    outputs = np.asarray(outputs)
    if level == "graph":
        return [outputs[i : i + 1] for i in range(meta.num_graphs)]
    if level == "node":
        offs = meta.node_offsets
        return [outputs[offs[i] : offs[i + 1]] for i in range(meta.num_graphs)]
    raise ValueError(f"unknown level {level!r}; expected 'graph' or 'node'")

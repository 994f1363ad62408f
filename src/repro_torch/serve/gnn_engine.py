"""GNN serving engine — the single-tenant facade over ``serve.executor``
(port of ``repro.serve.gnn_engine``).

  * ``infer_stream``  — batch-size-1, per-graph latency (paper Fig. 7)
  * ``infer_batched`` — fixed-size padded batching
  * ``infer_packed``  — one already-packed multi-graph batch

Runs on ``device="cuda"`` unless the caller passes ``device="cpu"``;
raises if CUDA is missing.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.gnn import models as M
from repro_torch.serve.executor import DEFAULT_BUCKETS, Executor

__all__ = ["GNNEngine", "DEFAULT_BUCKETS"]


class GNNEngine:
    def __init__(
        self,
        cfg: M.GNNConfig,
        params: dict,
        buckets: Sequence[tuple] = DEFAULT_BUCKETS,
        precision: str = "fp32",
        calib_graphs: Optional[Sequence[tuple]] = None,
        fused: bool = False,
        device="cuda",
    ):
        """``precision``: "fp32" (default), "int8" (W8A8, dynamic per-node
        activation scales, no calibration), "int8-static" (calibrated
        per-tensor scales; needs ``calib_graphs``, a few raw COO tuples)
        or "fixed" (ap_fixed<W,I> emulation).  ``fused`` runs every GCN / GIN / PNA / DGN layer as one
        ``fused_mp`` pass (GAT, int8-static and fixed layers keep the
        unfused path)."""
        self.executor = Executor(buckets=buckets, device=device)
        self._tenant = self.executor.register(
            "default", cfg, params, precision=precision,
            calib_graphs=calib_graphs, fused=fused,
        )
        self.cfg = cfg

    @property
    def device(self):
        return self.executor.device

    @property
    def precision(self) -> str:
        return self._tenant.precision

    @property
    def quant_report(self):
        """``quant.apply.QuantReport`` of the transform, None for fp32."""
        return self._tenant.quant_report

    @property
    def warm_seconds(self) -> float:
        return self.executor.warm_seconds

    def infer_stream(self, graphs: Iterable[tuple], with_eigvec: bool = False):
        """graphs: raw (senders, receivers, node_feat, edge_feat[, label])
        tuples; ``with_eigvec`` computes DGN's eigenvector input per graph
        (in prepare, outside the timed region).  Returns (outputs,
        per-graph latencies in seconds, untimed warm seconds)."""
        ex = self.executor
        outs: List[np.ndarray] = []
        lats: List[float] = []
        warm_before = ex.warm_seconds
        for graph in graphs:
            out, dt = ex.run(ex.prepare_stream(graph, with_eigvec=with_eigvec))
            lats.append(dt)
            outs.append(out[:1])
        return outs, np.asarray(lats), ex.warm_seconds - warm_before

    def infer_batched(self, graphs: Sequence[tuple], batch_size: int,
                      n_pad: int, e_pad: int, with_eigvec: bool = False):
        """Padded-batch mode.  Returns (outputs (n_graphs, out), seconds/graph)."""
        ex = self.executor
        outs = []
        total = 0.0
        for i in range(0, len(graphs), batch_size):
            chunk = graphs[i : i + batch_size]
            out, dt = ex.run(ex.prepare_batched(chunk, batch_size, n_pad, e_pad,
                                                with_eigvec=with_eigvec))
            total += dt
            outs.append(out[: len(chunk)])
        return np.concatenate(outs), total / len(graphs)

    def infer_packed(self, packed, budget, eigvec=None, layout=None):
        """Run one packed batch (``core.batching.pack_graphs`` on this
        engine's device); DGN takes its packed eigenvector
        (``core.batching.pack_eigvecs``).  Returns (outputs (G_pad, out),
        seconds)."""
        ex = self.executor
        return ex.run(ex.prepare_packed(packed, budget, eigvec=eigvec,
                                        layout=layout))

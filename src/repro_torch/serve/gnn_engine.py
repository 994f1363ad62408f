"""GNN serving engine — the single-tenant facade over ``serve.executor``
(port of ``repro.serve.gnn_engine``).

  * ``infer_stream``  — batch-size-1, per-graph latency (paper Fig. 7)
  * ``infer_batched`` — fixed-size padded batching
  * ``infer_packed``  — one already-packed multi-graph batch

The facade holds no program cache, warm or timing logic of its own: every
mode prepares its input through the executor's ``prepare_*`` family and
runs it through the executor's one warm-before-timing path.  By default
it owns a fresh single-tenant executor on ``device`` ("cuda" unless the
caller passes "cpu"; raises if CUDA is missing); ``executor=`` attaches it
as tenant ``name`` on an existing one instead.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.gnn import models as M
from repro_torch.serve.executor import DEFAULT_BUCKETS, Executor, _CompiledBucket

__all__ = ["GNNEngine", "DEFAULT_BUCKETS"]


class GNNEngine:
    def __init__(
        self,
        cfg: M.GNNConfig,
        params: dict,
        buckets: Sequence[tuple] = DEFAULT_BUCKETS,
        mesh=None,
        rules: Optional[dict] = None,
        precision: str = "fp32",
        calib_graphs: Optional[Sequence[tuple]] = None,
        share_layout: bool = True,
        fused: bool = False,
        device=None,
        executor: Optional[Executor] = None,
        name: str = "default",
        aot_cache=None,
    ):
        """``precision``: "fp32" (default), "int8" (W8A8, dynamic per-node
        activation scales), "int8-static" (calibrated per-tensor scales;
        needs ``calib_graphs``, a few raw COO tuples) or "fixed"
        (ap_fixed<W,I> emulation).

        ``share_layout`` (default on) threads one ``GraphLayout`` plan per
        forward through every layer; off, the per-call-sort path, kept for
        the parity tests and the sort-count A/B.  ``fused`` runs every GCN /
        GIN / PNA / DGN layer as one ``fused_mp`` pass over the plan (GAT,
        int8-static and fixed layers, and every layer without a plan, keep
        the unfused path).

        ``executor`` registers this engine as tenant ``name`` on an
        existing :class:`Executor`, sharing its bucket ladder and program
        cache; ``buckets``, ``device``, ``aot_cache`` (a
        ``serve.aot.AOTCache`` of the kernel libraries), ``mesh`` and
        ``rules`` belong to the executor, so passing them beside
        ``executor`` raises rather than being ignored.  Without one the
        engine builds its own on ``device`` (default "cuda").

        ``mesh`` (a ``runtime.Mesh``; each rank builds its engine and
        serves the same graphs) shards every forward's node rows over the
        mesh by ``rules`` (default ``runtime.gnn_rules(mesh)``); every
        rank gets the whole batch's outputs (``serve.executor``)."""
        if executor is not None and (
                tuple(buckets) != tuple(DEFAULT_BUCKETS) or device is not None
                or aot_cache is not None or mesh is not None
                or rules is not None):
            raise ValueError(
                "buckets/device/aot_cache/mesh/rules belong to the executor: "
                "configure them on the Executor you pass, not on the facade"
            )
        self.executor = executor or Executor(
            buckets=buckets, device="cuda" if device is None else device,
            aot_cache=aot_cache, mesh=mesh, rules=rules)
        self._tenant = self.executor.register(
            name, cfg, params, precision=precision,
            calib_graphs=calib_graphs, share_layout=share_layout, fused=fused,
        )
        self.cfg = cfg

    # ---------------------------------------------------------- plumbing
    # (views only: the state lives on the executor)

    @property
    def name(self) -> str:
        return self._tenant.name

    @property
    def device(self):
        return self.executor.device

    @property
    def params(self) -> dict:
        """The tenant's params as served (on the executor's device,
        quantized for precisions other than fp32)."""
        return self._tenant.params

    @property
    def precision(self) -> str:
        return self._tenant.precision

    @property
    def share_layout(self) -> bool:
        """Whether forwards consume the shared plan (False: the
        per-call-sort path)."""
        return self._tenant.share_layout

    @property
    def fused(self) -> bool:
        return self._tenant.fused

    @property
    def buckets(self) -> Sequence[tuple]:
        """The executor's bucket ladder."""
        return self.executor.buckets

    @property
    def mesh(self):
        return self.executor.mesh

    @property
    def rules(self):
        return self.executor.rules

    @property
    def quant_report(self):
        """``quant.apply.QuantReport`` of the transform, None for fp32."""
        return self._tenant.quant_report

    @property
    def compile_seconds(self) -> float:
        """CUDA-graph capture seconds across this tenant's program records
        (0 on the CPU), excluded from every reported latency.  Filtered by
        program key, so two facades on one executor never see each other's
        cost unless they share an architecture, and with it the record."""
        return sum(cb.compile_s for cb in self._compiled.values())

    @property
    def warm_seconds(self) -> float:
        """Untimed warm seconds (eager forward with the kernels' build,
        first replay) across this tenant's program records."""
        return sum(cb.warm_s for cb in self._compiled.values())

    @property
    def _compiled(self) -> Dict[tuple, _CompiledBucket]:
        """This tenant's program records, keyed by bucket key."""
        pk = self._tenant.program_key
        return {
            bucket_key: cb
            for (prog_key, bucket_key, _ng), cb in self.executor._compiled.items()
            if prog_key == pk
        }

    # ------------------------------------------------------------- modes

    def infer_stream(self, graphs: Iterable[tuple], with_eigvec: bool = False):
        """graphs: raw (senders, receivers, node_feat, edge_feat[, label])
        tuples; ``with_eigvec`` computes DGN's eigenvector input per graph
        (in prepare, outside the timed region).  Returns (outputs,
        per-graph latencies in seconds, untimed compile + warm seconds)."""
        ex = self.executor
        outs: List[np.ndarray] = []
        lats: List[float] = []
        untimed_before = self.compile_seconds + self.warm_seconds
        for graph in graphs:
            p = ex.prepare_stream(graph, with_eigvec=with_eigvec)
            out, dt = ex.run(p, model=self.name)
            lats.append(dt)
            outs.append(out[:1])
        untimed = self.compile_seconds + self.warm_seconds - untimed_before
        return outs, np.asarray(lats), untimed

    def infer_batched(self, graphs: Sequence[tuple], batch_size: int,
                      n_pad: int, e_pad: int, with_eigvec: bool = False):
        """Padded-batch mode.  Returns (outputs (n_graphs, out), seconds/graph)."""
        ex = self.executor
        outs = []
        total = 0.0
        for i in range(0, len(graphs), batch_size):
            chunk = graphs[i : i + batch_size]
            p = ex.prepare_batched(chunk, batch_size, n_pad, e_pad,
                                   with_eigvec=with_eigvec)
            out, dt = ex.run(p, model=self.name)
            total += dt
            outs.append(out[: len(chunk)])
        return np.concatenate(outs), total / len(graphs)

    def infer_packed(self, packed, budget, eigvec=None, layout=None):
        """Run one packed batch (``core.batching.pack_graphs`` on this
        engine's device); DGN takes its packed eigenvector
        (``core.batching.pack_eigvecs``).  Every batch packed to one
        ``budget`` shares one program record.  Returns (outputs (G_pad,
        out), seconds)."""
        ex = self.executor
        return ex.run(ex.prepare_packed(packed, budget, eigvec=eigvec,
                                        layout=layout, model=self.name),
                      model=self.name)

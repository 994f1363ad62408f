"""Stand-ins for the port's five GNN kernel wrappers, for CPU tests of the
kernel branch of ``kernels/ops.py``.

Each stand-in takes its CUDA wrapper's arguments and returns the plain
version's output computed under ``torch.no_grad()``: a fresh tensor with
no history, as a ctypes launch returns.  The CSR ``offsets`` the kernels
walk are turned back into the sorted ids the plain versions read.
``forced_kernels(monkeypatch)`` installs them, and makes ``ops._resolve``
send every mode but ``reference`` to the kernel branch (the decision still
counted in a dispatch census of the test's own, ``kops.default_registry()``
while the patch holds: the process-wide one keeps no kernel decision a card
did not make); it returns the calls made, by wrapper.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.obs.metrics import MetricsRegistry


def ids_from_offsets(offsets: torch.Tensor, e: int) -> torch.Tensor:
    """(E,) sorted ids of a CSR plan: edge i lies in the segment whose
    range holds it; edges past ``offsets[-1]`` get the padding id N."""
    pos = torch.arange(e, dtype=torch.int32, device=offsets.device)
    return torch.searchsorted(offsets[1:].contiguous(), pos, right=True).to(torch.int32)


def forced_kernels(monkeypatch) -> collections.Counter:
    calls: collections.Counter = collections.Counter()

    def plain(name, fn):
        def stand_in(*a, **k):
            calls[name] += 1
            with torch.no_grad():
                return fn(*a, **k)
        return stand_in

    def segment_reduce(values, offsets, num_segments, op):
        ids = ids_from_offsets(offsets, values.shape[0])
        return kref.segment_reduce_sorted_ref(values, ids, num_segments, op)

    def edge_softmax(logits, offsets, num_segments):
        return kref.edge_softmax_ref(logits, ids_from_offsets(offsets, logits.shape[0]),
                                     num_segments)

    def fused_mp(spec, offsets, src_sorted, in_degree, node_mask, msrc, x_res, **kw):
        ids = ids_from_offsets(offsets, src_sorted.shape[0])
        return kref.fused_mp_ref(spec, ids, src_sorted, in_degree, node_mask, msrc,
                                 x_res, **kw)

    monkeypatch.setattr(kops._node_mlp_kernel, "node_mlp",
                        plain("node_mlp", kref.node_mlp_ref))
    monkeypatch.setattr(kops._segment_kernel, "segment_reduce",
                        plain("segment_reduce", segment_reduce))
    monkeypatch.setattr(kops._edge_softmax_kernel, "edge_softmax",
                        plain("edge_softmax", edge_softmax))
    monkeypatch.setattr(kops._quant_mlp_kernel, "quant_node_mlp",
                        plain("quant_node_mlp", kref.quant_node_mlp_ref))
    monkeypatch.setattr(kops._quant_mlp_kernel, "quant_node_mlp_dynamic",
                        plain("quant_node_mlp_dynamic", kref.quant_node_mlp_dynamic_ref))
    monkeypatch.setattr(kops._fused_mp_kernel, "fused_mp", plain("fused_mp", fused_mp))

    def resolve(op, mode, t):
        on_kernel = mode != "reference"
        kops._record_dispatch(op, on_kernel)
        return on_kernel

    registry = MetricsRegistry()
    monkeypatch.setattr(kops, "default_registry", lambda: registry)
    monkeypatch.setattr(kops, "_resolve", resolve)
    return calls

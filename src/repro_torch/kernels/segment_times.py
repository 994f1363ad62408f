"""Device times of GAT's two segment kernels, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.segment_times

Times ``ops.edge_softmax`` (H 4) and ``ops.segment_reduce`` (sum, F 64)
with ``mode="kernel"`` on two graphs: the packed plan of 128 MolHIV-like
graphs in one (4096, 12288) bucket (GAT's packed batch), and
:func:`hub_graph` at the same size, whose in-degrees take every path of the
kernels.  Inputs come from fixed seeds.  Prints one JSON line per graph and
kernel: the median device time of 50 calls (``torch.profiler``), in
microseconds, and the graph's largest in-degree.

It uses only the package's entry points, so it also times another tree's
kernels when run as a file:
``PYTHONPATH=<tree>/src python src/repro_torch/kernels/segment_times.py``.

Needs one NVIDIA GPU; exits 1 without one.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from repro_torch.core import batching as B
from repro_torch.core import graph as G
from repro_torch.core import layout as LY
from repro_torch.data.pipeline import MOLHIV, MoleculeStream
from repro_torch.kernels import ops as kops
from repro_torch.kernels.fused_mp_phases import device_us

# the first in-degrees of a hub graph: hubs of 300 and 1000 edges, 0, 1,
# 16 and 17 (either side of edge_softmax's THREAD_EDGES) and 33 (past a
# warp's lanes); 1000 is past its WARP_EDGES
HUB_DEGREES = (300, 0, 1, 16, 17, 33, 1000)


def hub_graph(rng, n_pad: int, e_pad: int, device):
    """A graph of ``n_pad - 96`` real nodes padded to ``n_pad`` whose
    in-degrees are ``HUB_DEGREES``, then 0-3, with padding edges up to
    ``e_pad``; and its layout plan on ``device``."""
    n_real = n_pad - 96
    deg = np.concatenate([HUB_DEGREES, rng.integers(0, 4, n_real - len(HUB_DEGREES))])
    r = np.repeat(np.arange(n_real), deg).astype(np.int32)
    if r.size > e_pad:
        raise ValueError(f"hub graph: {r.size} edges past E={e_pad}")
    s = rng.integers(0, n_real, r.size).astype(np.int32)
    g = G.from_numpy(s, r, rng.normal(size=(n_real, 9)).astype(np.float32),
                     rng.normal(size=(r.size, 3)).astype(np.float32),
                     n_pad=n_pad, e_pad=e_pad, device=device)
    return g, LY.build_layout(g)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("segment_times: CUDA is not available; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    batch = [g[:4] for g in MoleculeStream(MOLHIV, seed=0).take(128)]
    packed, _ = B.pack_graphs(batch, B.BucketBudget(4096, 12288, 128), device=device)
    graphs = {"packed": (packed, B.pack_layout(packed)),
              "hub": hub_graph(np.random.default_rng(6), 4096, 12288, device)}
    gen = torch.Generator().manual_seed(11)
    for name, (g, lay) in graphs.items():
        n, e = g.num_nodes, g.num_edges
        logits = torch.randn((e, 4), generator=gen).to(device)
        values = torch.randn((e, 64), generator=gen).to(device)
        plan = (lay.ids_sorted, lay.offsets, n)
        calls = {"edge_softmax": lambda: kops.edge_softmax(logits, *plan, mode="kernel"),
                 "segment_reduce": lambda: kops.segment_reduce(values, *plan, "sum",
                                                               mode="kernel")}
        for kernel, fn in calls.items():
            print(json.dumps(dict(graph=name, kernel=kernel, us=round(device_us(fn), 3),
                                  max_degree=int(lay.in_degree.max()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end serving driver on the PyTorch port (the counterpart of
``examples/serve_realtime_stream.py``): a stream of raw COO molecule graphs
is classified one by one — batch size 1, zero preprocessing, the COO->CSC
plan built on the device inside the served program — and latency
percentiles are reported, plus the batched-mode comparison.

  PYTHONPATH=src python examples/torch_serve_realtime_stream.py [n_graphs]
  PYTHONPATH=src python examples/torch_serve_realtime_stream.py 16 --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.gengnn_models import get_gnn_config
from repro_torch.data.pipeline import MOLHIV, MoleculeStream
from repro_torch.device import device_or_exit
from repro_torch.gnn import init
from repro_torch.serve.gnn_engine import GNNEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=64, help="graphs to stream")
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    device = device_or_exit(args.device, "torch_serve_realtime_stream")
    n = args.n
    cfg = get_gnn_config("gin_vn")  # GIN + virtual node, paper §4.5
    params = init(torch.Generator().manual_seed(0), cfg, device)
    engine = GNNEngine(cfg, params, device=device)
    stream = MoleculeStream(MOLHIV, seed=0)

    graphs = stream.take(n)
    t0 = time.perf_counter()
    outs, lats, compile_s = engine.infer_stream([g[:4] for g in graphs])
    wall = time.perf_counter() - t0
    # simple correctness proxy: the synthetic label is linearly separable
    preds = np.array([float(o[0, 0]) > 0 for o in outs])
    labels = np.array([bool(g[4]) for g in graphs])
    print(f"streamed {n} graphs in {wall:.2f}s ({compile_s:.1f}s compile, excluded from latency)")
    print(f"latency us: mean {np.mean(lats)*1e6:.0f}  p50 {np.percentile(lats,50)*1e6:.0f}  "
          f"p99 {np.percentile(lats,99)*1e6:.0f}")
    print(f"untrained-model label agreement (chance ~0.5): {np.mean(preds == labels):.2f}")

    outs_b, per_graph = engine.infer_batched(graphs, batch_size=8,
                                             n_pad=8 * 64, e_pad=8 * 192)
    print(f"batched mode: {per_graph*1e6:.0f} us/graph "
          f"({np.mean(lats)/per_graph:.1f}x throughput vs stream)")


if __name__ == "__main__":
    main()

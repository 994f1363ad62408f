"""Large Graph Extension (paper §4.6 / Fig. 8) on the PyTorch port (the
counterpart of ``examples/large_graph_dgn.py``): DGN node classification on
a PubMed-sized graph that exceeds any single on-chip buffer, one forward
over the whole graph through the port's kernels.  The second forward is
timed (CUDA events on the card, the host clock on the CPU).

  PYTHONPATH=src python examples/torch_large_graph_dgn.py
  PYTHONPATH=src python examples/torch_large_graph_dgn.py --device cpu --nodes 2000 --edges 9000 --feat 50
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.graph import from_numpy
from repro_torch.device import device_or_exit
from repro_torch.gnn import apply, init, paper_config


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain PyTorch path")
    # PubMed (Table 5) by default; smaller sizes for a quick run
    ap.add_argument("--nodes", type=int, default=19717)
    ap.add_argument("--edges", type=int, default=88648)
    ap.add_argument("--feat", type=int, default=500)
    args = ap.parse_args(argv)
    device = device_or_exit(args.device, "torch_large_graph_dgn")
    n, e, f = args.nodes, args.edges, args.feat
    rng = np.random.default_rng(0)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    nf = (rng.random((n, f)) < 0.01).astype(np.float32)
    cfg = paper_config("dgn", feat_dim=f, task="node", out_dim=3, edge_dim=1)
    params = init(torch.Generator().manual_seed(0), cfg, device)
    g = from_numpy(s, r, nf, None, n_pad=-(-n // 128) * 128, e_pad=-(-e // 128) * 128,
                   device=device)
    eig = torch.from_numpy(rng.normal(size=(g.num_nodes,)).astype(np.float32)).to(device)

    cuda = device.type == "cuda"
    with torch.inference_mode():
        out = apply(params, g, cfg, eigvec=eig)  # first call: the kernels load
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            out = apply(params, g, cfg, eigvec=eig)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = apply(params, g, cfg, eigvec=eig)
            dt = time.perf_counter() - t0
    print(f"PubMed-sized DGN: {n} nodes, {e} edges, feat {f}")
    print(f"forward {dt*1e3:.1f} ms ({dt/n*1e6:.2f} us/node); output {tuple(out.shape)}, "
          f"NaNs: {bool(torch.isnan(out).any())}")


if __name__ == "__main__":
    main()

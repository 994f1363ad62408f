"""Serving launcher of the port: the streaming or padded-batch GNN engine
for the paper's six models (port of the GNN path of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --gnn gin --fused --n-graphs 32
  PYTHONPATH=src python -m repro_torch.launch.serve --gnn gcn --batched --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --gnn dgn --fused --n-graphs 32
  PYTHONPATH=src python -m repro_torch.launch.serve --gnn gin --device cpu

Runs on the card unless ``--device cpu`` is given.  Parameters are random,
drawn from a fixed seed; DGN computes its eigenvector input per graph in
prepare.  The printed latency line has the JAX launcher's
format; its "compile ... excluded" figure is the untimed warm-up (kernel
build and first run).
"""
import argparse

import numpy as np
import torch


def serve_gnn(args):
    from repro_torch.configs.gengnn_models import get_gnn_config
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream
    from repro_torch.gnn import init
    from repro_torch.serve.gnn_engine import GNNEngine

    cfg = get_gnn_config(args.gnn)
    params = init(torch.Generator().manual_seed(0), cfg)
    eng = GNNEngine(cfg, params, fused=args.fused, device=args.device)
    graphs = MoleculeStream(MOLHIV, seed=0).take(args.n_graphs)
    with_eigvec = args.gnn == "dgn"
    if args.batched:
        outs, per_graph_s = eng.infer_batched(
            graphs, batch_size=args.batch, n_pad=args.batch * 32,
            e_pad=args.batch * 96, with_eigvec=with_eigvec,
        )
        print(f"{args.gnn} batched(bs={args.batch}): "
              f"{len(outs)} graphs, {per_graph_s*1e6:.0f} us/graph "
              f"(compile {eng.warm_seconds:.1f}s excluded)")
        return
    outs, lats, warm_s = eng.infer_stream([g[:4] for g in graphs],
                                          with_eigvec=with_eigvec)
    print(f"{args.gnn}: {len(outs)} graphs, mean {np.mean(lats)*1e6:.0f} us/graph "
          f"(p50 {np.percentile(lats,50)*1e6:.0f}, p99 {np.percentile(lats,99)*1e6:.0f}; "
          f"compile {warm_s:.1f}s excluded)")


def main(argv=None):
    from repro_torch.configs.gengnn_models import GNN_MODELS

    ap = argparse.ArgumentParser()
    ap.add_argument("--gnn", choices=GNN_MODELS, required=True)
    ap.add_argument("--fused", action="store_true",
                    help="run every layer as one fused (phi, A, gamma) "
                         "fused_mp kernel pass")
    ap.add_argument("--n-graphs", type=int, default=16)
    ap.add_argument("--batched", action="store_true",
                    help="padded-batch mode instead of streaming")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    serve_gnn(ap.parse_args(argv))


if __name__ == "__main__":
    main()

"""Quickstart on the PyTorch port: run all six GenGNN models through the one
generic engine (the counterpart of ``examples/quickstart.py``).

The paper's core claim — a single message-passing architecture serves
GCN / GIN(+VN) / GAT / PNA / DGN unchanged — each model at its paper
configuration, served one graph at a time through the executor (on the
card: its CUDA graphs over the hand-written kernels).

  PYTHONPATH=src python examples/torch_quickstart.py                # on the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # plain PyTorch
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.gengnn_models import GNN_MODELS, get_gnn_config
from repro_torch.data.pipeline import MOLHIV, MoleculeStream
from repro_torch.device import device_or_exit
from repro_torch.gnn import init
from repro_torch.serve.gnn_engine import GNNEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    device = device_or_exit(args.device, "torch_quickstart")
    graphs = MoleculeStream(MOLHIV, seed=0).take(8)  # raw COO, zero preprocessing
    for name in GNN_MODELS:
        cfg = get_gnn_config(name)
        params = init(torch.Generator().manual_seed(0), cfg, device)
        engine = GNNEngine(cfg, params, device=device)
        outs, lats, _ = engine.infer_stream(
            [g[:4] for g in graphs], with_eigvec=(name == "dgn")
        )
        print(f"{name:7s} -> {len(outs)} graphs, "
              f"mean latency {np.mean(lats)*1e6:7.0f} us, "
              f"first output {float(outs[0][0,0]):+.4f}")


if __name__ == "__main__":
    main()

"""Serving launcher of the port: the streaming or padded-batch GNN engine
for the paper's six models, or batched prefill + decode of a dense LM
(port of the GNN and ``--arch`` paths of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --gnn gin --fused --n-graphs 32
  PYTHONPATH=src python -m repro_torch.launch.serve --gnn gcn --batched --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --gnn dgn --fused --n-graphs 32
  PYTHONPATH=src python -m repro_torch.launch.serve --gnn gin --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --gnn gin --fused --precision int8
  PYTHONPATH=src python -m repro_torch.launch.serve --gnn gin --precision int8-static
  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b --reduced --device cpu

Runs on the card unless ``--device cpu`` is given.  Parameters are random,
drawn from a fixed seed; DGN computes its eigenvector input per graph in
prepare.  ``--precision int8-static`` calibrates on 16 graphs of a stream
disjoint from the served one (seed 97); every precision but fp32 prints a
``[quant]`` report line.  The printed latency line has the JAX launcher's
format; its "compile ... excluded" figure is the untimed warm-up (the
eager first run with the kernels' build, the CUDA-graph capture and the
first replay).  ``--arch`` serves one of the dense LMs (full or
``--reduced``) with random weights from seed 0 and prints the generated
tokens and the prefill / per-token decode times, as the JAX launcher does;
its first prefill also builds the flash-attention kernel.
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
    calib = None
    if args.precision == "int8-static":
        # calibration stream disjoint from the served one (seed split)
        calib = [g[:4] for g in MoleculeStream(MOLHIV, seed=97).take(16)]
    eng = GNNEngine(cfg, params, precision=args.precision, calib_graphs=calib,
                    fused=args.fused, device=args.device)
    if eng.quant_report is not None:
        r = eng.quant_report
        print(f"[quant] {args.precision}: {r.quantized} linears quantized, "
              f"{r.kept_fp32} fp32 (skip: {list(r.skipped_paths)})")
    graphs = MoleculeStream(MOLHIV, seed=0).take(args.n_graphs)
    with_eigvec = args.gnn == "dgn"
    if args.batched:
        outs, per_graph_s = eng.infer_batched(
            graphs, batch_size=args.batch, n_pad=args.batch * 32,
            e_pad=args.batch * 96, with_eigvec=with_eigvec,
        )
        print(f"{args.gnn} batched(bs={args.batch}): "
              f"{len(outs)} graphs, {per_graph_s*1e6:.0f} us/graph "
              f"(compile {eng.compile_seconds + eng.warm_seconds:.1f}s excluded)")
        return
    outs, lats, warm_s = eng.infer_stream([g[:4] for g in graphs],
                                          with_eigvec=with_eigvec)
    print(f"{args.gnn}: {len(outs)} graphs, mean {np.mean(lats)*1e6:.0f} us/graph "
          f"(p50 {np.percentile(lats,50)*1e6:.0f}, p99 {np.percentile(lats,99)*1e6:.0f}; "
          f"compile {warm_s:.1f}s excluded)")


def serve_lm(args):
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.serve.engine import LMServer, ServeConfig

    cfg = (get_reduced if args.reduced else get_config)(args.arch)
    device = resolve_device(args.device)
    params = lm.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    scfg = ServeConfig(max_batch=args.batch, prompt_len=args.prompt_len,
                       cache_len=args.cache_len, max_new_tokens=args.max_new)
    srv = LMServer(params, cfg, scfg, device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, rng.integers(4, args.prompt_len))
               for _ in range(args.batch)]
    out, stats = srv.generate(prompts)
    print("generated:", out[:2])
    print(f"prefill {stats['prefill_s']*1e3:.1f} ms, "
          f"decode {stats['decode_s_per_token']*1e3:.2f} ms/token")


def main(argv=None):
    from repro_torch.configs import ARCHS
    from repro_torch.configs.gengnn_models import GNN_MODELS

    ap = argparse.ArgumentParser()
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--gnn", choices=GNN_MODELS)
    what.add_argument("--arch", choices=ARCHS,
                      help="serve a dense LM: batched prefill + greedy decode")
    ap.add_argument("--reduced", action="store_true",
                    help="LM: the same-family smoke-test reduction")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--fused", action="store_true",
                    help="run every layer as one fused (phi, A, gamma) "
                         "fused_mp kernel pass")
    ap.add_argument("--precision", default="fp32",
                    choices=("fp32", "int8", "int8-static", "fixed"),
                    help="serving arithmetic: int8 is W8A8 with dynamic "
                         "per-node activation scales, int8-static "
                         "calibrates per-tensor scales first, fixed "
                         "emulates ap_fixed<16,6>")
    ap.add_argument("--n-graphs", type=int, default=16)
    ap.add_argument("--batched", action="store_true",
                    help="padded-batch mode instead of streaming")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    (serve_lm if args.arch else serve_gnn)(args)


if __name__ == "__main__":
    main()

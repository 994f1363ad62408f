"""Serving launcher of the port: the streaming or padded-batch GNN engine
for the paper's six models, the micro-batching stream scheduler over one
or several of them, or batched prefill + decode of a dense LM (port of the
GNN, ``--stream``, ``--models`` and ``--arch`` paths of
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --gnn gin --fused --n-graphs 32
  PYTHONPATH=src python -m repro_torch.launch.serve --gnn gin --fused --stream \
      --n-graphs 64 --qps 2000 --max-wait-ms 2
  PYTHONPATH=src python -m repro_torch.launch.serve --gnn gin --fused --stream \
      --n-graphs 64 --qps 8000 --slo-ms 20 --admit-limit 32 --adapt-ladder
  PYTHONPATH=src python -m repro_torch.launch.serve --gnn gin --fused --stream \
      --n-graphs 64 --qps 8000 --priority 0,0,1 --slo-ms 0:10,1:50 --pipeline
  PYTHONPATH=src python -m repro_torch.launch.serve --models gcn:int8,gat:fp32 \
      --fused --n-graphs 32 --qps 1000 --slo-ms 20
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

``--stream`` serves the graphs through ``serve.scheduler.StreamScheduler``
(arrivals at ``--qps`` on its virtual clock, flushes packed up to
``--pack`` base buckets, each one replay of the rung's CUDA graph) and
prints the JAX launcher's lines: graphs/s, latency percentiles, flushes
and the admission line of its metrics registry.  ``--models`` registers
each ``model[:precision]`` spec as a tenant of one executor behind one
scheduler.  ``--metrics-json``, ``--trace-out`` and ``--no-share-layout``
are not ported yet (ROADMAP queue 1, item 9), nor ``--aot-cache``,
``--prewarm-persist`` and ``--gnn-mesh`` (items 10 and 11).
"""
import argparse

import numpy as np
import torch


def _slo_kwargs(args):
    """StreamScheduler admission kwargs from the CLI flags.

    ``--slo-ms`` is either one budget for every request ("20") or a
    per-QoS-class table ("0:10,1:50" -> ``slo_by_class``); ``--priority``
    cycles its classes over the stream round-robin."""
    kw = dict(admit_limit=args.admit_limit, admit_margin=args.admit_margin,
              adapt_ladder=args.adapt_ladder)
    if args.pipeline:
        from repro_torch.serve.pipeline import PipelineConfig

        kw["pipeline"] = PipelineConfig(inflight=args.inflight)
    if args.slo_ms:
        if ":" in args.slo_ms:
            kw["slo_by_class"] = {
                (None, int(cls)): float(ms) * 1e-3
                for cls, _, ms in (s.partition(":")
                                   for s in args.slo_ms.split(","))
            }
        else:
            kw["slo_s"] = float(args.slo_ms) * 1e-3
    return kw


def _priorities(args, n):
    cycle = [int(p) for p in args.priority.split(",")]
    return [cycle[i % len(cycle)] for i in range(n)]


def _report_stream(rep, registry, head: str, extra: str) -> None:
    """The stream's lines: throughput, latency percentiles, flushes, and
    the admission line rendered from the metrics registry."""
    from repro_torch.obs import export

    sizes = np.asarray(rep.batch_sizes)
    print(f"{head}: {rep.num_requests} graphs in {rep.makespan_s*1e3:.1f} ms "
          f"virtual ({rep.graphs_per_s:.0f} graphs/s)")
    print(f"  latency ms: p50 {rep.percentile_ms(50):.2f}  "
          f"p95 {rep.percentile_ms(95):.2f}  p99 {rep.percentile_ms(99):.2f}")
    print(f"  {len(sizes)} flushes (mean batch "
          f"{sizes.mean() if sizes.size else 0.0:.1f}, reasons "
          f"{dict(rep.flush_reasons)}); {extra}compile {rep.compile_s:.1f}s excluded")
    print(f"  {export.admission_line(registry)}")


def serve_gnn_multitenant(args):
    """Serve several GNN models through ONE executor + ONE scheduler:
    ``--models gcn:int8,gat:fp32`` registers each ``model[:precision]``
    spec as a tenant (seed i for the i-th spec's params); the stream
    round-robins requests across the tenants."""
    from repro_torch.configs.gengnn_models import get_gnn_config
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream
    from repro_torch.gnn import init
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve.executor import Executor
    from repro_torch.serve.scheduler import StreamScheduler

    ex = Executor(device=args.device)
    specs = []
    for i, spec in enumerate(args.models.split(",")):
        model, _, precision = spec.partition(":")
        precision = precision or "fp32"
        cfg = get_gnn_config(model)
        params = init(torch.Generator().manual_seed(i), cfg)
        calib = None
        if precision == "int8-static":
            calib = [g[:4] for g in MoleculeStream(MOLHIV, seed=97).take(16)]
        ex.register(spec, cfg, params, precision=precision, calib_graphs=calib,
                    fused=args.fused)
        specs.append(spec)
    registry = MetricsRegistry()
    sched = StreamScheduler(ex, capacity=args.pack,
                            max_wait_s=args.max_wait_ms * 1e-3,
                            with_eigvec="auto", metrics=registry,
                            **_slo_kwargs(args))
    graphs = [g[:4] for g in MoleculeStream(MOLHIV, seed=0).take(args.n_graphs)]
    models = [specs[i % len(specs)] for i in range(len(graphs))]
    rep = sched.run(graphs, qps=args.qps, models=models,
                    priorities=_priorities(args, len(graphs)))
    counts = {s: models.count(s) for s in specs}
    _report_stream(rep, registry,
                   f"multi-tenant stream(qps={args.qps:g}, pack x{args.pack}, "
                   f"tenants {counts})",
                   f"{len(ex._compiled)} program records, "
                   f"{ex.lowered_count} captures, ")


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
    if args.stream:
        from repro_torch.obs import MetricsRegistry
        from repro_torch.serve.scheduler import StreamScheduler

        registry = MetricsRegistry()
        sched = StreamScheduler(eng, capacity=args.pack,
                                max_wait_s=args.max_wait_ms * 1e-3,
                                with_eigvec=with_eigvec, metrics=registry,
                                **_slo_kwargs(args))
        rep = sched.run([g[:4] for g in graphs], qps=args.qps,
                        priorities=_priorities(args, len(graphs)))
        if rep.num_requests == 0:
            print(f"{args.gnn} stream: no graphs (--n-graphs {args.n_graphs})")
            return
        _report_stream(rep, registry,
                       f"{args.gnn} stream(qps={args.qps:g}, max-wait "
                       f"{args.max_wait_ms}ms, pack x{args.pack}"
                       f"{', pipeline x' + str(args.inflight) if args.pipeline else ''})",
                       "")
        return
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
    what.add_argument("--models",
                      help="multi-tenant GNN serving: comma-separated "
                           "model[:precision] specs (e.g. gcn:int8,gat:fp32) "
                           "registered on one shared executor + scheduler")
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
    ap.add_argument("--stream", action="store_true",
                    help="GNN: micro-batched streaming via serve.scheduler")
    ap.add_argument("--qps", type=float, default=1000.0,
                    help="stream: offered load; <=0 means all queued at t=0")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="stream: flush a bucket at latest this long after it opens")
    ap.add_argument("--pack", type=int, default=4,
                    help="stream: packed budget = this many base buckets")
    ap.add_argument("--slo-ms", default="",
                    help="stream: per-request latency SLO; one budget "
                         "('20') or a class:ms table ('0:10,1:50'); "
                         "enables admission control (empty = best-effort, "
                         "never shed)")
    ap.add_argument("--priority", default="0",
                    help="stream: QoS classes cycled over the stream "
                         "round-robin (lower = more urgent), e.g. '0,0,1'")
    ap.add_argument("--admit-limit", type=int, default=None,
                    help="stream: bound on admitted-but-unflushed requests; "
                         "arrivals beyond it shed with reason queue_full")
    ap.add_argument("--admit-margin", type=float, default=1.0,
                    help="stream: fraction of the SLO the admission "
                         "projection may use (guard band; see "
                         "serve/scheduler.py)")
    ap.add_argument("--adapt-ladder", action="store_true",
                    help="stream: re-fit each signature's bucket-rung "
                         "geometry to the observed flush-size histogram")
    ap.add_argument("--pipeline", action="store_true",
                    help="stream: pipelined (dispatch-ahead) execution: "
                         "flushes dispatch at their deadline while prior "
                         "flushes are still in flight (serve/pipeline.py)")
    ap.add_argument("--inflight", type=int, default=2,
                    help="stream: bound on dispatched-but-unharvested "
                         "flushes in pipelined mode (1 = serial dispatch "
                         "order; default 2 = double buffering)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    if args.arch:
        serve_lm(args)
    elif args.models:
        serve_gnn_multitenant(args)
    else:
        serve_gnn(args)


if __name__ == "__main__":
    main()

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
  PYTHONPATH=src python -m repro_torch.launch.serve --gnn gin --fused --stream \
      --n-graphs 64 --aot-cache /tmp/aot --prewarm-persist \
      --metrics-json /tmp/metrics.json --trace-out /tmp/trace.json
  PYTHONPATH=src python -m repro_torch.launch.serve --gnn gat --stream \
      --no-share-layout --n-graphs 32
  PYTHONPATH=src python -m repro_torch.launch.serve --gnn gcn --batched --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --gnn gin --batched --gnn-mesh 2 \
      --n-graphs 12 --batch 4
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
first replay).  ``--arch`` serves one of the registry's LMs (dense, MLA,
MoE, hybrid, SSM, VLM or audio; full or ``--reduced``) with random
weights from seed 0 and prints the generated tokens and the prefill /
per-token decode times, as the JAX launcher does; a VLM's patch and an
audio model's frame embeddings are normal draws from the prompts' numpy
generator, as JAX's launcher makes them.  On the card it first prints the
init's peak memory.  Its first prefill also builds the flash-attention
kernel (RWKV-6 has no attention and builds none).  A full VLM needs
``--cache-len`` past its 1024 patches + ``--prompt-len`` + ``--max-new``,
for example ``--arch internvl2-26b --batch 4 --prompt-len 512
--cache-len 1600 --max-new 32``.

``--stream`` serves the graphs through ``serve.scheduler.StreamScheduler``
(arrivals at ``--qps`` on its virtual clock, flushes packed up to
``--pack`` base buckets, each one replay of the rung's CUDA graph) and
prints the JAX launcher's lines: graphs/s, latency percentiles, flushes
and the admission line of its metrics registry.  ``--models`` registers
each ``model[:precision]`` spec as a tenant of one executor behind one
scheduler.  ``--metrics-json`` and ``--trace-out`` write the stream's
metrics snapshot and its virtual-clock trace (check them with ``python -m
repro_torch.obs.check_artifacts``); ``--no-share-layout`` serves the
per-call-sort path.

Cold start: ``--aot-cache DIR`` keeps the CUDA kernels' libraries in a
fingerprinted cache (``serve/aot.py``), so a restarted server runs no
``nvcc``; ``--prewarm-persist`` captures every bucket ladder before the
stream.  With ``--aot-cache`` the launcher prints JAX's line
``cold_start_s=... aot_hit=... aot_miss=... aot_stale=... lowered=...``
and ``nvcc_runs=...``: ``cold_start_s`` runs from launcher entry to
ladder-warm (the interpreter's start and imports excluded), ``aot_miss``
and ``aot_stale`` are lookups that ran ``nvcc``, ``nvcc_runs`` the
compiler processes this process started, and ``lowered`` the CUDA-graph
captures, which a restart repeats (graphs are not serialized).

Mesh: ``--gnn-mesh P`` (``--gnn`` and ``--models``) serves every
forward sharded over P ranks (``serve/executor.py``'s mesh).  The
launcher starts the P ranks itself (``launch/ranks.py``: spawned,
rendezvous through a file in a fresh temporary directory): NCCL, one card
a rank, where the machine has P cards and ``--device`` is a card (its
bootstrap over the loopback unless ``NCCL_SOCKET_IFNAME`` says
otherwise); gloo otherwise, every rank on the one card (gloo collectives
run on CUDA tensors) or on the CPU.  On NCCL the executor serves the
sharded forwards through CUDA graphs; on gloo it runs them eagerly (a gloo
collective cannot be captured).  Every rank serves the same
graphs and, with ``--stream`` or ``--models``, takes the same flushes:
each flush's time is the slowest rank's, so the ranks' schedulers keep
one timeline; under ``--pipeline`` each flush's host pack time is the
slowest rank's as well.  Rank 0 prints the lines, its latency line
ending in ``mesh=P backend=... captured=...``.  A rank that fails fails the launcher.

Not taken: ``--xla-flags-file`` (XLA's compiler options have no CUDA
meaning).
"""
import argparse
import sys
import time

import numpy as np
import torch


def _mesh(args):
    """The flat ``data`` mesh of ``--gnn-mesh`` (None for 1 rank)."""
    if args.gnn_mesh <= 1:
        return None
    from repro_torch import runtime as RT

    return RT.make_flat_mesh(args.gnn_mesh, axis="data", device=args.device)


def _mesh_note(ex) -> str:
    """The latency line's mesh: its ranks, backend, and whether the
    executor ``ex`` captured its forwards (NCCL) or ran them eagerly."""
    if ex.mesh is None:
        return ""
    return f" mesh={ex.mesh.size} backend={ex.mesh.backend} captured={ex.captured}"


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


def _aot_setup(args):
    """The kernel-library cache from ``--aot-cache`` (None without it)."""
    if not args.aot_cache:
        return None
    from repro_torch.serve.aot import AOTCache

    return AOTCache(args.aot_cache)


def _report_cold_start(args, executor, scheduler, graphs, registry,
                       models=None):
    """With ``--aot-cache``: prewarm the bucket ladders when
    ``--prewarm-persist`` asks (the kernels' libraries load, from the cache
    or built into it, and every rung is captured), then print the
    cold-start line and set ``serve_cold_start_seconds``."""
    if not args.aot_cache:
        return
    from repro_torch.kernels import _build

    if args.prewarm_persist and scheduler is not None and graphs:
        scheduler.prewarm_ladders(graphs, models=models)
    elapsed = time.perf_counter() - args._t0
    stats = executor.aot_stats()
    print(f"cold_start_s={elapsed:.3f} aot_hit={stats['hit']} "
          f"aot_miss={stats['miss']} aot_stale={stats['stale']} "
          f"lowered={executor.lowered_count} nvcc_runs={_build.nvcc_runs}")
    if registry is not None:
        from repro_torch.obs.metrics import ServingInstruments

        ServingInstruments(registry).cold_start.set(elapsed)


def _telemetry(args):
    """(tracer, registry) for the stream paths: the registry always (it
    holds the admission ledger), a ``Tracer`` on a ``VirtualClock`` only
    when ``--trace-out`` asks for the artifact."""
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.serve.clock import VirtualClock

    registry = MetricsRegistry()
    tracer = Tracer(VirtualClock()) if args.trace_out else None
    return tracer, registry


def _emit_telemetry(args, tracer, registry) -> None:
    """Write the artifacts ``--metrics-json`` / ``--trace-out`` ask for."""
    from repro_torch.obs import export

    if args.metrics_json:
        export.write_metrics_json(registry, args.metrics_json)
        print(f"  metrics-json -> {args.metrics_json}")
    if args.trace_out:
        export.write_trace(tracer, args.trace_out)
        print(f"  trace-out -> {args.trace_out}")


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
    from repro_torch.serve.executor import Executor
    from repro_torch.serve.scheduler import StreamScheduler

    mesh = _mesh(args)
    ex = Executor(device=args.device, aot_cache=_aot_setup(args), mesh=mesh)
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
                    share_layout=not args.no_share_layout, fused=args.fused)
        specs.append(spec)
    tracer, registry = _telemetry(args)
    sched = StreamScheduler(ex, capacity=args.pack,
                            max_wait_s=args.max_wait_ms * 1e-3,
                            with_eigvec="auto", tracer=tracer,
                            metrics=registry, **_slo_kwargs(args))
    graphs = [g[:4] for g in MoleculeStream(MOLHIV, seed=0).take(args.n_graphs)]
    models = [specs[i % len(specs)] for i in range(len(graphs))]
    _report_cold_start(args, ex, sched, graphs, registry, models=models)
    rep = sched.run(graphs, qps=args.qps, models=models,
                    priorities=_priorities(args, len(graphs)))
    counts = {s: models.count(s) for s in specs}
    _report_stream(rep, registry,
                   f"multi-tenant stream(qps={args.qps:g}, pack x{args.pack}, "
                   f"tenants {counts}){_mesh_note(ex)}",
                   f"{len(ex._compiled)} program records, "
                   f"{ex.lowered_count} captures, ")
    _emit_telemetry(args, tracer, registry)


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
    mesh = _mesh(args)
    eng = GNNEngine(cfg, params, precision=args.precision, calib_graphs=calib,
                    share_layout=not args.no_share_layout, fused=args.fused,
                    device=args.device, aot_cache=_aot_setup(args), mesh=mesh)
    if eng.quant_report is not None:
        r = eng.quant_report
        print(f"[quant] {args.precision}: {r.quantized} linears quantized, "
              f"{r.kept_fp32} fp32 (skip: {list(r.skipped_paths)})")
    graphs = MoleculeStream(MOLHIV, seed=0).take(args.n_graphs)
    with_eigvec = args.gnn == "dgn"
    if args.stream:
        from repro_torch.serve.scheduler import StreamScheduler

        tracer, registry = _telemetry(args)
        sched = StreamScheduler(eng, capacity=args.pack,
                                max_wait_s=args.max_wait_ms * 1e-3,
                                with_eigvec=with_eigvec, tracer=tracer,
                                metrics=registry, **_slo_kwargs(args))
        _report_cold_start(args, eng.executor, sched, [g[:4] for g in graphs],
                           registry)
        rep = sched.run([g[:4] for g in graphs], qps=args.qps,
                        priorities=_priorities(args, len(graphs)))
        if rep.num_requests == 0:
            print(f"{args.gnn} stream: no graphs (--n-graphs {args.n_graphs})")
            return
        _report_stream(rep, registry,
                       f"{args.gnn} stream(qps={args.qps:g}, max-wait "
                       f"{args.max_wait_ms}ms, pack x{args.pack}"
                       f"{', pipeline x' + str(args.inflight) if args.pipeline else ''})"
                       f"{_mesh_note(eng.executor)}",
                       "")
        _emit_telemetry(args, tracer, registry)
        return
    if args.batched:
        outs, per_graph_s = eng.infer_batched(
            graphs, batch_size=args.batch, n_pad=args.batch * 32,
            e_pad=args.batch * 96, with_eigvec=with_eigvec,
        )
        print(f"{args.gnn} batched(bs={args.batch}): "
              f"{len(outs)} graphs, {per_graph_s*1e6:.0f} us/graph "
              f"(compile {eng.compile_seconds + eng.warm_seconds:.1f}s excluded)"
              f"{_mesh_note(eng.executor)}")
        return
    outs, lats, warm_s = eng.infer_stream([g[:4] for g in graphs],
                                          with_eigvec=with_eigvec)
    print(f"{args.gnn}: {len(outs)} graphs, mean {np.mean(lats)*1e6:.0f} us/graph "
          f"(p50 {np.percentile(lats,50)*1e6:.0f}, p99 {np.percentile(lats,99)*1e6:.0f}; "
          f"compile {warm_s:.1f}s excluded){_mesh_note(eng.executor)}")
    if args.aot_cache:
        stats = eng.executor.aot_stats()
        print(f"  aot: hit {stats['hit']} miss {stats['miss']} "
              f"stale {stats['stale']}; {eng.executor.lowered_count} captures")


def serve_lm(args):
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.serve.engine import LMServer, ServeConfig

    cfg = (get_reduced if args.reduced else get_config)(args.arch)
    device = resolve_device(args.device)
    scfg = ServeConfig(max_batch=args.batch, prompt_len=args.prompt_len,
                       cache_len=args.cache_len, max_new_tokens=args.max_new)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    params = lm.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    if cuda:
        print(f"init peak memory {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
        torch.cuda.empty_cache()  # the fp32 draws' blocks
    srv = LMServer(params, cfg, scfg, device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, rng.integers(4, args.prompt_len))
               for _ in range(args.batch)]
    # JAX's launcher's draw: the VLM's patch or the audio model's frame
    # embeddings (the stubbed frontends' outputs)
    extra = lm.extra_input(cfg, args.batch)
    extras = None if extra is None else {
        extra[0]: rng.normal(size=extra[1]).astype(np.float32)}
    out, stats = srv.generate(prompts, extras=extras)
    print("generated:", out[:2])
    print(f"prefill {stats['prefill_s']*1e3:.1f} ms, "
          f"decode {stats['decode_s_per_token']*1e3:.2f} ms/token")


def main(argv=None):
    t0 = time.perf_counter()  # cold-start epoch: launcher entry
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
                      help="serve an LM (dense, MLA, MoE, hybrid, SSM, VLM or "
                           "audio): batched prefill + greedy decode")
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
    ap.add_argument("--metrics-json", default="",
                    help="stream: write the metrics-registry snapshot "
                         "(repro-metrics/v1 JSON) here after the run")
    ap.add_argument("--trace-out", default="",
                    help="stream: write the run's Chrome/Perfetto "
                         "trace-event JSON here (the scheduler's "
                         "virtual-clock timeline; open in "
                         "ui.perfetto.dev)")
    ap.add_argument("--no-share-layout", action="store_true",
                    help="GNN: disable the shared GraphLayout plan and "
                         "re-sort edges inside every aggregation (the "
                         "pre-layout behaviour; A/B benchmarking only)")
    ap.add_argument("--aot-cache", default="",
                    help="GNN: persistent cache directory of the CUDA "
                         "kernels' libraries, fingerprinted by torch, CUDA, "
                         "nvcc, driver and GPU; a warm cache serves a "
                         "restart without one nvcc run (CUDA graphs are "
                         "captured again)")
    ap.add_argument("--prewarm-persist", action="store_true",
                    help="GNN stream: warm every (tenant, signature) "
                         "bucket ladder before serving, populating "
                         "--aot-cache so the next restart builds nothing")
    ap.add_argument("--gnn-mesh", type=int, default=1,
                    help="GNN: shard every forward's node rows over this "
                         "many ranks, which the launcher starts (NCCL with "
                         "a card each, else gloo)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    args._t0 = t0
    if args.gnn_mesh > 1:
        import torch.distributed as dist

        if args.arch:
            ap.error("--gnn-mesh serves --gnn or --models, not --arch")
        if not dist.is_initialized():
            from repro_torch.launch import ranks

            ranks.spawn(main, args.gnn_mesh, args.device,
                        sys.argv[1:] if argv is None else list(argv))
            return
    if args.arch:
        serve_lm(args)
    elif args.models:
        serve_gnn_multitenant(args)
    else:
        serve_gnn(args)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (built for the H100: the kernels compile for
``sm_90a``) and the CUDA toolkit.  It builds the six CUDA kernel sources
from ``src/repro_torch/kernels/csrc`` and the latency probe with ``nvcc``
(in parallel; one ``[build]`` line per source gives each kernel's registers
and spill bytes; a spill in ``quant_mlp``, the segment kernels or the probe
fails the run), then runs these phases, one line each:

  1. device   the card's name and power limit (``nvidia-smi``); TF32 off
  2. node_mlp kernel vs plain PyTorch version on the card, GIN's five
              linear shapes at M = 4096, the head's 128 and ragged M, every
              activation (|kernel - plain| <= 1e-5 + 1e-5 |plain|: the same
              fp32 FMAs summed in another order); each case runs on the
              variant ``node_mlp.variant`` names (narrow at N = 1, shallow
              at K 3 and 9, tiled at K 100 and 200)
  3. fused_mp kernel vs plain version for every fp32 gamma at the paper
              widths (32 rows a block; GCN 16) and PNA at F = 100 (K1 1200:
              16 rows a block, asserted), N = 4096, E = 12288, with
              isolated nodes, padding edges and an all-padding edge list,
              then one graph at each N of TILE_CASES: 1, 31, 33 and 4097
              cut a 16- and a 32-row tile, and 1000 real nodes of 4096
              leave their last tiles all padding, then each rank's
              window of a plan sharded over 2 ranks (its n / 2 rows, a
              source table of all n rows, rank 1's window past edge 0,
              E_pad slots long with a masked tail past its edges) at
              the sharded bucket (128, 384) and the PubMed size (same
              tolerance; PNA 5e-3, whose std amplifies one rounding of
              sqsum/c - mean^2)
  3b. segment_reduce  kernel vs plain version, all five ops at F in
              {1, 3, 6, 64, 100, 101} (a thread reads float4 at 64 and
              100, float2 at 6, one float at 1, 3 and 101; F = 64 and 100
              also from a view one float past a 16-byte boundary, which
              takes the one-float path and must give the same bits) on
              the same graphs and on a hub graph at N = 4096, E = 12288
              (hubs of 300 and 1000 edges, degrees 0, 1, 16, 17 and 33, then
              0-3; padding edges at the end) (same tolerance, the plain
              version under PyTorch's deterministic algorithms so that its
              ``index_add_`` sums in edge order as the kernel does); a
              second launch gives the same bits
  3c. edge_softmax    kernel vs plain version at H in {1, 4}, logits
              spread +-1 and +-80, on the same graphs and the hub graph,
              whose segments take every path of the kernel (a thread up
              to 16 edges, a warp from registers up to 512, a warp in
              three passes past that) (same tolerance); each segment's
              weights sum to 1 within 1e-5, padding rows are exactly 0; a
              second launch gives the same bits
  4. GIN      served at paper width through ``GNNEngine(fused=True)``:
              32 streamed MolHIV-like graphs and one packed batch of 128
              (the k=64 rung of the (64, 192) ladder), checked against
              the same engine in ``mode="reference"``, the unfused engine
              and the CPU path (rtol 1e-4, atol 1e-5); then 8 graphs
              streamed with int64, then float64 node features (narrowed to
              int32 / float32, as JAX's ``jnp.asarray`` narrows them)
              against the CPU path at the same tolerance
  5. GCN      the same, streamed
  5b. GAT     the same, streamed and packed (node_mlp, edge_softmax,
              segment_reduce: 7, 5 and 5 launches per forward)
  5c. PNA, DGN (with its eigenvector input), GIN+VN: the same, streamed
              (PNA rtol 5e-3)
  3d. quant_node_mlp  both entries vs their plain versions at the (K, N)
              of the six int8 paths (``QMLP_SHAPES``) and M in
              ``QMLP_ROWS`` (ragged 1, 37, 4097 among them), every
              activation (|kernel - plain| <= 1e-6 + 1e-6 |plain|), and
              ``QMLP_WIDE_SHAPES`` (w past one block's shared memory: the
              ring of slices; N = 257: two column blocks): the
              int8 entry with and without row scales (with scale 1 and bias
              0 the output is the exact integer product, int64), the
              dynamic entry on fp32 rows of mixed ranges with all-zero
              rows; each case launched on the entry it names.  The x_q
              probe: the dynamic entry with an identity w_q (K = N in {9,
              100, 200}), w_scale 1, bias 0 outputs x_q * rs, bit for bit
              the plain version's, on all-zero rows (the 1e-8 floor) and on
              rows whose max is 127 * 2^-e and whose values are ties
              (j + 1/2) 2^-e, at M 37 and 4097
  3e. fused_mp int8   kernel vs plain version for the int8 gammas gin
              (F=100, H=200), pna (F=80, and F=100 on 16 rows a block), dgn
              (F=100) at N = 4096, E = 12288 (+ all-padding edges), on
              phase 3's TILE_CASES and its sharded windows, on operands whose aggregates are exact
              in fp32: PNA and DGN bit for bit, GIN within 2e-5 (at N < 4096
              of the plain version run with padding nodes up to 4096 rows
              and cut back: cuBLAS sums its fp32 second linear in another
              order at small M) and bit for bit on probe weights that output
              q * rs
  7. int8     all six models served in int8 (W8A8, dynamic per-node
              scales) with ``fused=True``: GIN streamed and packed, the
              others streamed; each against the same engine in
              ``mode="reference"``, on the CPU, and unfused, within the
              quantization-noise bound MAE(got - want) <= 0.2 MAE(int8 -
              fp32) + 1e-5 (fp32: the same model's fp32 engine on the
              card).  GIN's and GIN+VN's fused layers keep the edge and
              second MLP linears in dequantized fp32, so against their
              unfused engine the bound is JAX's own
              (tests/test_fused_mp.py): MAE(fused - fp32) <= 5 MAE(unfused
              - fp32) + 1e-4
  7b. GIN in int8-static (calibrated on 16 graphs of a disjoint stream) and
              fixed (ap_fixed<16,6>), 8 streamed graphs: within the bound
              of the reference, unfused and CPU engines, no fused_mp
              launch, and with PyTorch's deterministic algorithms (the
              unfused sums' atomics otherwise vary from run to run) fused
              gives the unfused result bit for bit: those linears do not
              lower
  6. graphs   the executor's captured CUDA graphs: all six models
              streamed (32 graphs) in fp32 and int8, GIN and GAT fp32
              packed.  Under PyTorch's deterministic algorithms every
              served output equals a direct eager call of
              ``gnn.models.forward_program`` on the same prepared batch bit
              for bit, the executor captures one graph per distinct
              signature, and a second pass captures none and serves the
              same bits.  On a fresh engine the captured forward's launches
              (the wrappers' counters around ``Executor.warm``, less two
              eager forwards: the direct one and the warm's own) equal one
              eager forward's and pass ``check_launches``, and
              ``torch.profiler`` finds the same kernels, as many of each,
              in one replay.  Each line prints p50 / p99 through the graph
              beside the eager forward's (timed in one loop), device ops a
              forward, the busy share and the capture seconds; the phase
              prints its peak allocated memory.  Then GIN is streamed once
              with a ``Tracer`` and a ``MetricsRegistry`` attached: both
              exports pass the port's validators, the events and counters
              agree with the executor, and the admission line and the
              dispatch census print
  6c. layout  the per-call-sort path (``share_layout=False``): GCN, GIN,
              GAT, PNA, DGN and GIN+VN in fp32 and GAT and GIN in int8 at
              paper width, 32 MolHIV graphs streamed through the executor's
              CUDA graphs with ``fused=True`` (unfused without a plan, as in
              JAX) beside the shared plan's unfused executor.  Under
              PyTorch's deterministic algorithms every per-call output is
              the shared path's bit for bit.  On fresh executors (whose
              ``index_add_`` does not sort): the per-call warms launch no
              fused_mp and every kernel of the unfused path (counters reset
              before, read after); the sort kernels of one replay of each
              path by the profiler (by name; not ``searchsorted``) are in the
              ratio of the ``aten.sort`` calls of one eager forward (shared
              1, per-call one per reduction: GCN / GIN / GIN+VN / GAT 5, PNA
              and DGN 16); GAT's edge_softmax and segment_reduce launches a
              replay equal the shared path's (5 each); p50 / p99 of both
              paths timed in one loop (3 passes of the 32 graphs)
  6b. stream  the stream scheduler and the pipeline at paper width, fused,
              seed-0 params, under PyTorch's deterministic algorithms: GIN
              fp32, GIN int8 and GAT fp32 (one ``GNNEngine`` each) and a
              two-tenant ``Executor`` (GCN int8 + GAT fp32, JAX's verify line
              ``--models gcn:int8,gat:fp32``), 512 graphs of
              ``MoleculeStream(MOLHIV, 0)``, capacity 16 (rungs 1-16x the
              base bucket, up to 32 graph slots), max wait 2 ms.  First a
              flush's top-rung program: its capture launches one eager
              forward's kernels and a replay runs them (``torch.profiler``).
              One-tenant paths: ``PipelinedStream`` (inflight 2, staged and
              not) beside the blocking ``infer_stream`` in one loop, twice
              (the first round on cold stream signatures): outputs bit for
              bit ``infer_stream``'s, peak in flight <= 2.  Then the
              scheduler at loads (a) qps 0, (b) qps 5000, (c) 2x (a)'s
              graphs/s with a 5 ms SLO and admit margin 0.7, each serial and
              with ``PipelineConfig(inflight=2, host_cost="measured")`` and
              with ``PipelineConfig(inflight=1)`` on the serial run's
              compute timeline (``timed_as``):
              served + shed = offered, served outputs within rtol 1e-4 atol
              1e-5 (int8: atol 1e-4) of the per-graph stream, after the
              eager ladder prewarm of the first run no capture and compile
              0 in any later run (both tenants), serial and pipelined flush
              the same requests at (a) (at (b) and (c) each loop closes its
              flushes on its own timeline of measured compute, and the
              count of flushes of the same requests is printed) and every
              request served by both gives the same bits, the depth-1 run
              gives the serial run's flush log, sheds and latencies exactly
              and its outputs bit for bit at every load; run (a)'s flushes
              are served again packed with ``stage=False`` (the
              scheduler's) and ``stage=True``, bit for bit, and the median
              pack and run ms of each are printed; the census
              ``kernels_dispatch_total`` grows by
              (JAX's warm keys) x one forward's census, all on
              path="kernel".  Each line prints graphs/s, p50 / p99, shed
              rate, flushes and their mean size and compute seconds (on the
              scheduler's virtual timeline of measured compute), the
              threaded runs' wall, graphs/s and peak in flight, and the
              busy share over run (a), beside the card and its power limit
  10. coldstart the kernel-library cache (``serve/aot.py``) across processes,
              since this one has loaded ``build/repro_torch/``'s libraries:
              ``python -m repro_torch.launch.serve --gnn gin --fused --stream
              --n-graphs 64 --aot-cache <fresh dir> --prewarm-persist
              --metrics-json ... --trace-out ...`` twice: the first run builds
              (aot_miss > 0 = its nvcc processes, aot_hit 0), the second
              builds nothing (aot_miss = aot_stale = 0, aot_hit > 0, no nvcc
              process) and captures as many graphs; each prints
              ``cold_start_s``, and both runs' artifacts pass ``python -m
              repro_torch.obs.check_artifacts`` and agree with the line.
              Process A serves GIN through the scheduler on a fresh cache and
              saves params, graphs and outputs; process B, given the cache
              and the saved state only, serves the same outputs bit for bit
              (deterministic algorithms) with no miss and no nvcc.  Then
              node_mlp's cached library is truncated and fused_mp's record
              given another driver: a third run counts 1 miss and 1 stale
              entry (2 nvcc processes) and both entries load as hits
              afterwards.  The work directory (``build/coldstart``) is
              removed at the end
  3f. flash_attention kernel vs plain version at ChatGLM3-6B's prefill
              (B 8, Hq 32, Hkv 16 and 2, D 128, S 512, 1, 37, 1000, in the
              serving path's (B, S, H, D) layout) and Gemma-3-12B's layers
              (B 2, Hq 16, Hkv 16 and 8, D 256, S 2048, window 0 and 1024),
              one softcap case, MiniCPM3-4B's MLA prefill, the (D, Dv) =
              (96, 64) instance (H 40, B 2 at S 1, 63, 65 and B 8 at S 1025),
              Whisper-base's decoder prefill (B 8, H 8, D 64 at S 64, 1, 37,
              65: the D 64 instance) and InternVL2-26B's (B 4, Hq 48, Hkv 16
              and 8, D 128, S 1536 and 1100: patches + prompt), in
              fp32 and bf16 (fp32 |kernel - plain| <= 1e-5 + 1e-5 |plain|,
              fp32 products summed in another order; bf16 1.6e-2 + 1.6e-2
              |plain|, two bf16 ulps at 1); each case runs on the route
              ``flash_attention.route`` names (bf16: mma, fp32: simt), and
              the (96, 64) bf16 cases on the simt route too
  9. LM       ChatGLM3-6B served at full width and depth (28 layers, bf16,
              random weights from a CUDA generator seeded 0) through
              ``LMServer.generate``: 8 prompts of 256-512 tokens, prompt_len
              512, cache_len 1024, 32 new tokens.  The first generate warms
              prefill and the decode step eagerly and captures each as a
              CUDA graph (the counters: flash_attention 2 x 28, warm +
              capture, all on the mma route, nothing else); by the
              profiler a prefill replay runs 28 mma flash kernels and a
              decode replay none.  Then 3 runs each of generate (graphs,
              capturing and launching nothing more) and of the eager loop
              of ``lm.prefill`` / ``lm.decode_step``: the same tokens,
              token for token, in every run; against an
              ``LMServer(mode="reference")`` on the same weights the prefill
              logits and the decode logits, teacher-forced on the served
              tokens, agree within max|d| <= 2e-2 max|ref| (JAX's bound,
              tests/test_arch_smoke.py); decode after prefill(S-1) matches
              prefill(S)'s last logits within the same bound; every token
              lies in [0, vocab).  It prints prefill ms and decode ms a
              token, median (min-max) of the runs, graph and eager; device
              ops a decode replay and the busy share over 32 replays (and
              over 8 eager steps); captures, capture seconds, graph-pool
              memory; ``layers.decode_attention`` at the served shape
              beside the JAX form it replaced (repeated fp32 cache) and its
              bytes bound, within bf16 1.6e-2 + 1.6e-2 |JAX form|
  9b. LM      Gemma-3-12B at full width, 6 layers (one 5-local / 1-global
              group): B 2, prompts of 1024-2048 tokens, prompt_len 2048,
              cache_len 2304, 8 new tokens; the same checks, 6 mma launches
              a prefill replay
  9c. LM      StarCoder2-15B at full width (d 6144, 48 / 4 -> 16 heads,
              gelu MLP, tied embedding), 8 of its 40 layers: B 4, prompts of
              512-1024 tokens, prompt_len 1024, cache_len 1280, 16 new
              tokens; the same checks, 8 mma launches a prefill replay
  9m. moe     the MoE family's new code (no kernel of its own): the slot
              helpers (``dispatch_to_slots``, ``rank_within_segment``,
              ``combine_from_slots``) on the card equal the CPU's bit for
              bit at ``MOE_SLOT_CASES`` (the served dispatches, one tied
              segment, a valid mask: CUDA's stable sort); ``moe_apply``
              dispatch vs dense at ample capacity in fp32, JAX's own case
              through the model within 1e-4 and one full-width layer of
              each MoE arch within 1e-4 max|dense|; captured
              ``moe_apply`` at the two archs' served prefill and decode
              shapes and a reduced Qwen3-MoE server's decode replay equal
              their eager calls bit for bit under deterministic algorithms
  9d. LM      Qwen3-MoE-30B-A3B at full width (d 2048, 32 / 4 -> 16 heads,
              QK-norm, 128 experts top-8 renormalized, expert d_ff 768), 8
              of its 48 layers: B 8, prompts of 256-512 tokens, prompt_len
              512, cache_len 1024, 32 new tokens
  9e. LM      Mixtral-8x7B at full width (d 4096, 32 / 8 -> 16 heads, 8
              experts top-2, d_ff 14336, window 4096), 4 of its 32 layers:
              B 2, prompts of 4352-5120 tokens (prefill runs past the
              window), prompt_len 5120, cache_len 5376, 8 new tokens.
              9d and 9e run the checks of 9-9c, and: the reference mode's
              router picks other experts than the kernel path's where two
              nearly tie (the attentions differ by bf16 roundings), so
              the differing token routings, their largest logit gap and
              the free-routing errors are printed, and the reference runs
              again teacher-forced on the kernel path's routing (its own
              router weights on the kernel path's experts), which is held
              to the bound; decode after prefill(S-1) against prefill(S)
              runs as JAX's test does, in fp32 (the weights cast) at
              capacity factor max(8, E / k) (JAX's test's 8, or the factor
              at which a row's capacity holds every token), on prefill(S)'s
              routing, and is printed in bf16; they print the share of a prefill's (token,
              expert) assignments kept at capacity.  Every LM path prints
              its decode step's weight-read floor (every weight but the
              embedding's rows; an MoE step reads every expert's)
  9f. LM      MiniCPM3-4B at full width, 16 of its 62 layers (MLA: q_lora
              768, kv_lora 256, nope 64 + rope 32, v 64, 40 heads): B 8,
              prompts of 512-1024 tokens, prompt_len 1024, cache_len 1280,
              32 new tokens; the checks of 9-9c, 16 mma flash launches a
              prefill replay, all at (96, 64); the absorbed decode
              (``layers.mla_decode_attention``) a layer beside the JAX form
              (fp32 cache copies) and its bytes bound
  9g. LM      Jamba-v0.1 at full width, 8 of its 32 layers (one period: 7
              Mamba + 1 attention, 4 MoE layers of 16 experts top-2 and 4
              dense): B 4, prompts of 512-1024 tokens, prompt_len 1024,
              cache_len 1280, 16 new tokens; the checks of 9d / 9e, 1 mma
              flash launch a prefill replay
  9h. LM      RWKV6-1.6B at full width and depth (24 layers, no
              attention): B 8, prompts of 256-512 tokens, prompt_len 512,
              cache_len 576, 32 new tokens; the checks of 9-9c, no flash
              launch (its prefill graph holds the per-token scan: 3
              kernels a token a layer)
  9i. LM      InternVL2-26B at full width, 12 of its 48 layers (48 / 8 ->
              16 heads, D 128, SwiGLU d_ff 16384; all 48: 19.86 B
              parameters, ~40 GB in bf16): B 4, 1024 patch embeddings (float32 normal
              draws of the path's generator, the stubbed vision
              frontend's output, JAX's ``extras``) before prompts of
              256-512 tokens, prompt_len 512, cache_len 1600, 32 new
              tokens; the checks of 9-9c with the patches in every call
              (decode starts at 1024 + 512), 12 mma flash launches a
              prefill replay over 1536 positions; decode after
              prefill(S-1) in bf16 on the served weights, as at full
              depth, where an fp32 copy does not fit; the init's peak memory (each leaf
              cast to bf16 as drawn) and the run's
  9j. LM      Whisper-base at its full config (6 encoder + 6 decoder
              layers, d 512, 8 heads, D 64, vocab 51865, 1500 frames): B 8,
              1500 frame embeddings (float32 normal draws, the stubbed conv
              frontend's output) through the bidirectional encoder inside
              the prefill graph, prompts of 16-64 tokens, prompt_len 64,
              cache_len 448 (Whisper's text context), 32 new tokens; the
              checks of 9-9c, 6 mma flash launches a prefill replay on the
              D 64 instance, the decode graph reading the cross K/V from
              the cache; its weight-read floor counts what a step reads:
              the decoder's weights, the tied head and the cross K/V, not
              the encoder
  11. flash_attention bwd  gradients through the kernel
              (``kernels.ops.FlashAttention``: the kernel's forward, the
              plain ``flash_attention_bwd_ref`` backward) against autograd
              of the plain forward on fp32 copies of the same inputs, dq /
              dk / dv at FLASH_TOL, at ChatGLM3's
              train shape (B 8, Hq 32, Hkv 2, S 1024, D 128, bf16, causal),
              MiniCPM3's (96, 64), Gemma-3's window + softcap layer and one
              fp32 (simt) case; the Function's forward and backward times at
              the train step's shape (Hkv 16 after kv_pad_to) beside SDPA's
              forward + backward
  11b. train  ChatGLM3-6B at full width, 8 of its 28 layers (2.17 B
              parameters, bf16, remat on), 6 steps of
              ``train.loop.make_train_step`` (AdamW, fp32 moments) on
              SyntheticTokens at B 8 x S 1024: per step loss, grad_norm,
              lr, ms, tokens/s, the share of the card's bf16 peak, peak
              memory and flash launches (16: 8 layers x forward + remat
              recompute); the first step's loss and grad_norm against
              reference mode on a copy of the weights (TRAIN_LOSS_TOL,
              TRAIN_GNORM_RTOL), and a finite, non-zero gradient on every
              leaf
  11c. train loop  ``train.loop.train`` on a reduced ChatGLM3 (D 64, bf16)
              for 40 steps, a checkpoint every 10 and a failure injected at
              step 25: it recovers from step 20 and its loss falls; a restore
              onto the card equals the live tree bit for bit; the launcher
              (``python -m repro_torch.launch.train --arch rwkv6-1.6b
              --reduced --steps 3``) as a child process prints ``done``
  12. mesh    the multi-rank substrate (``repro_torch.runtime``) and the
              sharded GNN path, in worlds of this script's own child
              processes (``--mesh-rank``; rendezvous through a file under
              build/mesh): (a) 2 gloo ranks, both on the card (NCCL
              refuses two ranks of one communicator on one GPU), and (b)
              a 1-rank NCCL world.  Each: ``make_sharded_mp``, both
              strategies, on tests/test_distributed.py's data (seed 0)
              and on a PubMed-sized graph (19,717 nodes, 88,648 edges, F
              100) against the dense sum within 1e-5, and
              ``compressed_psum`` within JAX's 0.02.  (a) then serves the
              six models at paper width through ``GNNEngine(mesh=...)``,
              32 MolHIV-like graphs 4 to a (128, 384) bucket (both ranks
              hold real rows), against the unsharded engine (rtol 1e-4,
              atol 1e-5); a node task's outputs of one batch sharded
              against whole, bit for bit under deterministic algorithms
              (every reduction per destination in the plan's edge order;
              GIN+VN's pool within the tolerance); fused_mp (GAT:
              edge_softmax, segment_reduce) and node_mlp launched on every
              rank; GIN fp32 and int8 packed through the StreamScheduler;
              GIN fp32 as a stream with arrivals (500 qps, max-wait 4 ms),
              each rank measuring its own flush times, one schedule on
              both ranks (each flush's time the slowest rank's); one GIN
              forward (500 features, node task) on a synthetic
              PubMed-sized graph, served through ``Executor.run`` sharded
              (eager on gloo) and whole (captured), timed there, and run
              directly sharded against whole bit for bit under
              deterministic algorithms.  The sharded forward reads nothing
              back to the host (each rank's window of the plan E_pad slots
              long).  It prints sharded p50 beside unsharded, bytes
              all-gathered a layer, and whether each executor captured (a
              gloo mesh of several ranks: eager; the unsharded and the
              1-rank NCCL mesh engine: captured); the node task served
              through ``Executor.run`` sharded and whole, bit for bit.
              ``--gnn-mesh-cards 4`` (four cards, not in the default run)
              runs (a) on a 4-rank NCCL world, every sharded executor
              captured (each a replay's kernels and NCCL kernels by the
              profiler), the PubMed-sized GIN sharded captured, sharded
              eager and whole, then the hang case in a world of its own
              (``HANG_REPLAYS`` replays, their harvests with the timing
              all-reduces, a barrier, no synchronize, ``HANG_ROUNDS``
              times, killed past ``HANG_TIMEOUT_S``; then the executor
              freed before ``destroy_process_group``), and the launcher
              with ``--gnn-mesh 4``
              (``captured=True``).
              Phase 3 holds fused_mp (fp32 and int8) on each rank's
              window of a plan sharded over 2, its source table 2x its
              rows, at the (128, 384) bucket and the PubMed size.  (c)
              The launcher (``--gnn gin --batched --gnn-mesh 2``) as a
              child process prints its mesh line with ``backend=gloo``
  13. mesh train  the LM train loop's mesh branch (``train.loop``'s
              pieces: ``runtime.place_tree`` / ``place_batch``,
              ``make_train_step`` in ``mesh_scope``), ChatGLM3-6B's widths
              (d 4096, 32 -> 16 heads by kv_pad_to, d_ff 13696, vocab 65024)
              cut to 2 of 28 layers in fp32 and 4 in bf16, Qwen3-MoE-30B-A3B's
              (128 experts top-8) cut to 2 of 48 in fp32 (so that routing
              does not flip), B 4 x S 1024, remat on, SyntheticTokens.  The
              unsharded step runs first on this process (each model freed
              before the next); then 2 gloo ranks sharing the card (this
              script's children, ``--mesh-job train``) on a 1x2 mesh under
              ``batch_rules`` (fp32 checks and bf16) and ``fsdp_rules``
              (bf16), and a 1-rank NCCL world (1x1), on the same weights (a
              CUDA generator seeded 0) and batches.  fp32: the first step's
              loss (and the dense model's grad_norm) within 1e-4 relative of
              the unsharded step's; bf16: each of 3 steps' loss within 5e-3.
              Each ``[mesh train ...]`` line prints per rank ms a step,
              tokens/s, peak GB, flash launches a step (8: 4 layers, forward
              + remat) and the bytes each collective kind moves in a step
              (``roofline.CollectiveRecorder``, as ``CommDebugMode`` counts them); every
              rank must launch the flash kernel.  ``--train-mesh-cards 4``
              (four cards, not in the default run) runs 8 layers at B 8 on a
              2x2 NCCL mesh, both presets, and the launcher there
  13b. mesh decode  one decode step on 2 gloo ranks sharing the card
              (real CUDA tensors, fp32) against the one-rank step on the
              same prefilled cache, at the published widths with the depth
              cut: MiniCPM3-4B, 2 layers (MLA: its latent caches whole on
              "model" with q's heads cut there, 1x2, and cut on batch, 2x1)
              and a batch-1 Mixtral-8x7B, 1 layer, whose caches are cut on
              their positions (2x1, a cache of 8448: slot t written on the
              rank that holds it, the 4096 window masking rank 0's block
              wholly, the softmax combined across the ranks); logits within
              1e-5 of their largest, every cache within 1e-6, no NaN
  14. dryrun  the dry-run and the roofline on fake tensors in child
              processes (no card): phase 11b's train cell and phase 9's
              decode on one rank beside their measurements, ChatGLM3-6B
              ``train_4k`` and the decode cells of ``DRYRUN_DECODE_CELLS``
              (ChatGLM3-6B and MiniCPM3-4B ``decode_32k``, Mixtral-8x7B
              ``long_500k``) on a fake 16x16 world of 256 ranks (each
              decode cell writes and attends on each rank's block of the
              cache: it must run and gather no cache), and the GNN
              large-graph layer
  15. gnn train  gradients through the GNN kernels
              (``kernels/ops.py:KernelFunction``): the six models at paper
              width, fp32, unfused and fused (GAT unfused), and GIN int8
              (dynamic) fused and unfused, on 16 MolHIV graphs padded to
              (1024, 3072); every parameter leaf's gradient in mode
              ``kernel`` against mode ``reference`` (``GNN_GRAD_TOL``),
              finite, non-zero wherever the reference's is, every kernel
              output under grad from the Function, and node_mlp, fused_mp
              (fp32, int8), segment_reduce, edge_softmax and quant_node_mlp
              launched; ``examples/torch_train_gin_molhiv.py``'s ``main``
              for ``GNN_TRAIN_STEPS`` steps in this process (its loss
              falls; ms a step by CUDA events, the median past the first
              5); then the other three ``examples/torch_*.py`` as child
              processes on the card, at once (each must exit 0 and print
              no NaN)
  8. kernels  launch counts of each path (counters reset just before each
              serve phase and read just after; a wrapper counts where it
              runs: the eager warm forward and the launches recorded into
              the capture, one of each per signature, while a replay runs
              no wrapper, so phase 6's profiler counts give the launches
              per replay, ``launches_per_replay``), and at the packed batch's
              shapes each kernel's time beside its plain version's, the
              library call's (node_mlp: ``torch.addmm`` + relu, at the
              tiled shape (4096, 100 -> 200) in ALT_ROUNDS alternating
              rounds with the kernel, their medians and ranges printed;
              segment_reduce: ``torch.segment_reduce``; quant_node_mlp:
              ``torch._int_mm`` + the epilogue in torch) and the card's
              bound; segment_reduce and edge_softmax also beside
              ``floor_ms``, the time of ``csrc/latency_probe.cu`` on the
              kernel's own grid (each thread loads its destination's two
              offsets and writes one float: the least a launch of that
              shape takes); quant_node_mlp's int8 entry at the encoder's
              and the unfused MLP's shapes, its dynamic entry at the same
              shapes against the composition it replaced (the row
              quantization's eager ops, then the int8 entry), beside the
              probe on its 128 blocks (fused_mp fp32 at GIN's, PNA's and GCN's shapes, int8
              at GIN's and PNA's, each with its destinations per block and
              its live tiles); flash_attention at ChatGLM3's prefill shape,
              Gemma-3's global layer, MiniCPM3's MLA prefill, InternVL2's
              prefill and Whisper's decoder prefill (bf16,
              causal; the (96, 64) instance its own kernels row) against
              ``scaled_dot_product_attention``, and there the CUDA-core
              (simt) route forced on the same bf16 tensors, the design the
              mma route replaces on this path; its launches per replay
              include the LM programs' (a prefill replay one an attention
              layer, a decode replay 0); and the E_pad window's edge work
              at the PubMed size (``time_window_edges``: the whole plan's
              88648 slots against a rank's share on 2 and 4 ranks)

It prints its total seconds, the card line and a JSON object of the
kernels before the last line, and ends with ``{"ok": true, "device": {...}}``.  Any mismatch or
exception exits non-zero; without CUDA it exits 1 and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS under PyTorch's deterministic algorithms (phase 9m) needs its
# workspace set before the first GEMM of the process: 8 buffers of 4 MiB
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 on CUDA cores, int8 and
# bf16 on the tensor cores, HBM3; the port's model of costs holds them
from repro_torch.roofline import (  # noqa: E402
    PEAK_BF16_FLOP_S,
    PEAK_FP32_FLOP_S,
    PEAK_HBM_BYTES_S,
    PEAK_INT8_OPS,
)
TOL = dict(rtol=1e-5, atol=1e-5)
PNA_TOL = dict(rtol=5e-3, atol=5e-3)
SERVE_TOL = dict(rtol=1e-4, atol=1e-5)
QMLP_TOL = dict(rtol=1e-6, atol=1e-6)
INT8_TOL = dict(rtol=0.0, atol=2e-5)
FLASH_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
             "bfloat16": dict(rtol=1.6e-2, atol=1.6e-2)}
LM_BOUND = 2e-2  # max|kernel - reference| <= LM_BOUND * max|reference|
# the LM serving phases: (arch, config overrides, ServeConfig, prompt lengths)
LM_PATHS = (("chatglm3-6b", {}, dict(max_batch=8, prompt_len=512, cache_len=1024,
                                     max_new_tokens=32), (256, 512)),
            ("gemma3-12b", dict(num_layers=6),
             dict(max_batch=2, prompt_len=2048, cache_len=2304, max_new_tokens=8),
             (1024, 2048)),
            ("starcoder2-15b", dict(num_layers=8),
             dict(max_batch=4, prompt_len=1024, cache_len=1280, max_new_tokens=16),
             (512, 1024)),
            ("qwen3-moe-30b-a3b", dict(num_layers=8),
             dict(max_batch=8, prompt_len=512, cache_len=1024, max_new_tokens=32),
             (256, 512)),
            # prompts past the 4096 window
            ("mixtral-8x7b", dict(num_layers=4),
             dict(max_batch=2, prompt_len=5120, cache_len=5376, max_new_tokens=8),
             (4352, 5120)),
            # MLA: the flash kernel's (96, 64) instance in every layer; 16
            # of the 62 (all 62: ~97 s of the run)
            ("minicpm3-4b", dict(num_layers=16),
             dict(max_batch=8, prompt_len=1024, cache_len=1280, max_new_tokens=32),
             (512, 1024)),
            # one period of the hybrid: 7 Mamba + 1 attention layer, 4 MoE
            ("jamba-v0.1-52b", dict(num_layers=8),
             dict(max_batch=4, prompt_len=1024, cache_len=1280, max_new_tokens=16),
             (512, 1024)),
            # attention-free: no kernel on the path; 12 of the 24 layers
            # (all 24: ~69 s of the run)
            ("rwkv6-1.6b", dict(num_layers=12),
             dict(max_batch=8, prompt_len=512, cache_len=576, max_new_tokens=32),
             (256, 512)),
            # VLM: 1024 patches before the prompt; 12 of the 48 layers (all
            # 48: ~40 GB of bf16, ~78 s of the run)
            ("internvl2-26b", dict(num_layers=12),
             dict(max_batch=4, prompt_len=512, cache_len=1600, max_new_tokens=32),
             (256, 512)),
            # audio: the encoder over 1500 frames in the prefill graph; the
            # decoder on the flash kernel's D 64 instance
            ("whisper-base", {},
             dict(max_batch=8, prompt_len=64, cache_len=448, max_new_tokens=32),
             (16, 64)))
LM_RUNS = 3  # generate (graphs) and the eager loop, each, per LM path
LM_DECODE: dict = {}  # arch -> phase 9's decode floor and graph decode ms (phase 14)
# the decode-after-prefill check of an MoE path runs as JAX's
# tests/test_arch_smoke.py:47-57 does, in fp32 (on a copy of the weights)
# and where neither run drops a token: at capacity factor 8, or E / k where
# that is larger (a row's capacity then holds every token: Qwen3-MoE's 16;
# its padded prompt rows route their pad tokens alike, and at 8 one expert
# of a row overflows 256 slots)
MOE_CHECK_CF = 8.0
# phase 9m: (segments, elements, capacity, share valid) of the slot helpers
# on the card against the CPU: the served dispatches (Qwen3-MoE prefill B 8
# x S 512 x top-8 on 128 experts x 8 rows, its decode; Mixtral prefill
# B 2 x S 5120 x top-2 on 8 experts x 2 rows, its decode), one segment for
# all (every key tied), a valid mask
MOE_SLOT_CASES = ((1024, 32768, 40, None), (1024, 64, 8, None),
                  (16, 20480, 1600, None), (16, 4, 8, None), (1, 5000, 64, None),
                  (64, 20000, 300, 0.6))
MOE_DENSE_BOUND = 1e-4  # dispatch vs dense, fp32 (tests/test_train_serve.py:94)
# phase 11: (name, B, Hq, Hkv, S, D, Dv, window, softcap, dtype)
FLASH_BWD_CASES = (("chatglm3-6b train", 8, 32, 2, 1024, 128, 128, 0, 0.0, "bfloat16"),
                   ("minicpm3-4b mla", 2, 40, 40, 1024, 96, 64, 0, 0.0, "bfloat16"),
                   ("gemma3-12b local + softcap", 2, 16, 8, 2048, 256, 256, 1024, 30.0,
                    "bfloat16"),
                   ("fp32 simt", 2, 8, 2, 512, 64, 64, 0, 0.0, "float32"))
FLASH_BWD_TIME_SHAPE = (8, 32, 16, 1024, 128)  # the train step's (kv_pad_to 16)
FLASH_BWD_REPS = 5
# phase 11b: ChatGLM3-6B at full width, 8 of 28 layers, B 8 x S 1024
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "chatglm3-6b", 8, 8, 1024, 6
TRAIN_REPLAYS = 3  # then the step as one CUDA graph: the warm step, the capture, replays
TRAIN_LOSS_TOL = 1e-2  # |loss kernel - reference| on the first batch, bf16
TRAIN_GNORM_RTOL = 2e-2  # |grad_norm kernel - reference| / reference
# phase 11c: the loop on a reduced ChatGLM3 (D 64: the mma instance)
LOOP_STEPS, LOOP_CKPT_EVERY, LOOP_FAIL_AT = 40, 10, 25
LOOP_RTOL = 1e-5  # captured vs eager train(), each history row, relative
# (K, N) of every linear the six int8 paths quantize: the encoders (9 ->
# 100, 64, 80), GIN's edge embedding and MLP (also GIN+VN's virtual-node
# MLPs), GCN's lin, GAT's proj, PNA's pre / post, DGN's post
QMLP_SHAPES = ((9, 100), (3, 100), (100, 200), (200, 100), (100, 100),
               (9, 64), (64, 64), (9, 80), (80, 80), (960, 80), (300, 100))
# M: the packed plan's nodes and edges, the smallest stream bucket, the
# packed batch's graphs (the virtual-node MLPs), ragged
QMLP_ROWS = (4096, 12288, 32, 128, 1, 37, 4097)
# (K, N) past every path's width: w no longer fits one block whole (the ring
# of slices), and N past one block's 256 columns
QMLP_WIDE_SHAPES = ((2000, 256), (300, 257))
TIMING_REPS = 50
# GIN's linears as (K, N): encoder, edge embedding, MLP in/out, head
GIN_LINEARS = ((9, 100), (3, 100), (100, 200), (200, 100), (100, 1))
PACKED = dict(n_pad=4096, e_pad=12288, g_pad=128)
# (n_pad, n_real) of one graph: N that cuts fused_mp's 16- and 32-row
# tiles, and a graph whose last tiles hold only padding rows
TILE_CASES = ((1, 1), (31, 31), (33, 33), (4097, 4097), (4096, 1000))
# (gamma, F) of the fused_mp checks: the paper widths (32 rows a block, GCN
# 16), and PNA at F = 100 (K1 1200), whose 32 rows would pass 227 KB of
# shared memory: 16 rows a block in both precisions
FUSED_WIDTHS = (("gcn", 100), ("gin", 100), ("pna", 80), ("dgn", 100), ("pna", 100))
INT8_FUSED_WIDTHS = (("gin", 100), ("pna", 80), ("dgn", 100), ("pna", 100))
SEGMENT_OPS = ("sum", "mean", "sqsum", "max", "min")
# F of phase 3b: float4 (64, 100), float2 (6) and one-float (1, 3, 101) reads
SEGMENT_WIDTHS = (1, 3, 6, 64, 100, 101)
# sources whose every instance must build without spills
NO_SPILL_SOURCES = ("quant_mlp", "segment_reduce", "edge_softmax", "latency_probe")
PROBE_THREADS = 256  # csrc/latency_probe.cu's block
# the kernels each served path must launch, by precision (int8 paths keep
# the fp32 head on node_mlp; fused_mp_int8 counts fused_mp's int8 gammas)
PATH_KERNELS = {"gin": ("node_mlp", "fused_mp"), "gcn": ("node_mlp", "fused_mp"),
                "gat": ("node_mlp", "edge_softmax", "segment_reduce"),
                "pna": ("node_mlp", "fused_mp"), "dgn": ("node_mlp", "fused_mp"),
                "gin_vn": ("node_mlp", "fused_mp")}
INT8_PATH_KERNELS = {
    "gin": ("quant_node_mlp", "node_mlp", "fused_mp_int8"),
    "gcn": ("quant_node_mlp", "node_mlp", "fused_mp"),
    "gat": ("quant_node_mlp", "node_mlp", "edge_softmax", "segment_reduce"),
    "pna": ("quant_node_mlp", "node_mlp", "fused_mp_int8"),
    "dgn": ("quant_node_mlp", "node_mlp", "fused_mp_int8"),
    "gin_vn": ("quant_node_mlp", "node_mlp", "fused_mp_int8"),
}
# int8-static and fixed GIN layers do not lower into fused_mp
UNFUSABLE_PATH_KERNELS = {"int8-static": ("quant_node_mlp", "node_mlp"),
                          "fixed": ("node_mlp",)}
# phase 6: (model, precision, packed) served through captured CUDA graphs
GRAPH_PATHS = tuple((m, prec, False) for prec in ("fp32", "int8")
                    for m in ("gin", "gcn", "gat", "pna", "dgn", "gin_vn")) + (
    ("gin", "fp32", True), ("gat", "fp32", True))
GRAPH_STREAM = 32
GRAPH_PACKED_REPS = 8
# phase 6c: (model, precision) served on the per-call-sort path
# (share_layout=False) beside the shared plan, 32 streamed graphs each
LAYOUT_PATHS = tuple((m, "fp32") for m in ("gcn", "gin", "gat", "pna", "dgn", "gin_vn")
                     ) + (("gat", "int8"), ("gin", "int8"))
LAYOUT_REPS = 3
# phase 6b: the stream scheduler and the pipeline.  A path is a list of
# (tenant, model, precision); one tenant serves through a GNNEngine, two
# through one Executor (JAX's verify line --models gcn:int8,gat:fp32)
STREAM_PATHS = ((("default", "gin", "fp32"),), (("default", "gin", "int8"),),
                (("default", "gat", "fp32"),),
                (("gcn:int8", "gcn", "int8"), ("gat:fp32", "gat", "fp32")))
STREAM_GRAPHS = 512
STREAM_CAPACITY = 16  # rungs 1-16x the base bucket, up to 32 graph slots
STREAM_MAX_WAIT_S = 0.002
STREAM_QPS = 5000.0
STREAM_SLO_S = 0.005  # load (c): 2x the saturation rate of load (a)
STREAM_ADMIT_MARGIN = 0.7
STREAM_INT8_TOL = dict(rtol=0.0, atol=1e-4)  # tests/test_quant.py:352
# kernel symbol in the profiler's records -> the wrapper counter it answers to
KERNEL_SYMBOLS = (("node_mlp_", "node_mlp"), ("fused_mp_kernel", "fused_mp"),
                  ("segment_reduce_kernel", "segment_reduce"),
                  ("edge_softmax_kernel", "edge_softmax"),
                  ("quant_mlp_kernel", "quant_node_mlp"))


def device_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def ptxas_usage(log: str) -> list:
    """[kernel, registers, spill store bytes, spill load bytes] for each
    entry function in an ``nvcc -Xptxas -v`` log; names demangled by
    ``c++filt`` where it is installed."""
    import re

    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append([name, int(m.group(1)), *spill])
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) == len(rows):
        for row, demangled in zip(rows, names):
            row[0] = re.sub(r"^void |\(.*", "", demangled.replace("(anonymous namespace)::", ""))
    return rows


def build_kernels() -> None:
    """Build every CUDA source in parallel; print each kernel's registers
    and spills as ``-Xptxas -v`` reports them.  Raises if an instance in
    ``NO_SPILL_SOURCES`` spills."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    dt = time.perf_counter() - t0
    spilled = []
    for name, log in logs.items():
        rows = ptxas_usage(log)
        usage = [f"{k}: {r} registers, {st}/{ld} bytes spill stores/loads"
                 for k, r, st, ld in rows]
        print(f"[build] {name}.cu: {'; '.join(usage) or 'built'}")
        if name in NO_SPILL_SOURCES:
            spilled += [k for k, _, st, ld in rows if st or ld]
    print(f"[build] {len(logs)} kernel sources built in {dt:.1f}s")
    if spilled:
        raise AssertionError(f"spills in {spilled}")


def close(a, b, tol) -> bool:
    import torch

    return bool(torch.all((a - b).abs() <= tol["atol"] + tol["rtol"] * b.abs()))


def max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def device_ms(fn, reps: int = TIMING_REPS):
    """Median per-call device time of ``fn`` in ms, and the timer used.

    ``torch.profiler`` records the CUDA activity of ``reps`` calls; each
    call issues the same number of device operations, so the records
    split into per-call sums ("profiler-median").  When records are lost
    (the profiler can drop one of a session's), the mean per call over the
    records is given, with their count against the expected one
    ("profiler-mean(n/expected)").  If the profiler records no device
    activity at all, the calls are queued behind a sleeping kernel and
    timed with CUDA events as one back-to-back run ("events-queued": no
    host launch overhead, but the gaps between kernels count)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durs = [e.time_range.elapsed_us() for e in
            sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                   key=lambda e: e.time_range.start)]
    if not durs:
        return queued_ms(fn, reps), "events-queued"
    per_call = max(1, round(len(durs) / reps))
    if len(durs) != per_call * reps:
        # records lost or extra: the mean over the calls they cover
        return (sum(durs) * per_call / len(durs) / 1e3,
                f"profiler-mean({len(durs)}/{per_call * reps})")
    calls = [sum(durs[i * per_call:(i + 1) * per_call]) for i in range(reps)]
    return statistics.median(calls) / 1e3, "profiler-median"


def queued_ms(fn, reps: int = TIMING_REPS) -> float:
    """Per-call ms of ``reps`` calls queued behind a ~50 ms sleeping kernel
    and run back to back, between two CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median per-call time in ms from CUDA events around each call
    (includes the host's launch overhead when the card is idle)."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# sessions of one device_events call; each may replay a decode graph once,
# so at most the smallest max_new_tokens of LM_PATHS (8)
PROFILE_TRIES = 6
PROFILE_KEEP = 2  # sessions that recorded kernels, the larger record kept


class ProfilerLost(AssertionError):
    """Every profiler session of a ``device_events`` call lost its record."""


def device_events(fn, tries: int = PROFILE_TRIES, keep: int = PROFILE_KEEP) -> list:
    """The device records (``torch.profiler`` events on the card) of one
    call of ``fn``, which must launch the same kernels at every call.  The
    profiler can drop single records, a whole session's device activity, and
    several sessions in a row: ``fn`` is profiled until ``keep`` sessions
    have recorded a kernel, and the largest record is returned; a
    session with no kernel is reported; up to ``tries`` sessions in all;
    raises ``ProfilerLost`` if none recorded a kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kept = []
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if any(not e.name.startswith(("Memcpy", "Memset")) for e in events):
            kept.append(events)
            if len(kept) == keep:
                break
            continue
        print(f"[profiler] session {attempt} of {tries} recorded no kernel "
              f"({len(events)} device records)")
    if kept:
        return max(kept, key=len)
    raise ProfilerLost(f"the profiler recorded no kernel in {tries} sessions")


def op_count(fn):
    """Device ops of one call of ``fn`` for a report line, from one profiler
    session, or None where it lost its record (printed as not measured; the
    checks that need the profiler's records use ``device_events``)."""
    try:
        return len(device_events(fn, tries=1))
    except ProfilerLost:
        return None


def busy_share(fn):
    """(share of wall time the card is busy while ``fn`` runs, device
    operations it issued): device time summed by ``torch.profiler`` over
    the wall time of a second, unprofiled run (both end at a synchronise)."""
    import torch

    dev = [e.time_range.elapsed_us() for e in device_events(fn, keep=1)]
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return sum(dev) / 1e6 / (time.perf_counter() - t0), len(dev)


def bound(nbytes: float, flops: float, int8_ops: float = 0.0,
          bf16_ops: float = 0.0):
    """(least ms, "bytes" | "operations") on an H100 SXM: the larger of the
    bytes over the memory rate and the operations over the peak of their
    type (fp32 on CUDA cores, int8 and bf16 on the tensor cores; all must
    run)."""
    t_mem = nbytes / PEAK_HBM_BYTES_S * 1e3
    t_ops = (flops / PEAK_FP32_FLOP_S + int8_ops / PEAK_INT8_OPS
             + bf16_ops / PEAK_BF16_FLOP_S) * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 2


def check_node_mlp(device) -> None:
    import torch
    from repro_torch.kernels import node_mlp as NM
    from repro_torch.kernels import ops as kops

    gen = torch.Generator().manual_seed(1)
    worst, count = 0.0, 0
    ran = dict.fromkeys(NM.VARIANT_CODES, 0)
    for k, n in GIN_LINEARS:
        for m in (4096, PACKED["g_pad"], 1, 37, 4097):
            x = torch.randn((m, k), generator=gen).to(device)
            w = (torch.randn((k, n), generator=gen)
                 * (2.0 / (k + n)) ** 0.5).to(device)
            b = (0.1 * torch.randn((n,), generator=gen)).to(device)
            for act in ("relu", "gelu", "none"):
                before = dict(NM.launches_by_variant)
                got = kops.node_mlp(x, w, b, act, mode="kernel")
                want = kops.node_mlp(x, w, b, act, mode="reference")
                if device.type == "cuda":
                    torch.cuda.synchronize()
                if got.shape != (m, n) or not close(got, want, TOL):
                    raise AssertionError(
                        f"node_mlp ({m},{k})x({k},{n}) {act}: max err "
                        f"{max_err(got, want):.3g}")
                chosen = NM.variant(m, k, n)
                if NM.launches_by_variant != dict(before, **{chosen: before[chosen] + 1}):
                    raise AssertionError(f"node_mlp ({m},{k})x({k},{n}): launches "
                                         f"{NM.launches_by_variant}, expected one {chosen}")
                ran[chosen] += 1
                worst = max(worst, max_err(got, want))
                count += 1
    print(f"[node_mlp] {count} cases (GIN shapes x M in 4096,128,1,37,4097 x "
          f"relu/gelu/none) match the plain version, each on its variant "
          f"{ran}; max abs err {worst:.3g}")


# ------------------------------------------------------------ phase 3


def fused_operands(gen, gamma: str, n: int, e: int, f: int, device,
                   n_src: int | None = None):
    """(MPSpec, operands) for ``gamma`` at width ``f``; weights are glorot
    scaled like the models' (GIN's hidden width is 2f).  The source table
    has ``n_src`` rows (default ``n``: a shard's reads all ranks' rows)."""
    import torch
    from repro_torch.core import message_passing as mp

    rnd = lambda *s: torch.randn(s, generator=gen)
    glorot = lambda a, b: rnd(a, b) * (2.0 / (a + b)) ** 0.5
    kw = dict(msrc=rnd(n if n_src is None else n_src, f), x_res=rnd(n, f))
    if gamma == "gcn":
        spec = mp.MPSpec("copy", ("sum",), "gcn")
        kw["nop"] = rnd(n, 1).abs() + 0.1
    elif gamma == "gin":
        spec = mp.MPSpec("add_relu", ("sum",), "gin")
        kw.update(eop=rnd(e, f), w1=glorot(f, 2 * f), b1=0.1 * rnd(2 * f),
                  w2=glorot(2 * f, f), b2=0.1 * rnd(f))
    elif gamma == "pna":
        spec = mp.MPSpec("copy", ("sum", "sqsum", "max", "min"), "pna")
        kw.update(nop=rnd(n, 3).abs() + 0.5, w1=glorot(12 * f, f),
                  b1=0.1 * rnd(f))
    else:
        spec = mp.MPSpec("copy", ("sum", "wsum"), "dgn")
        kw.update(nop=rnd(n, 1).abs() + 0.1, ew=rnd(e, 1),
                  w1=glorot(3 * f, f), b1=0.1 * rnd(f))
    return spec, {k: v.to(device) for k, v in kw.items()}


def plan_graph(rng, n_pad: int, e_pad: int, all_padding: bool, device):
    """A padded graph with isolated nodes and padding edges (or no real
    edge at all) and its layout plan on ``device``."""
    from repro_torch.core import graph as G
    from repro_torch.core import layout as LY

    n_real = n_pad - 96
    e_real = 0 if all_padding else e_pad - 2048
    # destinations avoid the last 400 real nodes: isolated, but live
    s = rng.integers(0, n_real, e_real).astype(np.int32)
    r = rng.integers(0, n_real - 400, e_real).astype(np.int32)
    nf = rng.normal(size=(n_real, 9)).astype(np.float32)
    ef = rng.normal(size=(e_real, 3)).astype(np.float32)
    g = G.from_numpy(s, r, nf, ef, n_pad=n_pad, e_pad=e_pad, device=device)
    return g, LY.build_layout(g)


def tile_graph(rng, n_pad: int, n_real: int, device):
    """One graph of ``n_real`` nodes (in-degrees 0-3) padded to ``n_pad``,
    and its layout plan on ``device``."""
    from repro_torch.core import graph as G
    from repro_torch.core import layout as LY

    r = np.repeat(np.arange(n_real), rng.integers(0, 4, n_real)).astype(np.int32)
    s = rng.integers(0, n_real, r.size).astype(np.int32)
    g = G.from_numpy(s, r, rng.normal(size=(n_real, 9)).astype(np.float32),
                     rng.normal(size=(r.size, 3)).astype(np.float32),
                     n_pad=n_pad, e_pad=r.size + 7, device=device)
    return g, LY.build_layout(g)


def fused_graphs(rng, device):
    """(name, node mask, plan, source rows) of every fused_mp check: the
    padded 4096 x 12288 graph, its all-padding edge list, ``TILE_CASES``,
    and ``window_plans``."""
    whole = [(f"all_padding={p}", *plan_graph(rng, 4096, 12288, p, device))
             for p in (False, True)]
    whole += [(f"N={n_pad}/{n_real} real", *tile_graph(rng, n_pad, n_real, device))
              for n_pad, n_real in TILE_CASES]
    return ([(what, g.node_mask, lay, g.num_nodes) for what, g, lay in whole]
            + window_plans(rng, device))


def window_plans(rng, device):
    """(name, node mask, plan, source rows) of each rank's window of a plan
    sharded over 2 ranks (``core.message_passing.owned_edges``): the rank's
    n / 2 destination rows read sources from all n, through ``src_sorted``
    values up to n, rank 1's window starts past rank 0's edges, and each
    window is E_pad slots long, its tail past the rank's last owned edge
    masked (destination n / 2, past the CSR offsets' end).  At
    the sharded bucket's shapes (MESH_BATCH's (128, 384), 100 real nodes
    and 300 real edges) and at the PubMed size."""
    from repro_torch.core import graph as G
    from repro_torch.core import layout as LY
    from repro_torch.core import message_passing as MP
    from repro_torch.runtime import partitioning as PT

    out = []
    for n_pad, e_pad, n, e in ((MESH_BATCH[1], MESH_BATCH[2], 100, 300),
                               (PUBMED["n"] + 1, PUBMED["e"], PUBMED["n"], PUBMED["e"])):
        g = G.from_numpy(rng.integers(0, n, e).astype(np.int32),
                         rng.integers(0, n, e).astype(np.int32),
                         rng.normal(size=(n, 9)).astype(np.float32),
                         rng.normal(size=(e, 3)).astype(np.float32),
                         n_pad=n_pad, e_pad=e_pad, device=device)
        lay = LY.build_layout(g)
        for index in (0, 1):
            shard = PT.RowShard(group=None, num_shards=2, index=index, n=n_pad)
            edges = MP.owned_edges(lay, shard)
            local = MP.shard_layout(lay, edges, shard)
            start, owned = int(edges.index[0]), int(edges.owned.sum())
            if index and not start > 0:
                raise AssertionError("window: rank 1's window starts at edge 0")
            if not 0 < owned < e_pad or int(local.offsets[-1]) != owned:
                raise AssertionError(f"window: {owned} owned edges of {e_pad} slots")
            if not int(local.src_sorted[:owned].max()) >= shard.n_local:
                raise AssertionError("window: no source outside the rank's rows")
            out.append((f"rank {index} of 2 at ({n_pad}, {e_pad}), edges "
                        f"[{start}, {start + owned}) then {e_pad - owned} masked slots",
                        shard.rows(g.node_mask), local, n_pad))
    return out


def tile_census(node_mask, f, n_ops, k1, h1, int8) -> dict:
    """fused_mp's destinations per block for a spec, and its tiles: all of
    them, and those holding a live row (the others return first)."""
    from repro_torch.kernels import fused_mp as FM

    rows = FM.rows_for(f, n_ops, k1, h1, int8)
    mask = node_mask.cpu()
    tiles = -(-mask.numel() // rows)
    padded = mask.new_zeros(tiles * rows)
    padded[:mask.numel()] = mask
    return dict(rows=rows, tiles=tiles, live_tiles=int(padded.view(tiles, rows).any(1).sum()))


def check_sixteen_rows() -> None:
    """PNA at F = 100 runs fused_mp's 16-row instance in both precisions."""
    from repro_torch.kernels import fused_mp as FM

    if any(FM.rows_for(100, 4, 1200, 0, int8) != 16 for int8 in (False, True)):
        raise AssertionError("fused_mp: PNA at F=100 does not take 16 rows a block")


def check_fused_mp(device) -> None:
    import torch
    from repro_torch.kernels import ops as kops

    rng = np.random.default_rng(2)
    gen = torch.Generator().manual_seed(3)
    cases = {}
    check_sixteen_rows()
    windows = []
    for what, node_mask, lay, n_src in fused_graphs(rng, device):
        n = node_mask.shape[0]
        if n_src != n:
            windows.append(what)
        for gamma, f in FUSED_WIDTHS:
            spec, kw = fused_operands(gen, gamma, n, lay.src_sorted.shape[0],
                                      f, device, n_src=n_src)
            args = (spec, lay.ids_sorted, lay.offsets, lay.src_sorted,
                    lay.in_degree, node_mask)
            got = kops.fused_mp(*args, mode="kernel", **kw)
            want = kops.fused_mp(*args, mode="reference", **kw)
            if device.type == "cuda":
                torch.cuda.synchronize()
            tol = PNA_TOL if gamma == "pna" else TOL
            padded = ~node_mask
            if (not close(got, want, tol) or not torch.isfinite(got).all()
                    or (bool(padded.any()) and bool(got[padded].abs().max() != 0))):
                raise AssertionError(
                    f"fused_mp {gamma} F={f} ({what}): max err {max_err(got, want):.3g}")
            key = f"{gamma}{f}"
            cases[key] = max(cases.get(key, 0.0), max_err(got, want))
    print(f"[fused_mp] gcn/gin(F=100,H=200)/pna(F=80; F=100 on 16 rows a block)/"
          f"dgn(F=100) at N=4096, "
          f"E=12288 (+ all-padding edges), and at N (real) "
          f"{', '.join(f'{a} ({b})' for a, b in TILE_CASES)}, and on sharded "
          f"windows ({'; '.join(windows)}; msrc 2x the rows), match the plain "
          f"version, max err {' '.join(f'{k}:{v:.2g}' for k, v in cases.items())}")


# ------------------------------------------------------------ phase 3b-c


def segment_graphs(rng, device):
    """(name, graph, plan) of phases 3b-3c at N = 4096, E = 12288: padded,
    all-padding edges, hubs."""
    from repro_torch.kernels import edge_softmax as ES
    from repro_torch.kernels import segment_times as ST

    t = ES.THREAD_EDGES
    if not {t, t + 1, 33, 300, 1000} <= set(ST.HUB_DEGREES) or not ES.WARP_EDGES < 1000:
        raise AssertionError("hub graph: its degrees no longer straddle the kernel's paths")
    return ([(f"all_padding={p}", *plan_graph(rng, 4096, 12288, p, device))
             for p in (False, True)]
            + [("hub", *ST.hub_graph(rng, 4096, 12288, device))])


def plain_in_edge_order(fn):
    """``fn()`` under PyTorch's deterministic algorithms: ``index_add_``
    then sums each segment in edge order (a stable sort, then a sequential
    sum), as the kernel does.  Its atomics otherwise add a hub's values in a
    varying order, and its long sums then differ by more than TOL where
    they are near 0."""
    import torch

    torch.use_deterministic_algorithms(True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(False)


def same_bits(name: str, kern) -> None:
    """A second launch of ``kern`` gives the first one's bits."""
    import torch

    if not torch.equal(kern(), kern()):
        raise AssertionError(f"{name}: two launches differ")


def check_segment_reduce(device) -> None:
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import segment_reduce as SR

    rng = np.random.default_rng(6)
    gen = torch.Generator().manual_seed(7)
    worst = {op: 0.0 for op in SEGMENT_OPS}
    widths = set()
    for what, g, lay in segment_graphs(rng, device):
        n = g.num_nodes
        for f in SEGMENT_WIDTHS:
            values = torch.randn((g.num_edges, f), generator=gen).to(device)
            # the same values, 4 bytes past a 16-byte boundary
            shifted = torch.empty((g.num_edges * f + 1,), device=device)[1:]
            shifted = shifted.view(g.num_edges, f).copy_(values)
            out = torch.empty((n, f), device=device)
            vec = (f, SR.vector_width(f, values, out), SR.vector_width(f, shifted, out))
            if vec[1:] != (4 if f % 4 == 0 else 2 if f % 2 == 0 else 1, 1):
                raise AssertionError(f"segment_reduce F={f}: reads {vec[1:]} floats")
            widths.add(vec)
            for op in SEGMENT_OPS:
                name = f"segment_reduce {op} F={f} ({what})"
                args = (values, lay.ids_sorted, lay.offsets, n, op)
                kern = lambda: kops.segment_reduce(*args, mode="kernel")
                got = kern()
                want = plain_in_edge_order(
                    lambda: kops.segment_reduce(*args, mode="reference"))
                err = checked_err(name, got, want, TOL)
                worst[op] = max(worst[op], err)
                same_bits(name, kern)
                if f in (64, 100) and not torch.equal(got, kops.segment_reduce(
                        shifted, *args[1:], mode="kernel")):
                    raise AssertionError(f"{name}: the one-float path differs")
    print(f"[segment_reduce] sum/mean/sqsum/max/min at F in "
          f"{','.join(map(str, SEGMENT_WIDTHS))} (F, floats a thread reads, "
          f"from the shifted view: {sorted(widths)}), N=4096, E=12288 (+ all-padding "
          f"edges, + hubs of 300 and 1000) match the plain version (its sums in edge "
          f"order): "
          f"{' '.join(f'{op}:{e:.2g}' for op, e in worst.items())}; two launches "
          f"give the same bits, and F=64, 100 from the shifted view too")


def check_edge_softmax(device) -> None:
    import torch
    from repro_torch.core import scatter_gather as sg
    from repro_torch.kernels import ops as kops

    rng = np.random.default_rng(8)
    gen = torch.Generator().manual_seed(9)
    worst = 0.0
    for what, g, lay in segment_graphs(rng, device):
        n, e_real = g.num_nodes, int(lay.offsets[-1])
        for heads in (1, 4):
            for spread in (1.0, 80.0):
                logits = ((torch.rand((g.num_edges, heads), generator=gen) * 2 - 1)
                          * spread).to(device)
                args = (logits, lay.ids_sorted, lay.offsets, n)
                name = f"edge_softmax H={heads} spread {spread} ({what})"
                kern = lambda: kops.edge_softmax(*args, mode="kernel")
                got = kern()
                worst = max(worst, checked_err(
                    name, got, kops.edge_softmax(*args, mode="reference"), TOL))
                same_bits(name, kern)
                if bool(got[e_real:].ne(0).any()):
                    raise AssertionError(f"{name}: a padding row is not 0")
                sums = sg.segment_sum(got, lay.ids_sorted, n)
                live = lay.in_degree > 0
                if (not torch.all((sums[live] - 1).abs() <= 1e-5)
                        or bool(sums[~live].abs().max() != 0)):
                    raise AssertionError(f"{name}: weights do not sum to 1")
    print(f"[edge_softmax] H in 1,4, logits +-1 and +-80, N=4096, E=12288 "
          f"(+ all-padding edges, + hubs of 300 and 1000) match the plain version "
          f"(max abs err {worst:.3g}); weights sum to 1 within 1e-5; padding rows "
          f"are 0; two launches give the same bits")


# ------------------------------------------------------------ phase 3d-e


def qmlp_inputs(gen, m: int, k: int, n: int, device):
    """int8 operands of ``quant_node_mlp`` at (M, K) x (K, N): x_q, w_q,
    per-channel scales, per-row scales and a bias."""
    import torch

    x_q = torch.randint(-128, 128, (m, k), generator=gen, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    scale = torch.rand((n,), generator=gen) * 9e-3 + 1e-3
    rs = torch.rand((m, 1), generator=gen) * 0.1 + 1e-3
    b = 0.1 * torch.randn((n,), generator=gen)
    return [t.to(device) for t in (x_q, w_q, scale, rs, b)]


def dynamic_rows(gen, m: int, k: int, device):
    """fp32 rows of ``quant_node_mlp_dynamic``: normal values at per-row
    ranges from 1e-3 to 1e2, every fifth row all zero (the 1e-8 floor)."""
    import torch

    x = torch.randn((m, k), generator=gen) * 10.0 ** (5 * torch.rand((m, 1), generator=gen) - 3)
    x[::5] = 0.0
    return x.to(device)


def tie_rows(gen, m: int, k: int, device):
    """Rows on which the row recipe must round ties to even: row r (odd)
    holds (j + 1/2) 2^-e for random j in [-127, 126] and one +-127 2^-e, so
    that rs = 2^-e exactly and x / rs = j + 1/2; even rows are all zero."""
    import torch

    x = torch.zeros((m, k))
    for r in range(1, m, 2):
        e = int(torch.randint(-3, 20, (1,), generator=gen))
        j = torch.randint(-127, 127, (k,), generator=gen).float()
        x[r] = (j + 0.5) * 2.0 ** -e
        x[r, int(torch.randint(0, k, (1,), generator=gen))] = (-1) ** (r // 2) * 127 * 2.0 ** -e
    return x.to(device)


def check_entry(entry: str, before: dict) -> None:
    """The last call launched once, on ``entry`` of quant_node_mlp."""
    from repro_torch.kernels import quant_mlp as QM

    if QM.launches_by_entry != dict(before, **{entry: before[entry] + 1}):
        raise AssertionError(f"quant_node_mlp: launches {QM.launches_by_entry} after "
                             f"{before}; expected one on the {entry} entry")


def check_quant_node_mlp(device) -> None:
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import quant_mlp as QM
    from repro_torch.kernels import ref

    gen = torch.Generator().manual_seed(12)
    worst, count = {"static": 0.0, "dynamic": 0.0}, {"static": 0, "dynamic": 0}
    for k, n in QMLP_SHAPES:
        for m in QMLP_ROWS:
            x_q, w_q, scale, rs, b = qmlp_inputs(gen, m, k, n, device)
            x = dynamic_rows(gen, m, k, device)
            for act in ("relu", "gelu", "none"):
                for row_scale in (rs, None):
                    args = (x_q, w_q, scale, b, act)
                    before = dict(QM.launches_by_entry)
                    got = kops.quant_node_mlp(*args, row_scale=row_scale, mode="kernel")
                    check_entry("static", before)
                    worst["static"] = max(worst["static"], checked_err(
                        f"quant_node_mlp ({m},{k})x({k},{n}) {act} "
                        f"row_scale={row_scale is not None}", got,
                        kops.quant_node_mlp(*args, row_scale=row_scale,
                                            mode="reference"), QMLP_TOL))
                    count["static"] += 1
                before = dict(QM.launches_by_entry)
                got = kops.quant_node_mlp_dynamic(x, w_q, scale, b, act, mode="kernel")
                check_entry("dynamic", before)
                worst["dynamic"] = max(worst["dynamic"], checked_err(
                    f"quant_node_mlp_dynamic ({m},{k})x({k},{n}) {act}", got,
                    kops.quant_node_mlp_dynamic(x, w_q, scale, b, act, mode="reference"),
                    QMLP_TOL))
                count["dynamic"] += 1
            # scale 1 (0-d), bias 0: the exact integer product
            got = kops.quant_node_mlp(x_q, w_q, torch.tensor(1.0, device=device),
                                      torch.zeros(n, device=device), "none",
                                      mode="kernel")
            # every partial sum is an integer below 2^53: the float64
            # product is the exact int64 one
            exact = (x_q.double() @ w_q.double()).long()
            if not torch.equal(got.long(), exact) or bool(
                    (got != got.round()).any()):
                raise AssertionError(f"quant_node_mlp ({m},{k})x({k},{n}): the "
                                     "accumulator is not the exact product")
    for k, n in QMLP_WIDE_SHAPES:
        for m in (37, 4097):
            x_q, w_q, scale, rs, b = qmlp_inputs(gen, m, k, n, device)
            x = dynamic_rows(gen, m, k, device)
            for act in ("relu", "none"):
                worst["static"] = max(worst["static"], checked_err(
                    f"quant_node_mlp ({m},{k})x({k},{n}) {act}",
                    kops.quant_node_mlp(x_q, w_q, scale, b, act, row_scale=rs, mode="kernel"),
                    kops.quant_node_mlp(x_q, w_q, scale, b, act, row_scale=rs,
                                        mode="reference"), QMLP_TOL))
                worst["dynamic"] = max(worst["dynamic"], checked_err(
                    f"quant_node_mlp_dynamic ({m},{k})x({k},{n}) {act}",
                    kops.quant_node_mlp_dynamic(x, w_q, scale, b, act, mode="kernel"),
                    kops.quant_node_mlp_dynamic(x, w_q, scale, b, act, mode="reference"),
                    QMLP_TOL))
                count["static"] += 1
                count["dynamic"] += 1
    # the x_q probe: identity weights show the kernel's x_q * rs
    ties = 0
    for k in (9, 100, 200):
        eye = torch.eye(k, dtype=torch.int8, device=device)
        one, zero = torch.ones(k, device=device), torch.zeros(k, device=device)
        for m in (37, 4097):
            x = tie_rows(gen, m, k, device)
            got = kops.quant_node_mlp_dynamic(x, eye, one, zero, "none", mode="kernel")
            want = kops.quant_node_mlp_dynamic(x, eye, one, zero, "none", mode="reference")
            q, rs = ref.quantize_rows(x)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(want, q * rs)):
                raise AssertionError(f"quant_node_mlp_dynamic x_q probe (M={m}, K={k}): "
                                     f"{int((got != want).sum())} outputs differ")
            ties += int(((x / rs).remainder(1.0) == 0.5).sum())
    if ties == 0:
        raise AssertionError("x_q probe: no ties in its rows")
    print(f"[quant_node_mlp] int8 entry: {count['static']} cases (the {len(QMLP_SHAPES)} "
          f"(K, N) of the six int8 paths x M in {QMLP_ROWS} x relu/gelu/none x row "
          f"scales on/off; and {QMLP_WIDE_SHAPES} at M 37/4097) match the plain "
          f"version, max abs err {worst['static']:.3g}; "
          f"scale-1 outputs equal the int64 products; dynamic entry: {count['dynamic']} "
          f"cases (fp32 rows, 1 in 5 all zero) match, max abs err "
          f"{worst['dynamic']:.3g}; x_q probe (identity w_q, K = N in 9/100/200, M "
          f"37/4097, all-zero rows, {ties} ties) bit for bit q * rs; launches by entry "
          f"{QM.launches_by_entry}")


def exact_int8_operands(gen, gamma: str, n: int, e: int, f: int, device,
                        n_src: int | None = None):
    """(MPSpec, operands) of an int8 fused layer whose aggregates are exact
    in fp32: msrc, x_res, eop multiples of 1/8 in [-4, 4], ew powers of
    two, nop multiples of 1/8; w1 int8 with per-column scales; ``n_src``
    as for :func:`fused_operands`."""
    import torch
    from repro_torch.core import message_passing as mp

    eighths = lambda *shape: torch.randint(-32, 33, shape, generator=gen) / 8.0
    h1 = 2 * f if gamma == "gin" else f
    k1 = {"gin": f, "pna": 12 * f, "dgn": 3 * f}[gamma]
    kw = dict(msrc=eighths(n if n_src is None else n_src, f), x_res=eighths(n, f),
              w1=torch.randint(-127, 128, (k1, h1), generator=gen, dtype=torch.int8),
              w1_scale=torch.rand((h1,), generator=gen) * 9e-3 + 1e-3,
              b1=0.1 * torch.randn((h1,), generator=gen))
    if gamma == "gin":
        spec = mp.MPSpec("add_relu", ("sum",), "gin", "int8")
        kw.update(eop=eighths(e, f),
                  w2=torch.randn((h1, f), generator=gen) * (2.0 / (h1 + f)) ** 0.5,
                  b2=0.1 * torch.randn((f,), generator=gen))
    elif gamma == "pna":
        spec = mp.MPSpec("copy", ("sum", "sqsum", "max", "min"), "pna", "int8")
        kw["nop"] = torch.randint(4, 17, (n, 3), generator=gen) / 8.0
    else:
        spec = mp.MPSpec("copy", ("sum", "wsum"), "dgn", "int8")
        sign = torch.randint(0, 2, (e, 1), generator=gen) * 2.0 - 1.0
        kw.update(nop=eighths(n, 1) / 2.0,
                  ew=sign * 2.0 ** torch.randint(-2, 2, (e, 1), generator=gen))
    return spec, {k: v.to(device) for k, v in kw.items()}


def gin_probe(f: int, device) -> dict:
    """int8 GIN weights under which the layer outputs q * rs exactly:
    w1 = [I, -I] (scale 1, bias 0), w2 = [I; -I]."""
    import torch

    eye = torch.eye(f)
    return dict(w1=torch.cat([eye, -eye], 1).to(torch.int8).to(device),
                w1_scale=torch.ones(2 * f, device=device),
                b1=torch.zeros(2 * f, device=device),
                w2=torch.cat([eye, -eye], 0).to(device),
                b2=torch.zeros(f, device=device))


def plain_at_height(args, kw, height: int):
    """The plain ``fused_mp`` of a graph of N < ``height`` nodes, computed
    with ``height - N`` isolated padding nodes appended and cut back to its
    N rows: the same function of the same operands on those rows, with its
    fp32 products at M = ``height``.  cuBLAS sums a product in another order
    at small M (its small-M kernels) than at the packed plan's 4096 rows,
    where GIN's fp32 second linear matches the kernel's K order."""
    import torch
    from repro_torch.kernels import ops as kops

    spec, ids, offsets, src, deg, mask = args
    n, extra = deg.shape[0], height - deg.shape[0]
    grow = lambda t: torch.cat([t, t.new_zeros((extra,) + tuple(t.shape[1:]))])
    node_operands = ("msrc", "x_res", "nop")
    want = kops.fused_mp(
        spec, torch.where(ids >= n, torch.full_like(ids, height), ids),
        torch.cat([offsets, offsets[-1:].expand(extra)]), src, grow(deg), grow(mask),
        mode="reference", **{k: grow(v) if k in node_operands else v for k, v in kw.items()})
    return want[:n]


def check_fused_mp_int8(device) -> None:
    import torch
    from repro_torch.kernels import ops as kops

    rng = np.random.default_rng(13)
    gen = torch.Generator().manual_seed(14)
    cases = {}
    check_sixteen_rows()
    for graph, node_mask, lay, n_src in fused_graphs(rng, device):
        n = node_mask.shape[0]
        for gamma, f in INT8_FUSED_WIDTHS:
            spec, kw = exact_int8_operands(gen, gamma, n, lay.src_sorted.shape[0],
                                           f, device, n_src=n_src)
            args = (spec, lay.ids_sorted, lay.offsets, lay.src_sorted,
                    lay.in_degree, node_mask)
            variants = [("random", kw)]
            if gamma == "gin":
                variants.append(("probe", dict(kw, **gin_probe(f, device))))
            for what, operands in variants:
                name = f"fused_mp int8 {gamma} F={f} {what} ({graph})"
                got = kops.fused_mp(*args, mode="kernel", **operands)
                want = kops.fused_mp(*args, mode="reference", **operands)
                if gamma == "gin" and what == "random":
                    # GIN's second linear is fp32: within JAX's 2e-5; at the
                    # TILE_CASES' small N against the plain version run at
                    # the packed plan's height (plain_at_height)
                    if n < PACKED["n_pad"]:
                        want = plain_at_height(args, operands, PACKED["n_pad"])
                    err = checked_err(name, got, want, INT8_TOL)
                else:
                    err = checked_err(name, got, want, dict(rtol=0.0, atol=0.0))
                if (~node_mask).any() and bool(got[~node_mask].abs().max() != 0):
                    raise AssertionError(f"{name}: a padded node row is not 0")
                key = f"{gamma}{f}/{what}"
                cases[key] = max(cases.get(key, 0.0), err)
    print(f"[fused_mp int8] gin(F=100,H=200)/pna(F=80; F=100 on 16 rows a block)/"
          f"dgn(F=100) at N=4096, "
          f"E=12288 (+ all-padding edges), and at N (real) "
          f"{', '.join(f'{a} ({b})' for a, b in TILE_CASES)} and on the sharded "
          f"windows of phase 3 (msrc 2x the rows), exact aggregates: "
          f"pna, dgn and the gin probe (q * rs) bit for bit, gin within 2e-5 "
          f"(at N < 4096 of the plain version run at 4096 rows), "
          f"max err {' '.join(f'{k}:{v:.2g}' for k, v in cases.items())}")


# ------------------------------------------------------------ phase 3f


def attention_inputs(gen, b, hq, hkv, s, d, dtype, device, layout="bhsd", dv=None):
    """q (B, Hq, S, D), k (B, Hkv, S, D), v (B, Hkv, S, Dv) from ``gen`` (Dv
    None: D); "bshd" gives (B, H, S, D) views of (B, S, H, D) tensors, the
    serving path's layout."""
    import torch

    def one(h, width):
        if layout == "bshd":
            return torch.randn((b, s, h, width), generator=gen).to(device, dtype).transpose(1, 2)
        return torch.randn((b, h, s, width), generator=gen).to(device, dtype)

    return one(hq, d), one(hkv, d), one(hkv, dv or d)


def check_flash_attention(device) -> None:
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops as kops

    gen = torch.Generator().manual_seed(17)
    # (B, Hq, Hkv, S, D, window, softcap, layout): ChatGLM3's prefill (with
    # and without kv_pad_to's 16 heads), Gemma-3's local and global layers
    cases = [(8, 32, hkv, s, 128, 0, 0.0, "bshd") for hkv in (16, 2)
             for s in (512, 1, 37, 1000)]
    cases += [(2, 16, hkv, 2048, 256, w, 0.0, "bhsd") for hkv in (16, 8)
              for w in (0, 1024)]
    cases.append((2, 16, 8, 600, 256, 0, 30.0, "bshd"))
    # MiniCPM3's MLA prefill, (D, Dv) = (96, 64), H 40: ragged S
    cases += [(2, 40, 40, s, 96, 0, 0.0, "bshd") for s in (1, 63, 65)]
    cases.append((8, 40, 40, 1025, 96, 0, 0.0, "bshd"))
    # Whisper-base's decoder prefill (the D 64 instance): S 64, ragged
    cases += [(8, 8, 8, s, 64, 0, 0.0, "bshd") for s in (64, 1, 37, 65)]
    # InternVL2-26B's prefill, 1024 patches + 512 tokens (with and without
    # kv_pad_to's 16 heads), and a ragged length
    cases += [(4, 48, hkv, s, 128, 0, 0.0, "bshd") for hkv in (16, 8)
              for s in (1536, 1100)]
    worst, mla_worst = {}, {}
    ran = dict.fromkeys(FA.ROUTE_CODES, 0)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for b, hq, hkv, s, d, window, softcap, layout in cases:
            dv = dict(FA.MLA_HEAD_DIMS).get(d, d)
            q, k, v = attention_inputs(gen, b, hq, hkv, s, d, dtype, device, layout, dv)
            kw = dict(window=window, softcap=softcap)
            case = (f"flash_attention {name} "
                    f"{(b, hq, hkv, s, d, dv, window, softcap, layout)}")
            before = dict(FA.launches_by_route)
            got = kops.flash_attention(q, k, v, mode="kernel", **kw)
            want = kops.flash_attention(q, k, v, mode="reference", **kw)
            err = checked_err(case, got.float(), want.float(), FLASH_TOL[name])
            if got.dtype != dtype or got.shape != (*q.shape[:3], dv):
                raise AssertionError(f"flash_attention: output {got.dtype} {tuple(got.shape)}")
            chosen = FA.route(dtype, d, dv)
            if FA.launches_by_route != dict(before, **{chosen: before[chosen] + 1}):
                raise AssertionError(f"{case}: launches {FA.launches_by_route}, expected "
                                     f"one on the {chosen} route")
            ran[chosen] += 1
            worst[name] = max(worst.get(name, 0.0), err)
            if dv != d:
                mla_worst[f"{name} {chosen}"] = max(mla_worst.get(f"{name} {chosen}", 0.0),
                                                    err)
            if dv != d and chosen == "mma":  # the instance's other route too
                simt = FA.flash_attention(q, k, v, force_route="simt", **kw)
                err = checked_err(f"{case} simt route", simt.float(), want.float(),
                                  FLASH_TOL[name])
                mla_worst[f"{name} simt"] = max(mla_worst.get(f"{name} simt", 0.0), err)
            del q, k, v, got, want
    print(f"[flash_attention] {len(cases)} shapes x fp32/bf16 (ChatGLM3 B=8 Hq=32 "
          f"Hkv 16/2 D=128 S 512/1/37/1000; Gemma-3 B=2 Hq=16 Hkv 16/8 D=256 "
          f"S=2048 window 0/1024; softcap 30; MiniCPM3 (D, Dv) = (96, 64) H=40 B=2 "
          f"S 1/63/65, B=8 S 1025; Whisper B=8 H=8 D=64 S 64/1/37/65; InternVL2 B=4 "
          f"Hq=48 Hkv 16/8 D=128 S 1536/1100) match the plain version, each on its "
          f"route {ran}: "
          f"max abs err " + " ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + "; the (96, 64) instance by route "
          + " ".join(f"{k} {v:.3g}" for k, v in mla_worst.items()))


# ------------------------------------------------------------ phases 4-5c


def _counters() -> dict:
    """Kernel name -> (wrapper module, its launch counter)."""
    from repro_torch.kernels import edge_softmax as ES
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_mp as FM
    from repro_torch.kernels import node_mlp as NM
    from repro_torch.kernels import quant_mlp as QM
    from repro_torch.kernels import segment_reduce as SR

    return {"node_mlp": (NM, "launches"), "fused_mp": (FM, "launches"),
            "segment_reduce": (SR, "launches"),
            "edge_softmax": (ES, "launches"),
            "quant_node_mlp": (QM, "launches"),
            "fused_mp_int8": (FM, "int8_launches"),
            "flash_attention": (FA, "launches")}


def _design_counters() -> dict:
    """Kernel name -> (wrapper module, its launch counts by design)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import node_mlp as NM
    from repro_torch.kernels import quant_mlp as QM

    return {"flash_attention": (FA, "launches_by_route"),
            "node_mlp": (NM, "launches_by_variant"),
            "quant_node_mlp": (QM, "launches_by_entry")}


def reset_launches():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)
    for mod, attr in _design_counters().values():
        setattr(mod, attr, dict.fromkeys(getattr(mod, attr), 0))


def read_launches() -> dict:
    """The launch counts; "<kernel>.<design>" keys split flash_attention
    by route, node_mlp by variant and quant_node_mlp by entry (raises
    unless they sum to the kernel's count)."""
    out = {name: getattr(mod, attr) for name, (mod, attr) in _counters().items()}
    for kernel, (mod, attr) in _design_counters().items():
        split = getattr(mod, attr)
        if sum(split.values()) != out[kernel]:
            raise AssertionError(f"{kernel}: launches by design {split} do not sum "
                                 f"to {out[kernel]}")
        out.update({f"{kernel}.{design}": n for design, n in split.items()})
    return out


def checked_err(name: str, got, want, tol) -> float:
    """Max abs error of a kernel's output against its plain version's;
    raises if they disagree beyond ``tol`` or the output is not finite."""
    import torch

    torch.cuda.synchronize()
    if (got.shape != want.shape or not torch.isfinite(got).all()
            or not close(got, want, tol)):
        raise AssertionError(f"{name}: max err {max_err(got, want):.3g}")
    return max_err(got, want)


def agree(name: str, got, want, tol) -> None:
    import torch

    a, b = torch.as_tensor(np.asarray(got)), torch.as_tensor(np.asarray(want))
    if a.shape != b.shape or not torch.isfinite(a).all() or not close(a, b, tol):
        raise AssertionError(f"{name}: shapes {tuple(a.shape)}/{tuple(b.shape)}, "
                             f"max err {max_err(a, b):.3g}")


def noise_agree(name: str, got, want, fp32) -> float:
    """The quantization-noise bound of a served int8 model:
    MAE(got - want) <= 0.2 MAE(want - fp32) + 1e-5, the noise taken from
    the reference, not from the output under test; returns MAE(got - want)."""
    got, want, fp32 = (np.asarray(a, np.float64) for a in (got, want, fp32))
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{name}: shapes {got.shape}/{want.shape} or not finite")
    mae, noise = np.abs(got - want).mean(), np.abs(want - fp32).mean()
    if mae > 0.2 * noise + 1e-5:
        raise AssertionError(f"{name}: MAE {mae:.3g} > 0.2 x int8 noise {noise:.3g}")
    return float(mae)


def check_launches(model: str, precision: str, launches: dict) -> None:
    """Every kernel of the path ran, in the counts one forward gives."""
    if precision == "fp32":
        need = PATH_KERNELS[model]
    elif precision == "int8":
        need = INT8_PATH_KERNELS[model]
    else:
        need = UNFUSABLE_PATH_KERNELS[precision]
    for kernel in need:
        if launches[kernel] <= 0:
            raise AssertionError(f"{model} {precision}: {kernel} was never launched")
    lq, ln, les = (launches[k] for k in ("quant_node_mlp", "node_mlp", "edge_softmax"))
    if model == "gat" and precision == "fp32" and not (
            les == launches["segment_reduce"] and 5 * ln == 7 * les):
        raise AssertionError(f"gat: launches {launches} are not 7:5:5 per forward")
    if model == "gat" and precision == "int8" and not (
            les == launches["segment_reduce"] and 5 * lq == 6 * les and 5 * ln == les):
        raise AssertionError(f"gat int8: launches {launches} are not 6 quant_node_mlp, "
                             f"1 node_mlp, 5 edge_softmax per forward")
    if model == "gin" and precision == "int8" and not (
            5 * lq == launches["fused_mp_int8"] == launches["fused_mp"]):
        raise AssertionError(f"gin int8: launches {launches} are not 1 quant_node_mlp "
                             f"and 5 int8 fused_mp per forward")
    # int8-dynamic linears launch the dynamic entry, int8-static ones the
    # int8 entry
    entry = {"int8": "dynamic", "int8-static": "static"}.get(precision)
    if entry and launches[f"quant_node_mlp.{entry}"] != lq:
        raise AssertionError(f"{model} {precision}: launches {launches}; not every "
                             f"quant_node_mlp on the {entry} entry")
    if precision != "int8" and launches["fused_mp_int8"]:
        raise AssertionError(f"{model} {precision}: int8 fused_mp ran")
    if precision in UNFUSABLE_PATH_KERNELS and launches["fused_mp"]:
        raise AssertionError(f"{model} {precision}: fused_mp ran; these "
                             f"linears do not lower")


def serve_model(model: str, device, packed_too: bool, precision: str = "fp32",
                n_stream: int = 32) -> dict:
    """Drive the port's main path for ``model`` at ``precision`` and check
    what comes out; returns the path's launch counts (per signature one
    eager warm forward and one capture, the same kernels in the same
    counts: ``check_launches`` reads their ratios)."""
    import torch
    from repro_torch.configs.gengnn_models import get_gnn_config
    from repro_torch.core import batching as B
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream
    from repro_torch.gnn import init
    from repro_torch.serve.gnn_engine import GNNEngine

    cfg = get_gnn_config(model)
    params = init(torch.Generator().manual_seed(0), cfg)
    stream = [g[:4] for g in MoleculeStream(MOLHIV, seed=0).take(n_stream)]
    batch = [g[:4] for g in MoleculeStream(MOLHIV, seed=0).take(128)]
    budget = B.BucketBudget(**PACKED)
    with_eigvec = model == "dgn"
    tol = PNA_TOL if model == "pna" else SERVE_TOL
    # int8-static calibrates on a stream disjoint from the served one
    calib = ([g[:4] for g in MoleculeStream(MOLHIV, seed=97).take(16)]
             if precision == "int8-static" else None)
    keys = ("stream", "packed") if packed_too else ("stream",)

    def engine(cfg_=cfg, fused=True, on=device, precision_=precision):
        return GNNEngine(cfg_, params, precision=precision_, calib_graphs=calib,
                         fused=fused, device=on)

    def run(eng):
        outs, lats, warm = eng.infer_stream(stream, with_eigvec=with_eigvec)
        res = {"stream": np.concatenate(outs), "lats": lats, "warm": warm}
        if packed_too:
            packed, meta = B.pack_graphs(batch, budget, device=eng.device)
            out, dt = eng.infer_packed(packed, budget)
            res["packed"], res["packed_s"] = out[: meta.num_graphs], dt
        return res

    main_engine = engine()
    reset_launches()
    main = run(main_engine)
    launches = read_launches()
    check_launches(model, precision, launches)
    ref_cfg = dataclasses.replace(cfg, kernel_mode="reference")
    checks = {"reference": run(engine(cfg_=ref_cfg)),
              "unfused": run(engine(fused=False)),
              "cpu": run(engine(on="cpu"))}
    errs = []
    if precision == "fp32":
        for what, res in checks.items():
            for key in keys:
                agree(f"{model} {key} vs {what}", main[key], res[key], tol)
    else:
        fp32 = run(engine(precision_="fp32"))
        for what, res in checks.items():
            for key in keys:
                name = f"{model} {precision} {key} vs {what}"
                if what == "unfused" and precision == "int8" and model in ("gin", "gin_vn"):
                    # dequantized fp32 edge / second MLP linears in the fused
                    # layer: JAX's bound (tests/test_fused_mp.py)
                    fu = np.abs(main[key] - fp32[key]).mean()
                    un = np.abs(res[key] - fp32[key]).mean()
                    if not fu <= 5.0 * un + 1e-4:
                        raise AssertionError(f"{name}: fused noise {fu:.3g} > 5 x "
                                             f"unfused noise {un:.3g}")
                    errs.append(f"{what}/{key} noise {fu:.3g} vs {un:.3g}")
                    continue
                else:
                    errs.append(f"{what}/{key} mae {noise_agree(name, main[key], res[key], fp32[key]):.3g}")
        errs.append(f"{precision}-fp32 mae " + "/".join(
            f"{np.abs(main[k] - fp32[k]).mean():.3g}" for k in keys))
    if precision in UNFUSABLE_PATH_KERNELS:
        # the fallback: fused=True runs the unfused layers, bit for bit.
        # index_add_ sums with atomics in a varying order on the card, so
        # this comparison runs both engines with PyTorch's deterministic
        # algorithms
        torch.use_deterministic_algorithms(True)
        try:
            fused_out = run(engine())["stream"]
            unfused_out = run(engine(fused=False))["stream"]
        finally:
            torch.use_deterministic_algorithms(False)
        if not np.array_equal(fused_out, unfused_out):
            raise AssertionError(f"{model} {precision}: fused is not the unfused "
                                 f"result bit for bit")
        errs.append("fused == unfused bit for bit (deterministic algorithms)")
    busy = {}
    if device.type == "cuda":
        busy["stream"] = busy_share(
            lambda: main_engine.infer_stream(stream, with_eigvec=with_eigvec))
        if packed_too:
            packed, _ = B.pack_graphs(batch, budget, device=device)
            busy["packed"] = busy_share(lambda: main_engine.infer_packed(packed, budget))
    lats = main["lats"] * 1e3
    tag = model if precision == "fp32" else f"{model} {precision}"
    line = (f"[{tag}] {'serve' if model == 'gat' else 'fused serve'}: "
            f"{n_stream} graphs streamed, p50 "
            f"{np.percentile(lats, 50):.3f} ms p99 {np.percentile(lats, 99):.3f} ms "
            f"(warm {main['warm']:.2f}s excluded)")
    if packed_too:
        line += (f"; packed 128 graphs ({PACKED['n_pad']}x{PACKED['e_pad']}) "
                 f"in {main['packed_s'] * 1e3:.3f} ms")
    per = {"stream": n_stream, "packed": 1}
    shares = ", ".join(f"{k} {v:.3f} ({ops} device ops, {ops / per[k]:.1f} a forward)"
                       for k, (v, ops) in busy.items())
    quant = main_engine.quant_report
    if quant is not None:
        line += f"; {quant.quantized} linears quantized, {quant.kept_fp32} fp32"
    print(line + f"; matches reference/unfused/cpu{' (' + '; '.join(errs) + ')' if errs else ''}; "
          f"launches {launches}; device busy share: {shares or 'not measured'}")
    return launches


def serve_feature_dtypes(device) -> None:
    """GIN served on the card at paper width, 8 streamed graphs whose node
    features are int64, then float64 (narrowed to int32 / float32 as
    ``jnp.asarray`` narrows them), against the CPU path."""
    import torch
    from repro_torch.configs.gengnn_models import get_gnn_config
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream
    from repro_torch.gnn import init
    from repro_torch.serve.gnn_engine import GNNEngine

    cfg = get_gnn_config("gin")
    params = init(torch.Generator().manual_seed(0), cfg)
    raw = [g[:4] for g in MoleculeStream(MOLHIV, seed=0).take(8)]
    errs = []
    for dtype in (np.int64, np.float64):
        name = np.dtype(dtype).name
        stream = [(s, r, (np.abs(np.rint(4 * nf)) if dtype is np.int64 else nf)
                   .astype(dtype), ef) for s, r, nf, ef in raw]
        reset_launches()
        outs, _, _ = GNNEngine(cfg, params, fused=True, device=device).infer_stream(stream)
        launches = read_launches()
        check_launches("gin", "fp32", launches)
        cpu, _, _ = GNNEngine(cfg, params, fused=True, device="cpu").infer_stream(stream)
        got, want = np.concatenate(outs), np.concatenate(cpu)
        agree(f"gin {name} node features vs cpu", got, want, SERVE_TOL)
        errs.append(f"{name}: max err {float(np.abs(got - want).max()):.3g}, "
                    f"node_mlp {launches['node_mlp']} / fused_mp "
                    f"{launches['fused_mp']} launches")
    print(f"[gin dtypes] 8 graphs streamed with int64, then float64 node "
          f"features (served as int32 / float32) match the cpu path: "
          f"{'; '.join(errs)}")


# ------------------------------------------------------------ phase 6: graphs


def graph_engine(model: str, precision: str, device, executor=None,
                 fused: bool = True, share_layout: bool = True):
    """A GNNEngine of ``model`` at paper width, seed-0 params (fused, on the
    shared plan, unless asked otherwise)."""
    import torch
    from repro_torch.configs.gengnn_models import get_gnn_config
    from repro_torch.gnn import init
    from repro_torch.serve.gnn_engine import GNNEngine

    cfg = get_gnn_config(model)
    where = dict(device=device) if executor is None else dict(executor=executor)
    return GNNEngine(cfg, init(torch.Generator().manual_seed(0), cfg),
                     precision=precision, fused=fused, share_layout=share_layout,
                     **where)


def graph_inputs(ex, model: str, packed: bool) -> list:
    """The prepared batches of a [graphs] path: 32 streamed MolHIV-like
    graphs, or one packed batch of 128 at the (4096, 12288, 128) budget."""
    from repro_torch.core import batching as B
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream

    if packed:
        batch = [g[:4] for g in MoleculeStream(MOLHIV, seed=0).take(128)]
        budget = B.BucketBudget(**PACKED)
        graph, _ = B.pack_graphs(batch, budget, device=ex.device)
        return [ex.prepare_packed(graph, budget)]
    return [ex.prepare_stream(g[:4], with_eigvec=model == "dgn")
            for g in MoleculeStream(MOLHIV, seed=0).take(GRAPH_STREAM)]


def eager_forward(tenant, p):
    """The direct eager call of ``gnn.models.forward_program`` on a prepared
    batch: the path the executor ran before it captured graphs."""
    import torch
    from repro_torch.gnn import models as M

    fn = M.forward_program(tenant.cfg, num_graphs=p.num_graphs,
                           share_layout=tenant.share_layout, fused=tenant.fused)
    with torch.inference_mode():
        return fn(tenant.params, *p.inputs)


def replay_launches(fn) -> tuple:
    """({counter name: launches}, device ops) of one call of ``fn`` as
    ``torch.profiler`` records its device activity: the kernels a graph
    replay runs, mapped to the wrappers' counters by symbol."""
    names = [e.name for e in device_events(fn)]
    counts = {name: 0 for _, name in KERNEL_SYMBOLS}
    for n in names:
        for symbol, name in KERNEL_SYMBOLS:
            if symbol in n:
                counts[name] += 1
    return counts, len(names)


def graphs_equal_eager(model: str, precision: str, packed: bool, device) -> int:
    """Under PyTorch's deterministic algorithms (``index_add_``'s atomics
    otherwise sum in a varying order): every served output equals the
    direct eager forward on the same prepared batch bit for bit; one capture
    per distinct signature; a second pass captures nothing and serves the
    same bits.  Returns the number of signatures."""
    import torch

    torch.use_deterministic_algorithms(True)
    try:
        ex = graph_engine(model, precision, device).executor
        tenant = ex.tenant()
        preps = graph_inputs(ex, model, packed)
        sigs = len({p.signature for p in preps})
        served = [ex.run(p)[0] for p in preps]
        if ex.lowered_count != sigs:
            raise AssertionError(f"{model} {precision}: {ex.lowered_count} captures "
                                 f"for {sigs} signatures")
        for i, (p, out) in enumerate(zip(preps, served)):
            want = eager_forward(tenant, p).cpu().numpy()
            if not np.array_equal(out, want):
                raise AssertionError(f"{model} {precision} batch {i}: served output is not "
                                     f"the eager forward's (max err "
                                     f"{float(np.abs(out - want).max()):.3g})")
        again = [ex.run(p)[0] for p in preps]
        if ex.lowered_count != sigs:
            raise AssertionError(f"{model} {precision}: the second pass captured "
                                 f"{ex.lowered_count - sigs} more graphs")
        if not all(np.array_equal(a, b) for a, b in zip(again, served)):
            raise AssertionError(f"{model} {precision}: the second pass's outputs differ")
    finally:
        torch.use_deterministic_algorithms(False)
    return sigs


def serve_graphs(model: str, precision: str, packed: bool, device) -> dict:
    """One [graphs] path: the bit-for-bit check, then on a fresh engine the
    launches of the captured forward (the wrappers' counters around the
    warm, less two eager forwards': the direct one and the warm's own)
    against the eager forward's and against a replay's kernels by the
    profiler, stream p50 / p99 through the graph and eagerly in one loop,
    device ops per replay and the busy share.  Returns the kernels'
    launches a replay, by counter name."""
    import torch

    sigs = graphs_equal_eager(model, precision, packed, device)
    ex = graph_engine(model, precision, device).executor
    tenant = ex.tenant()
    preps = graph_inputs(ex, model, packed)
    reset_launches()
    eager_forward(tenant, preps[0])
    torch.cuda.synchronize()
    eager = read_launches()
    ex.warm(preps[0])  # an eager forward, then the capture
    captured = {k: n - 2 * eager[k] for k, n in read_launches().items()}
    check_launches(model, precision, captured)
    if captured != eager:
        raise AssertionError(f"{model} {precision}: captured forward launches {captured}, "
                             f"eager {eager}")
    replay, replay_ops = replay_launches(lambda: ex.run(preps[0]))
    if replay != {name: captured[name] for _, name in KERNEL_SYMBOLS}:
        raise AssertionError(f"{model} {precision}: a replay ran {replay} in "
                             f"{replay_ops} device ops, the capture launched {captured}")
    # the int8 gamma runs in fused_mp's own instances, which the profiler's
    # names do not tell apart: a replay runs the launches the capture made
    replay["fused_mp_int8"] = captured["fused_mp_int8"]
    graph_ms, eager_ms = [], []
    for p in preps * (GRAPH_PACKED_REPS if packed else 1):
        graph_ms.append(ex.run(p)[1] * 1e3)
        t0 = time.perf_counter()
        eager_forward(tenant, p)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    busy, ops = busy_share(lambda: [ex.run(p) for p in preps])
    tag = f"{model} {precision}{' packed' if packed else ''}"
    what = (f"1 batch of 128 graphs ({PACKED['n_pad']}x{PACKED['e_pad']}), "
            f"{len(graph_ms)} runs" if packed else f"{len(preps)} graphs streamed")
    pct = lambda xs, q: float(np.percentile(xs, q))
    print(f"[graphs {tag}] {what}: {sigs} signatures, {sigs} captures, 0 new on a "
          f"second pass; served == eager forward bit for bit (deterministic "
          f"algorithms); graph p50 {pct(graph_ms, 50):.3f} p99 {pct(graph_ms, 99):.3f} ms, "
          f"eager p50 {pct(eager_ms, 50):.3f} p99 {pct(eager_ms, 99):.3f} ms; "
          f"{ops / len(preps):.1f} device ops a forward through the graph "
          f"({replay_ops} in one run), busy share {busy:.3f}; capture "
          f"{ex.compile_seconds:.3f}s, warm {ex.warm_seconds:.3f}s; kernels a replay "
          f"{ {k: replay[k] for _, k in KERNEL_SYMBOLS if replay[k]} } = the capture's")
    return replay


def serve_telemetry(device) -> None:
    """GIN fp32 streamed once through an executor with a ``Tracer`` and a
    ``MetricsRegistry`` attached: both exports pass the port's validators,
    the counters agree with the executor, and the admission line prints."""
    from repro_torch.obs import MetricsRegistry, Tracer, default_registry, export
    from repro_torch.serve.clock import RealClock
    from repro_torch.serve.executor import Executor

    tracer, reg = Tracer(RealClock()), MetricsRegistry()
    ex = Executor(device=device, tracer=tracer, metrics=reg)
    eng = graph_engine("gin", "fp32", device, executor=ex)
    preps = graph_inputs(ex, "gin", packed=False)
    for p in preps:
        ex.run(p)
    n_metrics = export.validate_metrics_snapshot(export.metrics_snapshot(reg))
    n_events = export.validate_trace_events(export.trace_events(tracer))
    export.validate_metrics_snapshot(default_registry().snapshot())
    count = lambda name: sum(s.name == name for s in tracer.spans)
    want = {"program_build": len(ex._compiled), "warm": ex.lowered_count,
            "executor_run": len(preps), "unpack_d2h": len(preps)}
    got = {name: count(name) for name in want}
    if got != want or reg.get("serve_warms_total").value() != ex.lowered_count:
        raise AssertionError(f"telemetry: events {got}, expected {want}")
    if abs(reg.get("serve_compile_seconds_total").value() - eng.compile_seconds) > 1e-9:
        raise AssertionError("telemetry: capture seconds disagree with the executor")
    census = default_registry().get("kernels_dispatch_total").series()
    print(f"[telemetry] gin fp32, {len(preps)} graphs streamed with a Tracer and a "
          f"MetricsRegistry: {n_metrics} metrics and {n_events} trace events valid; "
          f"events {got}; device {reg.get('serve_device_seconds_total').value():.4f}s, "
          f"d2h {reg.get('serve_d2h_seconds_total').value():.4f}s; "
          f"{export.admission_line(reg)}; dispatch census "
          f"{ {'/'.join(k): int(v) for k, v in sorted(census.items())} }")


def graph_phase(device) -> dict:
    """Phase 6: every [graphs] path and the telemetry run; prints the peak
    memory the phase allocated."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    out = {}
    for model, precision, packed in GRAPH_PATHS:
        out[(model, precision, packed)] = serve_graphs(model, precision, packed, device)
    serve_telemetry(device)
    print(f"[graphs] peak allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
          f"over the phase, {start / 2**20:.1f} MiB of it held before the phase began "
          f"(one graph and pool per engine and signature)")
    return out


# ------------------------------------------------------------ phase 6c: layout


def sort_kernels(events) -> int:
    """Sort kernels among a session's device records, by name (PyTorch's
    in-place small sorts and CUB's radix sorts; not ``searchsorted``)."""
    return sum("sort" in e.name.lower() and "searchsorted" not in e.name.lower()
               for e in events)


def aten_sorts(fn) -> int:
    """``aten.sort`` calls made by one call of ``fn`` (eager)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket is torch.ops.aten.sort:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def check_percall_launches(model: str, precision: str, launches: dict) -> None:
    """The per-call path runs every layer unfused (no plan, no fused_mp):
    node_mlp (quant_node_mlp too in int8) and, for GAT, its two segment
    kernels in the counts of one forward."""
    if launches["fused_mp"] or launches["fused_mp_int8"]:
        raise AssertionError(f"{model} {precision} per-call: fused_mp ran ({launches})")
    if model == "gat":
        check_launches(model, precision, launches)
        return
    need = ("node_mlp",) + (("quant_node_mlp",) if precision == "int8" else ())
    for kernel in need:
        if launches[kernel] <= 0:
            raise AssertionError(f"{model} {precision} per-call: {kernel} was never "
                                 f"launched")


def layout_pair(model: str, precision: str, device):
    """(shared executor, per-call executor) of ``model``: the shared plan
    unfused, and ``share_layout=False`` with ``fused=True`` (which, without a
    plan, is the same unfused path: the one difference is the sorts)."""
    shared = graph_engine(model, precision, device, fused=False).executor
    percall = graph_engine(model, precision, device, share_layout=False).executor
    return shared, percall


def serve_layout(model: str, precision: str, device) -> dict:
    """One [layout] path: 32 MolHIV graphs streamed through both executors'
    CUDA graphs.  Under deterministic algorithms the per-call outputs equal
    the shared path's bit for bit; then, on fresh executors (without
    deterministic algorithms, whose ``index_add_`` would itself sort), the
    per-call path's launches (counters reset before it, read after), the
    sort kernels of one replay of each path by the profiler beside the
    ``aten.sort`` calls of one eager forward, the segment kernels a replay,
    and both paths' p50 / p99 timed in one loop.  Returns the per-call
    path's kernels a replay, by counter name."""
    import torch

    torch.use_deterministic_algorithms(True)
    try:
        shared, percall = layout_pair(model, precision, device)
        preps = graph_inputs(shared, model, packed=False)
        for i, p in enumerate(preps):
            want, got = shared.run(p)[0], percall.run(p)[0]
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"{model} {precision} graph {i}: per-call output is not the "
                    f"shared path's (max err {float(np.abs(got - want).max()):.3g})")
        sigs = percall.lowered_count
    finally:
        torch.use_deterministic_algorithms(False)
    shared, percall = layout_pair(model, precision, device)
    preps = graph_inputs(shared, model, packed=False)
    for p in preps:  # capture every signature of both outside the counts
        shared.warm(p)
    reset_launches()
    for p in preps:
        percall.warm(p)
    torch.cuda.synchronize()
    launches = read_launches()
    check_percall_launches(model, precision, launches)
    p0 = preps[0]
    s_events, p_events = (device_events(lambda: ex.run(p0)) for ex in (shared, percall))
    s_sorts, p_sorts = sort_kernels(s_events), sort_kernels(p_events)
    a_shared = aten_sorts(lambda: eager_forward(shared.tenant(), p0))
    a_percall = aten_sorts(lambda: eager_forward(percall.tenant(), p0))
    if a_shared != 1 or a_percall < percall.tenant().cfg.num_layers:
        raise AssertionError(f"{model} {precision}: aten.sort a forward, shared "
                             f"{a_shared}, per-call {a_percall}")
    if s_sorts * a_percall != p_sorts * a_shared or not p_sorts:
        raise AssertionError(f"{model} {precision}: sort kernels a replay, shared "
                             f"{s_sorts}, per-call {p_sorts}, not in the ratio of "
                             f"aten.sort a forward {a_shared}:{a_percall}")
    s_replay, s_ops = replay_launches(lambda: shared.run(p0))
    p_replay, p_ops = replay_launches(lambda: percall.run(p0))
    segment = {k: p_replay[k] for k in ("edge_softmax", "segment_reduce")}
    if segment != {k: s_replay[k] for k in segment}:
        raise AssertionError(f"{model} {precision}: per-call segment kernels a replay "
                             f"{segment}, shared {s_replay}")
    if model == "gat" and segment != {"edge_softmax": 5, "segment_reduce": 5}:
        raise AssertionError(f"gat {precision} per-call: {segment} a replay, not 5 each")
    s_ms, p_ms = [], []
    for _ in range(LAYOUT_REPS):
        for p in preps:
            s_ms.append(shared.run(p)[1] * 1e3)
            p_ms.append(percall.run(p)[1] * 1e3)
    pct = lambda xs, q: float(np.percentile(xs, q))
    print(f"[layout {model} {precision}] {len(preps)} graphs streamed, per-call "
          f"(share_layout=False, fused=True: unfused without a plan) vs shared "
          f"(unfused): bit for bit (deterministic algorithms), {sigs} captures; sort "
          f"kernels a replay: shared {s_sorts}, per-call {p_sorts} (aten.sort an eager "
          f"forward: {a_shared}, {a_percall}); graph p50 / p99 ms: shared "
          f"{pct(s_ms, 50):.3f} / {pct(s_ms, 99):.3f}, per-call {pct(p_ms, 50):.3f} / "
          f"{pct(p_ms, 99):.3f} ({len(p_ms)} runs each, one loop); device ops a "
          f"replay: shared {s_ops}, per-call {p_ops}; per-call kernels "
          f"{ {k: p_replay[k] for _, k in KERNEL_SYMBOLS if p_replay[k]} }; segment "
          f"kernels a replay {segment} = shared; warm launches "
          f"{ {k: v for k, v in launches.items() if v and '.' not in k} }")
    return launches, p_replay


def layout_phase(device) -> tuple:
    """Phase 6c: every [layout] path; -> ({path: warm launches}, {path:
    kernels a replay})."""
    launches, replays = {}, {}
    for model, precision in LAYOUT_PATHS:
        name = f"{model} {precision} per-call"
        launches[name], replays[name] = serve_layout(model, precision, device)
    return launches, replays


# ------------------------------------------------------------ phase 6b: stream


def census() -> dict:
    """The process-wide dispatch census, ``{(op, path): count}``."""
    from repro_torch.obs import default_registry

    return dict(default_registry().counter("kernels_dispatch_total").series())


def census_delta(before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in census().items()
            if v != before.get(k, 0.0)}


def stream_target(path, device):
    """(scheduler target, executor) of a stream path at paper width, fused,
    seed-0 params (tenant i of several: seed i, as the launcher seeds them)."""
    import torch
    from repro_torch.configs.gengnn_models import get_gnn_config
    from repro_torch.gnn import init
    from repro_torch.serve.executor import Executor

    if len(path) == 1:
        eng = graph_engine(path[0][1], path[0][2], device)
        return eng, eng.executor
    ex = Executor(device=device)
    for i, (name, model, precision) in enumerate(path):
        cfg = get_gnn_config(model)
        ex.register(name, cfg, init(torch.Generator().manual_seed(i), cfg),
                    precision=precision, fused=True)
    return ex, ex


def warm_keys(ex, tenant) -> int:
    """Warm signatures of ``tenant``'s program records: JAX warm keys, one
    compiled program each (tenants of a path differ in architecture)."""
    return sum(len(cb.warm) for (pk, _, _), cb in ex._compiled.items()
               if pk == ex.tenant(tenant).program_key)


def top_rung_batch(ex, graphs):
    """A host-built prepared batch at the top rung of the (32, 96) ladder,
    staged on the card (an eager forward reads it): as many of ``graphs``
    as fit in (16 x 32, 16 x 96, 32 slots)."""
    from repro_torch.core import batching as B

    budget = B.BucketBudget(STREAM_CAPACITY * 32, STREAM_CAPACITY * 96,
                            2 * STREAM_CAPACITY)
    take, n, e = [], 0, 0
    for g in graphs:
        gn, ge = B.graph_sizes(g)
        if not budget.admits(n, e, len(take), gn, ge):
            break
        take.append(g)
        n, e = n + gn, e + ge
    return B.pack_prepared(take, budget, device=ex.device, stage=True)[0]


def flush_replay_matches_capture(ex, tenant: str, graphs) -> dict:
    """A flush's top-rung program: the capture launches what one eager
    forward launches and ``torch.profiler`` finds those kernels, as many of
    each, in one replay; returns one forward's dispatch census."""
    import torch

    p = top_rung_batch(ex, graphs)
    reset_launches()
    before = census()
    eager_forward(ex.tenant(tenant), p)
    torch.cuda.synchronize()
    one = census_delta(before)
    eager = read_launches()
    reset_launches()
    ex.warm(p, model=tenant)  # an eager forward (its census muted), the capture
    captured = {k: n - eager[k] for k, n in read_launches().items()}
    if captured != eager:
        raise AssertionError(f"stream {tenant}: captured flush launches {captured}, "
                             f"eager {eager}")
    replay, _ = replay_launches(lambda: ex.run(p, model=tenant))
    if replay != {name: captured[name] for _, name in KERNEL_SYMBOLS}:
        raise AssertionError(f"stream {tenant}: a flush replay ran {replay}, the "
                             f"capture launched {captured}")
    if not one or any(where != "kernel" for _, where in one):
        raise AssertionError(f"stream {tenant}: one forward's census {one}")
    return one


def timed_as(ex, seconds=None):
    """Swap ``ex.run`` for one that serves as usual and either records each
    call's measured seconds in the returned list (``seconds`` None) or
    reports ``seconds`` in call order instead of its own, so that a second
    scheduler run sees the first run's compute timeline to the bit.  The
    caller deletes ``ex.run`` afterwards."""
    real, log = ex.run, []

    def run(p, model=None):
        out, dt = real(p, model=model)
        if seconds is not None:
            if len(log) >= len(seconds):
                raise AssertionError(f"{len(log) + 1} flushes, the recorded "
                                     f"timeline has {len(seconds)}")
            dt = seconds[len(log)]
        log.append(dt)
        return out, dt

    ex.run = run
    return log


def flush_rows(rep) -> tuple:
    """The flush log and shed list as plain tuples, less the dispatch
    instant (serial records the device start there, pipelined the
    dispatch), plus the latencies: what a depth-1 pipelined run on the
    serial run's compute timeline must reproduce exactly
    (``tests/test_serve_pipeline.py:120``)."""
    return ([(f.rids, f.reason, f.at_s, f.done_s, f.compute_s) for f in rep.flush_log],
            [(s.rid, s.reason, s.at_s, s.projected_delay_s) for s in rep.shed],
            rep.latencies_s.tobytes())


def stage_flush_ms(ex, sched, rep, graphs) -> tuple:
    """Serve run ``rep``'s flushes again, each packed by ``pack_prepared``
    as the scheduler packs it (``stage=False``: the pinned host batch goes
    to the replay's copies) and with ``stage=True`` (copied to the card
    first, then device to device into the static buffers), alternating,
    three rounds; both outputs must agree bit for bit.  Returns the median
    wall ms of (pack, run) for each: ``{stage: (pack_ms, run_ms)}``."""
    import torch
    from repro_torch.core.batching import pack_prepared

    times = {False: ([], []), True: ([], [])}
    for _ in range(3):
        for f in rep.flush_log:
            rung = next(b for b in sched._ladders[f.sig]
                        if b.n_pad == f.rung_multiple * f.sig[0])
            raws = [graphs[r] for r in f.rids]
            vecs = ([np.asarray(ex._eigvec(s, r, nf.shape[0], nf.shape[0]))
                     for s, r, nf, _ in raws] if sched._needs_eigvec(f.model) else None)
            outs = []
            for stage in (False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prep, _ = pack_prepared(raws, rung, eigvecs=vecs, device=ex.device,
                                        stage=stage)
                t1 = time.perf_counter()
                outs.append(ex.run(prep, model=f.model)[0])
                t2 = time.perf_counter()
                times[stage][0].append(t1 - t0)
                times[stage][1].append(t2 - t1)
            if not np.array_equal(*outs):
                raise AssertionError(f"flush {f.rids}: staged and pinned batches "
                                     f"served other bits")
    return {stage: tuple(statistics.median(x) * 1e3 for x in t)
            for stage, t in times.items()}


def stream_report(rep) -> str:
    sizes = rep.batch_sizes
    return (f"{rep.graphs_per_s:.0f} graphs/s, p50 {rep.percentile_ms(50):.3f} "
            f"p99 {rep.percentile_ms(99):.3f} ms, shed {rep.shed_rate:.3f}, "
            f"{len(sizes)} flushes of {np.mean(sizes) if sizes else 0.0:.1f}, "
            f"compute {rep.compute_s:.4f}s")


def tenant_view(rep, tagged, name):
    """The report seen through one tenant: other tenants' requests count
    as not offered."""
    mask = np.asarray([m == name for m in tagged])
    return dataclasses.replace(
        rep, outputs=[o for o, keep in zip(rep.outputs, mask) if keep],
        latencies_s=rep.latencies_s[mask],
        shed=[x for x in rep.shed if tagged[x.rid] == name])


def check_served(tag: str, rep, refs, tol) -> None:
    """served + shed = offered, something served, and every served output
    within ``tol`` of the per-graph stream's."""
    if rep.num_served + rep.num_shed != rep.num_requests or rep.num_served == 0:
        raise AssertionError(f"{tag}: served {rep.num_served} + shed {rep.num_shed} "
                             f"of {rep.num_requests} offered")
    for rid, (out, ref) in enumerate(zip(rep.outputs, refs)):
        if out is not None:
            agree(f"{tag} request {rid}", out, ref, tol)


def threaded_runs(target, ex, graphs, tag: str) -> tuple:
    """``PipelinedStream`` (inflight 2, staged and not) beside the blocking
    ``infer_stream`` in one loop, twice: the first round starts on a cold
    set of stream signatures (the captures run on this thread while the
    worker pins and copies), the second is timed.  Returns (per-graph
    outputs, the timed round's line)."""
    import torch
    from repro_torch.serve.pipeline import PipelinedStream

    for _ in range(2):
        walls = {}
        for what in ("pipelined, staged", "infer_stream", "pipelined, not staged"):
            t0 = time.perf_counter()
            if what == "infer_stream":
                outs, stats = target.infer_stream(graphs)[0], {}
            else:
                outs, stats = PipelinedStream(ex, inflight=2,
                                              stage=what.endswith(", staged")).run(graphs)
            torch.cuda.synchronize()
            walls[what] = (time.perf_counter() - t0, stats, [o[:1] for o in outs])
        refs = walls["infer_stream"][2]
        for what, (_, stats, outs) in walls.items():
            if stats and (stats["peak_inflight"] > 2 or not all(
                    np.array_equal(a, b) for a, b in zip(outs, refs))):
                raise AssertionError(f"stream {tag} {what}: peak in flight "
                                     f"{stats['peak_inflight']}, or outputs not "
                                     f"infer_stream's bit for bit")
    line = "threaded, one graph a run, warm round: " + "; ".join(
        f"{what} wall {w:.4f} s, {len(graphs) / w:.0f} graphs/s"
        + (f", peak in flight {st['peak_inflight']}" if st else "")
        for what, (w, st, _) in walls.items())
    return refs, line + ("; pipelined == infer_stream bit for bit, in flight <= 2, "
                         "the cold round served")


def serve_stream(path, device, card: str) -> dict:
    """Phase 6b for one path, under PyTorch's deterministic algorithms:
    ``threaded_runs`` (one-tenant paths), then the scheduler at loads (a)
    qps 0, (b) qps 5000 and (c) 2x (a)'s graphs/s with a 5 ms SLO and
    margin 0.7, each serial, pipelined (``host_cost="measured"``) and
    depth-1 pipelined on the serial run's compute timeline, with the checks
    of the module docstring; then run (a)'s flushes packed both ways
    (``stage_flush_ms``) and the busy share over run (a).  Returns the
    path's launches."""
    import torch
    from repro_torch.core.batching import graph_sizes
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream
    from repro_torch.serve.pipeline import PipelineConfig
    from repro_torch.serve.scheduler import StreamScheduler

    tag = " + ".join(f"{m} {p}" for _, m, p in path)
    graphs = [g[:4] for g in MoleculeStream(MOLHIV, seed=0).take(STREAM_GRAPHS)]
    names = [name for name, _, _ in path]
    tagged = [names[i % len(names)] for i in range(len(graphs))]
    models = tagged if len(names) > 1 else None
    tol = {name: STREAM_INT8_TOL if prec == "int8" else SERVE_TOL
           for name, _, prec in path}
    mine = lambda xs, name: [x for x, m in zip(xs, tagged) if m == name]
    torch.use_deterministic_algorithms(True)
    try:
        target, ex = stream_target(path, device)
        one = {name: flush_replay_matches_capture(ex, name, mine(graphs, name))
               for name in names}
        keys0 = {name: warm_keys(ex, name) for name in names}
        before = census()
        reset_launches()
        lines = []
        if len(names) == 1:
            refs, line = threaded_runs(target, ex, graphs, tag)
            lines.append((line, "wall clock"))
        else:
            refs = [ex.run(ex.prepare_stream(g), model=m)[0][:1]
                    for g, m in zip(graphs, tagged)]
        captures, runs, scheds = None, {}, {}
        qps = {"a": 0.0, "b": STREAM_QPS}
        for load in ("a", "b", "c"):
            kw = {}
            if load == "c":
                qps["c"] = 2.0 * runs[("a", "serial")].graphs_per_s
                kw = dict(slo_s=STREAM_SLO_S, admit_margin=STREAM_ADMIT_MARGIN)
            # depth 1 at a free host cost, on the serial run's compute
            # timeline: the one pipelined run that must flush as serial does
            for mode, pipeline in (("serial", None),
                                   ("pipelined", PipelineConfig(2, host_cost="measured")),
                                   ("depth 1", PipelineConfig(1))):
                sched = scheds[(load, mode)] = StreamScheduler(
                    target, capacity=STREAM_CAPACITY, max_wait_s=STREAM_MAX_WAIT_S,
                    prewarm="eager", pipeline=pipeline, **kw)
                if mode != "pipelined":
                    timeline = timed_as(ex, timeline if mode == "depth 1" else None)
                try:
                    rep = sched.run(graphs, qps=qps[load], models=models)
                finally:
                    ex.__dict__.pop("run", None)
                if captures is None:  # the eager prewarm: each tenant's ladders
                    captures = ex.lowered_count
                    for name in names:
                        sigs = {ex.bucket_for(*graph_sizes(g)) for g in mine(graphs, name)}
                        cold = [b for sig in sigs for b in sched._ladders[sig]
                                if not ex.has_program(("packed", b.n_pad, b.e_pad, b.g_pad),
                                                      b.g_pad, model=name)]
                        if cold:
                            raise AssertionError(f"stream {tag}: {name} rungs {cold} "
                                                 f"not warm after the eager prewarm")
                elif ex.lowered_count != captures or rep.compile_s != 0.0:
                    raise AssertionError(f"stream {tag} ({load}) {mode}: "
                                         f"{ex.lowered_count - captures} captures, "
                                         f"compile {rep.compile_s} s inside the stream")
                for name in names:
                    check_served(f"stream {tag} ({load}) {mode} {name}",
                                 tenant_view(rep, tagged, name), mine(refs, name),
                                 tol[name])
                runs[(load, mode)] = rep
            # the pipelined loop's measured host pack (eigvec, pack_prepared
            # and its pinning): its EWMA per base bucket
            sched = scheds[(load, "pipelined")]
            packs = "/".join(f"{sched.pack_estimate_s(k) * 1e3:.3f}"
                             for k in sorted(sched._ladders))
            ser, depth1 = runs[(load, "serial")], runs[(load, "depth 1")]
            if flush_rows(ser) != flush_rows(depth1) or not all(
                    np.array_equal(a, b) for a, b in zip(ser.outputs, depth1.outputs)
                    if a is not None):
                raise AssertionError(f"stream {tag} ({load}): a depth-1 pipelined run on "
                                     f"the serial run's compute timeline flushed, shed or "
                                     f"served otherwise")
            # at qps 0 the trace alone decides each flush; under a live rate a
            # flush closes on the measured compute's timeline, so the two loops
            # may pack differently.  A graph's output does not depend on the
            # graphs packed beside it (every kernel and sum of the path works
            # per row or per destination, deterministically), so every request
            # served by both loops must give the same bits
            ser, pipe = runs[(load, "serial")], runs[(load, "pipelined")]
            same = {f.rids for f in ser.flush_log} & {f.rids for f in pipe.flush_log}
            if load == "a" and ([f.rids for f in ser.flush_log]
                                != [f.rids for f in pipe.flush_log]):
                raise AssertionError(f"stream {tag} (a): serial and pipelined flushed "
                                     f"other requests")
            both = [r for r, (a, b) in enumerate(zip(ser.outputs, pipe.outputs))
                    if a is not None and b is not None]
            if not all(np.array_equal(ser.outputs[r], pipe.outputs[r]) for r in both):
                raise AssertionError(f"stream {tag} ({load}): serial and pipelined "
                                     f"outputs differ")
            lines.append((
                f"({load}) qps {qps[load]:.0f}"
                + (f", slo {STREAM_SLO_S * 1e3:.0f} ms margin {STREAM_ADMIT_MARGIN}"
                   if kw else "")
                + f": serial {stream_report(ser)} | pipelined {stream_report(pipe)}, "
                f"host pack EWMA {packs} ms a flush by base bucket; {len(same)} of {len(ser.flush_log)} / {len(pipe.flush_log)} flushes "
                f"of the same requests; the {len(both)} requests served by both, "
                f"bit for bit; depth 1 on the serial run's compute timeline: the same "
                f"{len(ser.flush_log)} flushes, {len(ser.shed)} sheds and latencies, "
                f"outputs bit for bit",
                "virtual timeline of measured compute"))
        launches = read_launches()
        counted = census_delta(before)
        want = {}
        for name in names:
            new = warm_keys(ex, name) - keys0[name]
            for key, n in one[name].items():
                want[key] = want.get(key, 0.0) + new * n
        if counted != want:
            raise AssertionError(f"stream {tag}: dispatch census {counted}, JAX's "
                                 f"warm keys x one forward give {want}")
        stage = stage_flush_ms(ex, scheds[("a", "serial")], runs[("a", "serial")], graphs)
        busy, ops = busy_share(lambda: StreamScheduler(
            target, capacity=STREAM_CAPACITY, max_wait_s=STREAM_MAX_WAIT_S,
            prewarm="eager").run(graphs, qps=0.0, models=models))
    finally:
        torch.use_deterministic_algorithms(False)
    for _, model, precision in path:
        for kernel in (PATH_KERNELS if precision == "fp32" else INT8_PATH_KERNELS)[model]:
            if launches[kernel] <= 0:
                raise AssertionError(f"stream {tag}: {kernel} was never launched")
    if len(path) == 1:
        check_launches(path[0][1], path[0][2], launches)
    for line, clock in lines:
        print(f"[stream {tag}] {line} ({clock}; {card})")
    print(f"[stream {tag}] run (a)'s {len(runs[('a', 'serial')].flush_log)} flushes again, "
          f"median wall ms a flush: pinned host batch (stage=False, the scheduler's) "
          f"pack {stage[False][0]:.3f} + run {stage[False][1]:.3f}; staged "
          f"(stage=True) pack {stage[True][0]:.3f} + run {stage[True][1]:.3f}; "
          f"outputs bit for bit ({card})")
    tols = " / ".join(sorted({"int8 atol 1e-4" if p == "int8" else "rtol 1e-4 atol 1e-5"
                              for _, _, p in path}))
    print(f"[stream {tag}] {len(graphs)} MolHIV graphs, capacity {STREAM_CAPACITY}, "
          f"max wait {STREAM_MAX_WAIT_S * 1e3:.0f} ms: {captures} captures before the "
          f"scheduler's second run, none after (compile 0.0 s); served + shed = offered; "
          f"served within {tols} of the per-graph stream; census "
          f"{int(sum(counted.values()))} = JAX's warm keys x one forward, all kernel; "
          f"a flush replay's kernels = its capture's; busy share over run (a) "
          f"{busy:.3f} ({ops} device ops; {card}); launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def stream_phase(device, card: str) -> dict:
    """Phase 6b: every stream path; returns their launches by path name."""
    out = {}
    for path in STREAM_PATHS:
        name = "stream " + " + ".join(f"{m} {p}" for _, m, p in path)
        out[name] = serve_stream(path, device, card)
    return out


# ------------------------------------------------------------ phase 10: cold start

# the launcher line every cold-start run prints (serve_gnn under --aot-cache)
COLD_FIELDS = ("cold_start_s", "aot_hit", "aot_miss", "aot_stale", "lowered",
               "nvcc_runs")
COLD_TIMEOUT_S = 600
# process A of the restart check: serve GIN fused through the scheduler with
# a fresh cache, save params, graphs and outputs; process B: the same from
# the saved state and the cache alone (argv: mode, cache dir, state file)
RESTART_CHILD = """
import sys
import numpy as np
import torch
from repro_torch.configs.gengnn_models import get_gnn_config
from repro_torch.data.pipeline import MOLHIV, MoleculeStream
from repro_torch.gnn import init
from repro_torch.kernels import _build
from repro_torch.serve.aot import AOTCache
from repro_torch.serve.gnn_engine import GNNEngine
from repro_torch.serve.scheduler import StreamScheduler

mode, cache_dir, state_path = sys.argv[1:4]
torch.use_deterministic_algorithms(True)
cfg = get_gnn_config("gin")
if mode == "save":
    params = init(torch.Generator().manual_seed(0), cfg)
    graphs = [g[:4] for g in MoleculeStream(MOLHIV, seed=0).take(64)]
else:
    state = torch.load(state_path, weights_only=False)
    params, graphs = state["params"], state["graphs"]
eng = GNNEngine(cfg, params, fused=True, aot_cache=AOTCache(cache_dir))
sched = StreamScheduler(eng, capacity=4)
sched.prewarm_ladders(graphs)
rep = sched.run(graphs, qps=0.0)
outs = [np.asarray(o) for o in rep.outputs]
stats = eng.executor.aot_stats()
if mode == "save":
    torch.save({"params": params, "graphs": graphs, "outputs": outs}, state_path)
else:
    same = all(np.array_equal(a, b) for a, b in zip(outs, state["outputs"]))
    if not same or len(outs) != len(state["outputs"]):
        sys.exit("restarted process served other outputs")
print("RESTART mode=%s hit=%d miss=%d stale=%d nvcc_runs=%d lowered=%d graphs=%d" % (
    mode, stats["hit"], stats["miss"], stats["stale"], _build.nvcc_runs,
    eng.executor.lowered_count, len(outs)))
"""


def child_env() -> dict:
    import os

    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def run_child(argv: list, what: str) -> str:
    """Run one child process to its end (killed at ``COLD_TIMEOUT_S``);
    raises with its output unless it exits 0."""
    r = subprocess.run(argv, capture_output=True, text=True, env=child_env(),
                       timeout=COLD_TIMEOUT_S, cwd=str(ROOT))
    if r.returncode != 0:
        raise AssertionError(f"{what} exited {r.returncode}:\n{r.stdout[-4000:]}\n"
                             f"{r.stderr[-4000:]}")
    return r.stdout


def cold_start_run(cache_dir: Path, out_dir: Path, tag: str) -> dict:
    """``python -m repro_torch.launch.serve --gnn gin --fused --stream`` on
    64 graphs with ``--aot-cache`` and ``--prewarm-persist``, writing both
    telemetry artifacts, which the port's checker then validates; -> the
    cold-start line's fields and the wall seconds of the process."""
    metrics, trace = out_dir / f"metrics-{tag}.json", out_dir / f"trace-{tag}.json"
    t0 = time.perf_counter()
    out = run_child([sys.executable, "-m", "repro_torch.launch.serve", "--gnn", "gin",
                     "--fused", "--stream", "--n-graphs", "64", "--aot-cache",
                     str(cache_dir), "--prewarm-persist", "--metrics-json",
                     str(metrics), "--trace-out", str(trace)], f"cold-start run {tag}")
    wall = time.perf_counter() - t0
    line = next((l for l in out.splitlines() if l.startswith("cold_start_s=")), None)
    if line is None:
        raise AssertionError(f"cold-start run {tag} printed no cold-start line:\n{out}")
    fields = {k: float(v) for k, v in (f.split("=") for f in line.split())}
    if set(fields) != set(COLD_FIELDS):
        raise AssertionError(f"cold-start run {tag}: fields {sorted(fields)}")
    checked = run_child([sys.executable, "-m", "repro_torch.obs.check_artifacts",
                         "--metrics-json", str(metrics), "--trace-out", str(trace)],
                        f"artifact check {tag}")
    doc = json.loads(metrics.read_text())["metrics"]
    aot = {s["labels"]["result"]: s["value"]
           for s in doc["serve_aot_cache_total"]["series"]}
    if {k: aot.get(k, 0.0) for k in ("hit", "miss", "stale")} != {
            k: fields[f"aot_{k}"] for k in ("hit", "miss", "stale")}:
        raise AssertionError(f"cold-start run {tag}: serve_aot_cache_total {aot}, "
                             f"line {fields}")
    return dict(fields, wall_s=wall, checked=" ".join(checked.split()))


def restart_fields(out: str) -> dict:
    line = next(l for l in out.splitlines() if l.startswith("RESTART "))
    return {k: v for k, v in (f.split("=") for f in line.split()[1:])}


def coldstart_phase(card: str) -> None:
    """Phase 10: the kernel-library cache across processes (this process
    has loaded build/repro_torch/'s libraries and cannot show a cold start).
    Two launcher runs on one fresh cache: the first builds (misses, no
    hit), the second builds nothing (hits only, no nvcc process) and
    captures as many graphs; both runs' artifacts pass the checker.  A
    process A serves and saves its outputs with a fresh cache, a process B
    given only that cache and the saved state serves them bit for bit with
    no nvcc.  Then one entry's library is truncated and another's record
    gets another driver: a third run counts a miss and a stale entry and
    heals both (every entry a hit again under this environment)."""
    import shutil

    from repro_torch.kernels import _build
    from repro_torch.serve.aot import AOTCache, environment_fingerprint

    work = ROOT / "build" / "coldstart"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        cache_dir = work / "aot"
        first = cold_start_run(cache_dir, work, "1")
        second = cold_start_run(cache_dir, work, "2")
        if not (first["aot_miss"] > 0 and first["aot_hit"] == 0
                and first["nvcc_runs"] == first["aot_miss"]):
            raise AssertionError(f"first cold-start run: {first}")
        if not (second["aot_miss"] == second["aot_stale"] == 0 and second["aot_hit"] > 0
                and second["nvcc_runs"] == 0):
            raise AssertionError(f"second cold-start run: {second}")
        if first["lowered"] != second["lowered"] or not first["lowered"]:
            raise AssertionError(f"captures: first {first['lowered']}, second "
                                 f"{second['lowered']}")
        for tag, r in (("first", first), ("second", second)):
            print(f"[coldstart {tag}] gin fp32 fused, 64 graphs streamed, ladders "
                  f"prewarmed: cold_start_s {r['cold_start_s']:.3f} (process wall "
                  f"{r['wall_s']:.3f}s), aot hit {r['aot_hit']:.0f} miss "
                  f"{r['aot_miss']:.0f} stale {r['aot_stale']:.0f}, nvcc processes "
                  f"{r['nvcc_runs']:.0f}, captures {r['lowered']:.0f}; artifacts: "
                  f"{r['checked']}; {card}")
        state = work / "state.pt"
        restart_dir = work / "aot-restart"
        a = restart_fields(run_child([sys.executable, "-c", RESTART_CHILD, "save",
                                      str(restart_dir), str(state)], "process A"))
        b = restart_fields(run_child([sys.executable, "-c", RESTART_CHILD, "load",
                                      str(restart_dir), str(state)], "process B"))
        if not (int(a["miss"]) > 0 and int(b["miss"]) == int(b["stale"]) == 0
                and int(b["hit"]) > 0 and int(b["nvcc_runs"]) == 0):
            raise AssertionError(f"restart: process A {a}, process B {b}")
        print(f"[coldstart restart] process A (fresh cache): {a['graphs']} graphs "
              f"served and saved, aot miss {a['miss']}, nvcc processes "
              f"{a['nvcc_runs']}, captures {a['lowered']}; process B (the cache "
              f"and the saved state only): the same outputs bit for bit "
              f"(deterministic algorithms), aot hit {b['hit']} miss {b['miss']} "
              f"stale {b['stale']}, nvcc processes {b['nvcc_runs']}, captures "
              f"{b['lowered']}")
        cache = AOTCache(cache_dir)
        keys = {name: _build.cache_key(name) for name in ("node_mlp", "fused_mp")}
        lib = Path(cache.library_path(keys["node_mlp"]))
        lib.write_bytes(lib.read_bytes()[: lib.stat().st_size // 2])
        rec_path = Path(cache.entry_path(keys["fused_mp"]))
        rec = json.loads(rec_path.read_text())
        rec["fingerprint"]["driver"] = "0.0-another-driver"
        rec_path.write_text(json.dumps(rec))
        third = cold_start_run(cache_dir, work, "3")
        if not (third["aot_miss"] == 1 and third["aot_stale"] == 1
                and third["nvcc_runs"] == 2):
            raise AssertionError(f"third cold-start run: {third}")
        fingerprint = environment_fingerprint()
        healed = {name: cache.load(key, fingerprint) is not None
                  for name, key in keys.items()}
        if not all(healed.values()):
            raise AssertionError(f"entries not healed: {healed}")
        print(f"[coldstart heal] node_mlp's library truncated and fused_mp's record "
              f"given another driver: the third run counts aot miss "
              f"{third['aot_miss']:.0f} stale {third['aot_stale']:.0f} hit "
              f"{third['aot_hit']:.0f}, nvcc processes {third['nvcc_runs']:.0f}, "
              f"cold_start_s {third['cold_start_s']:.3f}; afterwards both entries "
              f"load as hits under this environment ({healed})")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------ phases 9-9c


def rel_err(name: str, got, want) -> float:
    """max|got - want| / max|want|; raises unless finite and of the same
    shape."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} / {tuple(want.shape)} "
                             f"or not finite")
    return float((got - want).abs().max() / want.abs().max())


@contextlib.contextmanager
def routing(mode: str, calls: list):
    """``models.moe._route`` observed or forced, one call an MoE layer.

    mode "record": each call appends (its experts (T, k), the gap between
    each token's k-th and (k+1)-th router logit) to ``calls``.  mode
    "force": each call takes the experts of the next entry of ``calls`` and
    weighs them with its own router probabilities (renormalized where the
    config says): a path teacher-forced on another's routing, as the decode
    checks are teacher-forced on its tokens.  Raises unless a forced run
    used every entry."""
    import torch
    from repro_torch.models import moe as MOE

    orig = MOE._route
    pending = iter(calls)
    used = [0]

    def recorded(p, x2d, cfg, with_aux):
        out = orig(p, x2d, cfg, with_aux)
        logits = torch.matmul(x2d.float(), p["router"].float())
        top = torch.topk(logits, cfg.experts_per_token + 1, dim=-1).values
        calls.append((out[1].clone(), top[:, -2] - top[:, -1]))
        return out

    def forced(p, x2d, cfg, with_aux):
        top_e = next(pending)[0]
        used[0] += 1
        if top_e.shape != (x2d.shape[0], cfg.experts_per_token):
            raise AssertionError(f"forced routing of {tuple(top_e.shape)} for "
                                 f"{x2d.shape[0]} tokens")
        probs = torch.softmax(torch.matmul(x2d.float(), p["router"].float()), dim=-1)
        top_p = torch.gather(probs, 1, top_e)
        if cfg.norm_topk:
            top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
        return top_p, top_e, None

    MOE._route = recorded if mode == "record" else forced
    try:
        yield calls
    finally:
        MOE._route = orig
    if mode == "force" and used[0] != len(calls):
        raise AssertionError(f"a forced run took {used[0]} of {len(calls)} routings")


def route_flips(ref: list, other: list) -> tuple:
    """(tokens ``other`` routes to another expert set than ``ref``, token
    routings, the largest logit gap ``other`` has at such a token; 0 when
    none): two recordings of the same calls."""
    import torch

    if len(ref) != len(other):
        raise AssertionError(f"{len(ref)} routings against {len(other)}")
    flipped, total, gap = 0, 0, 0.0
    for (a, _), (b, margin) in zip(ref, other):
        diff = (a.sort(-1).values != b.sort(-1).values).any(-1)
        flipped += int(diff.sum())
        total += diff.numel()
        if diff.any():
            gap = max(gap, float(torch.where(diff, margin, 0.0).max()))
    return flipped, total, gap


def dispatch_stats(cfg, calls: list, b: int, s: int) -> tuple:
    """(the share of (token, expert) assignments each recorded prefill
    routing, rows of ``s`` tokens, keeps at ``cfg``'s capacity; the largest
    load of one expert in one row over them)."""
    import torch
    from repro_torch.core import scatter_gather as sg
    from repro_torch.models import moe as MOE

    shares, load = [], 0
    for top_e, _ in calls:
        k = top_e.shape[1]
        seg = top_e.reshape(b, s * k) * b + torch.arange(b, device=top_e.device)[:, None]
        rank = sg.rank_within_segment(seg.reshape(-1), cfg.num_experts * b)
        shares.append(float((rank < MOE.capacity(cfg, s)).float().mean()))
        load = max(load, int(rank.max()) + 1)
    return shares, load


def float_in_place(tree) -> None:
    """Every tensor of a nested dict / list replaced by its fp32 copy, one
    at a time (the tree's other references gone, the old leaf is freed)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, w in list(items):
        if isinstance(w, (dict, list)):
            float_in_place(w)
        else:
            tree[key] = w.float()


def decode_after_prefill(params, cfg, tokens, cache_len: int) -> dict:
    """Decode of the last token after prefill(S-1), against prefill(S)'s
    last logits, teacher-forced on prefill(S)'s routing (the decode's own
    attention can flip a near tie).  Returns {"step", "last", "note"}: the
    note gives the capacity, the largest load of an expert in a row, the
    routings that differ unforced and the forced error."""
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE

    full = []
    with routing("record", full):
        _, last, _ = lm.prefill(params, {"tokens": tokens}, cfg, cache_len)
    b, s = tokens.shape
    k, n_layers = cfg.experts_per_token, len(full)
    _, load = dispatch_stats(cfg, full, b, s)
    pre = [top_e.reshape(b, s, k) for top_e, _ in full]
    shorter = [(p[:, :-1].reshape(-1, k), None) for p in pre]
    last_tok = [(p[:, -1], None) for p in pre]
    steps = []
    with routing("record", steps):
        cache, _, t = lm.prefill(params, {"tokens": tokens[:, :-1]}, cfg, cache_len)
        step, _ = lm.decode_step(params, cache, tokens[:, -1:], t, cfg)
    del cache
    free = rel_err("", step, last)
    prefix_flips = route_flips(shorter, steps[:n_layers])[0]
    step_flips = route_flips(last_tok, steps[n_layers:])
    with routing("force", shorter + last_tok):
        cache, _, t = lm.prefill(params, {"tokens": tokens[:, :-1]}, cfg, cache_len)
        step, _ = lm.decode_step(params, cache, tokens[:, -1:], t, cfg)
    del cache
    note = (f"at capacity factor {cfg.capacity_factor:g} (capacity "
            f"{MOE.capacity(cfg, s)}, largest load {load}): {prefix_flips} prompt-token "
            f"routings differ from prefill(S)'s, {step_flips[0]} of {step_flips[1]} "
            f"last-token routings (largest logit gap {step_flips[2]:.3g}); max|d|/max|ref| "
            f"free {free:.3g}, on prefill(S)'s routing {rel_err('', step, last):.3g}")
    return {"step": step, "last": last, "note": note}


def tree_bytes(tree) -> int:
    """Bytes of the tensors in a nested dict / list."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def eager_generate(params, cfg, scfg, batch):
    """The eager loop of ``lm.prefill`` / ``lm.decode_step`` at int
    positions, greedy, as JAX's ``LMServer.generate`` runs its programs, on
    ``batch`` (the padded tokens and a VLM's patches or an audio model's
    frames): (tokens (B, max_new) numpy, prefill s with the first argmax,
    decode s a token), each region ending at a synchronise."""
    import torch
    from repro_torch.models import lm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, last, t = lm.prefill(params, batch, cfg, scfg.cache_len)
    tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tokens = batch["tokens"]
    out = torch.empty((tokens.shape[0], scfg.max_new_tokens), dtype=torch.int32,
                      device=tokens.device)
    for i in range(scfg.max_new_tokens):
        out[:, i] = tok[:, 0]
        logits, cache = lm.decode_step(params, cache, tok, t + i, cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return out.cpu().numpy(), t1 - t0, (t2 - t1) / scfg.max_new_tokens


def decode_attention_jax_form(q, k_cache, v_cache, t, window, softcap):
    """JAX's form of decode attention, which ``layers.decode_attention``
    replaced: the cache repeated to q's heads and copied to fp32, fp32
    einsums."""
    import torch
    from repro_torch.models import layers as L

    b, _, h, d = q.shape
    g = h // k_cache.shape[2]
    qs = (q / math.sqrt(d)).reshape(b, h, d)
    logits = torch.einsum("bhd,bkhd->bhk", qs.float(), L.repeat_kv(k_cache, g).float())
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    mask = kpos <= t
    if window:
        mask &= kpos > t - window
    p = torch.softmax(torch.where(mask, logits, L._NEG), dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", p, L.repeat_kv(v_cache, g).float())
    return o[:, None].to(q.dtype)


def mla_decode_jax_form(q_nope, q_rope, ckv, krope, w_uk, w_uv, t):
    """JAX's absorbed MLA decode (``src/repro/models/layers.py``'s
    ``mla_apply`` with a cache): the latent caches and w_uv copied to fp32,
    fp32 einsums, probabilities kept in fp32."""
    import torch
    from repro_torch.models import layers as L

    dn, dr = q_nope.shape[-1], q_rope.shape[-1]
    q_abs = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], w_uk)
    logits = (torch.einsum("bhr,bkr->bhk", q_abs.float(), ckv.float())
              + torch.einsum("bhr,bkr->bhk", q_rope[:, 0].float(), krope.float()))
    logits = logits / math.sqrt(dn + dr)
    kpos = torch.arange(ckv.shape[1], device=ckv.device)
    p = torch.softmax(torch.where(kpos <= t, logits, L._NEG), dim=-1)
    o_lat = torch.einsum("bhk,bkr->bhr", p, ckv.float())
    return torch.einsum("bhr,rhk->bhk", o_lat, w_uv.float())


def time_mla_decode(arch: str, cfg, srv, pos: int) -> dict:
    """``layers.mla_decode_attention`` (the absorbed form) at the served
    decode shape: the server's filled latent cache of its first MLA layer,
    that layer's w_uk / w_uv, the last slot a served decode writes; device
    time against the JAX form (fp32 copies of the cache), the bound (bytes:
    both caches, q, w_uk, w_uv read once, o written once) and the error
    against the JAX form (P rounded to bf16 for P . ckv)."""
    import torch
    from repro_torch.models import layers as L

    ckv, kr = srv._cache[pos]["ckv"][0], srv._cache[pos]["krope"][0]
    mixer = srv.params["blocks"][pos]["mixer"]
    w_uk, w_uv = mixer["w_uk"][0], mixer["w_uv"][0]
    b, s, kvr = ckv.shape
    h, dn, dr, dv = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    gen = torch.Generator(device=ckv.device).manual_seed(23)
    q_nope, q_rope = (torch.randn((b, 1, h, n), generator=gen, device=ckv.device)
                      .to(ckv.dtype) for n in (dn, dr))
    t = torch.full((), srv.t0 + srv.scfg.max_new_tokens - 1,
                   dtype=torch.long, device=ckv.device)
    args = (q_nope, q_rope, ckv, kr, w_uk, w_uv, t)
    got = L.mla_decode_attention(*args)
    want = mla_decode_jax_form(*args)
    err = checked_err(f"{arch} mla_decode_attention vs the JAX form", got, want,
                      FLASH_TOL["bfloat16"])
    ms, timer = device_ms(lambda: L.mla_decode_attention(*args), 20)
    jax_ms, _ = device_ms(lambda: mla_decode_jax_form(*args), 10)
    nbytes = ckv.element_size() * sum(x.numel() for x in args[:6]) + 4 * b * h * dv
    bound_ms, bound_by = bound(nbytes, 2.0 * b * h * kvr * dv,
                               bf16_ops=2.0 * b * h * (dn * kvr + s * (2 * kvr + dr)))
    return dict(name="mla_decode_attention", ms=ms, timer=timer, jax_form_ms=jax_ms,
                bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err,
                ops=op_count(lambda: L.mla_decode_attention(*args)))


def attn_note(attn) -> str:
    """The decode attention's timing, for an LM path's line."""
    if attn is None:
        return "no attention layer to time in the decode step"
    ops = "ops not measured" if attn["ops"] is None else f"{attn['ops']} ops"
    return (f"{attn['name']} {attn['ms'] * 1e3:.2f} us a layer ({attn['timer']}; {ops}; the JAX "
            f"form {attn['jax_form_ms'] * 1e3:.2f} us; bound {attn['bound_ms'] * 1e3:.2f} "
            f"us, {attn['bound_by']}; err {attn['max_abs_err']:.3g})")


def time_decode_attention(arch: str, cfg, srv):
    """The decode attention of the first attention layer (None without one;
    MLA: ``time_mla_decode``).  GQA: ``layers.decode_attention`` at the
    served decode shape (the server's filled cache, its device position, a
    global layer's window): device time against the JAX form it replaced
    (repeated, fp32 cache), the bytes bound (q, the two caches and o moved
    once) and its error against the JAX form in fp32 (P rounded to bf16 for
    P.V)."""
    import torch
    from repro_torch.models import layers as L

    pos = next((i for i in range(cfg.group_size) if cfg.mixer_kind(i) == "attn"), None)
    if pos is None:
        return None
    if cfg.attention == "mla":
        return time_mla_decode(arch, cfg, srv, pos)
    kc, vc = srv._cache[pos]["k"][0], srv._cache[pos]["v"][0]
    b, s, hkv, d = kc.shape
    gen = torch.Generator(device=kc.device).manual_seed(22)
    q = torch.randn((b, 1, cfg.num_heads, d), generator=gen, device=kc.device).to(kc.dtype)
    # the last slot a served decode writes (a VLM's past its patches)
    t = torch.full((), srv.t0 + srv.scfg.max_new_tokens - 1,
                   dtype=torch.long, device=kc.device)
    args = (q, kc, vc, t, 0, cfg.logit_softcap)
    got = L.decode_attention(*args)
    want = decode_attention_jax_form(*args)
    err = checked_err(f"{arch} decode_attention vs the JAX form", got.float(),
                      want.float(), FLASH_TOL["bfloat16"])
    ms, timer = device_ms(lambda: L.decode_attention(*args), 20)
    jax_ms, _ = device_ms(lambda: decode_attention_jax_form(*args), 10)
    nbytes = kc.element_size() * (2 * kc.numel() + 2 * q.numel())
    bound_ms, bound_by = bound(nbytes, 0.0,
                               bf16_ops=4.0 * b * cfg.num_heads * s * d)
    return dict(name="decode_attention", ms=ms, timer=timer, jax_form_ms=jax_ms,
                bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err,
                ops=op_count(lambda: L.decode_attention(*args)))


def decode_replays(srv, n: int):
    """A call that rewinds ``srv``'s device position and step index to the
    end of the prompt (t0, a VLM's past its patches; two fills) and replays
    its decode graph ``n`` <= max_new_tokens times: within the cache and
    the output however often it is called (the cache past the prompt is
    rewritten before it is read)."""
    def run():
        srv._pos.fill_(srv.t0)
        srv._step.zero_()
        for _ in range(n):
            srv.decode_graph.replay()
    return run


def capture_matches_eager(fn):
    """Under PyTorch's deterministic algorithms: ``fn()`` (a tensor from
    static inputs) warmed on a side stream, captured into a CUDA graph and
    replayed, against an eager call.  Returns (bit for bit, capture s)."""
    import torch

    torch.use_deterministic_algorithms(True)
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            out = fn()
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        graph.replay()
        want = fn()
        torch.cuda.synchronize()
        return torch.equal(out, want), capture_s
    finally:
        torch.use_deterministic_algorithms(False)


def moe_layer(arch: str, device, dtype, **overrides):
    """(config, one MoE layer's parameters) of ``arch`` at full width, drawn
    on the card from seed 3 in fp32 and cast to ``dtype``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE

    cfg = get_config(arch, **overrides)
    p = MOE.moe_init(torch.Generator(device=device).manual_seed(3), cfg)
    return cfg, {k: w.to(dtype) for k, w in p.items()}


def check_moe(device) -> None:
    """Phase 9m: the MoE path's new code on the card (no kernel of its own:
    sort, gathers and cuBLAS GEMMs).  Prints one line."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.core import scatter_gather as sg
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE
    from repro_torch.models.config import ModelConfig
    from repro_torch.serve.engine import LMServer, ServeConfig

    t_start = time.perf_counter()
    rng = np.random.default_rng(9)
    # 1. the slot helpers on CUDA against the CPU, bit for bit (CUDA's
    # stable sort: the first `capacity` of a segment in input order)
    for n_seg, e, cap, share in MOE_SLOT_CASES:
        ids = torch.from_numpy(rng.integers(0, n_seg, e).astype(np.int32))
        vals = torch.from_numpy(rng.normal(size=(e, 64)).astype(np.float32))
        valid = (torch.from_numpy(rng.random(e) < share) if share is not None else None)
        cpu = sg.dispatch_to_slots(vals, ids, n_seg, cap, valid)
        gpu = sg.dispatch_to_slots(vals.to(device), ids.to(device), n_seg, cap,
                                   None if valid is None else valid.to(device))
        pairs = list(zip(("slots", "slot_index", "kept"), cpu, gpu))
        pairs += [("combined", sg.combine_from_slots(*cpu), sg.combine_from_slots(*gpu)),
                  ("rank", sg.rank_within_segment(ids, n_seg),
                   sg.rank_within_segment(ids.to(device), n_seg))]
        for name, a, b in pairs:
            if a.dtype != b.dtype or not torch.equal(a, b.cpu()):
                raise AssertionError(f"moe slots ({n_seg}, {e}, {cap}, {share}): {name} "
                                     f"on the card differs from the CPU's")
    # 2. dispatch against the dense baseline at ample capacity, fp32: JAX's
    # own case through the model (tests/test_train_serve.py:78-94), then one
    # layer of each arch at full width and a capacity that keeps every token
    kw = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=48,
              vocab_size=64, num_experts=4, experts_per_token=2, family="moe",
              capacity_factor=4.0, attn_chunk=16, loss_chunk=16, remat=False,
              dtype="float32")
    cfg = ModelConfig(**kw).validate()
    params = lm.init_params(torch.Generator(device=device).manual_seed(1), cfg)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 64, (2, 16))).to(device)}
    h1, _ = lm.forward_hidden(params, batch, cfg)
    h2, _ = lm.forward_hidden(params, batch, dataclasses.replace(cfg, moe_impl="dense"))
    errs = [checked_err("moe dispatch vs dense (JAX's case)", h1, h2,
                        dict(rtol=MOE_DENSE_BOUND, atol=MOE_DENSE_BOUND))]
    for arch in ("qwen3-moe-30b-a3b", "mixtral-8x7b"):
        cfg, p = moe_layer(arch, device, torch.float32)
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                                  / cfg.experts_per_token)
        x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator(
            device=device).manual_seed(4), device=device)
        got, _ = MOE.moe_apply(p, x, cfg)
        want, _ = MOE.moe_apply(p, x, dataclasses.replace(cfg, moe_impl="dense"))
        rel = rel_err(f"{arch} moe dispatch vs dense", got, want)
        if not rel <= MOE_DENSE_BOUND:
            raise AssertionError(f"{arch} moe dispatch vs dense: max|d|/max|dense| "
                                 f"{rel:.3g} > {MOE_DENSE_BOUND}")
        errs.append(rel)
        del p
    # 3. captured against eager, bit for bit, under deterministic algorithms:
    # moe_apply at each arch's served prefill and decode shapes (bf16), then
    # a reduced Qwen3-MoE server's decode replay against its eager step
    captures = []
    for arch, b, s in (("qwen3-moe-30b-a3b", 8, 512), ("qwen3-moe-30b-a3b", 8, 1),
                       ("mixtral-8x7b", 2, 5120), ("mixtral-8x7b", 2, 1)):
        cfg, p = moe_layer(arch, device, torch.bfloat16)
        x = torch.randn((b, s, cfg.d_model), generator=torch.Generator(
            device=device).manual_seed(5), device=device).to(torch.bfloat16)
        same, capture_s = capture_matches_eager(lambda: MOE.moe_apply(p, x, cfg, False)[0])
        if not same:
            raise AssertionError(f"{arch} moe_apply at (B {b}, S {s}): the replay "
                                 f"differs from the eager call")
        captures.append(f"{arch} S {s} {capture_s:.3f}s")
        del p
    torch.cuda.empty_cache()
    cfg = get_reduced("qwen3-moe-30b-a3b", head_dim=64)
    params = lm.init_params(torch.Generator(device=device).manual_seed(6), cfg)
    scfg = ServeConfig(max_batch=4, prompt_len=24, cache_len=40, max_new_tokens=8)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (9, 24, 17, 3)]
    torch.use_deterministic_algorithms(True)
    try:
        srv = LMServer(params, cfg, scfg, device=device)
        gen, _ = srv.generate(prompts)
        srv.prefill_graph.replay()  # position and step back to the prompt's end
        state = [srv._tok, srv._pos, srv._step, srv._out] + [
            w for c in srv._cache for w in c.values()]
        start = [w.clone() for w in state]
        srv.decode_graph.replay()
        replayed = [w.clone() for w in state]
        for w, w0 in zip(state, start):
            w.copy_(w0)
        srv._decode()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(replayed, state)):
            raise AssertionError("reduced qwen3-moe: the decode replay differs from the "
                                 "eager step")
    finally:
        torch.use_deterministic_algorithms(False)
    if not ((gen >= 0) & (gen < cfg.vocab_size)).all():
        raise AssertionError("reduced qwen3-moe: tokens out of range")
    print(f"[moe] slot helpers on the card == the CPU's bit for bit (slots, slot_index, "
          f"kept, rank, combined) at {len(MOE_SLOT_CASES)} shapes (the served "
          f"dispatches up to 32768 elements, one tied segment, a valid mask); dispatch "
          f"vs dense at ample capacity, fp32: JAX's case {errs[0]:.3g}, full-width layer "
          f"max|d|/max|dense| Qwen3-MoE {errs[1]:.3g}, Mixtral {errs[2]:.3g} (bound "
          f"{MOE_DENSE_BOUND}); captured moe_apply == eager bit for bit under "
          f"deterministic algorithms ({', '.join(captures)}); a reduced Qwen3-MoE "
          f"server's decode replay == its eager step bit for bit (cache, token, "
          f"output); {time.perf_counter() - t_start:.1f}s")


def spread(xs) -> str:
    """"median (min-max)" of a list of seconds, in ms."""
    ms = [x * 1e3 for x in xs]
    return f"{statistics.median(ms):.3f} ({min(ms):.3f}-{max(ms):.3f})"


def serve_lm(arch: str, overrides: dict, serve_kw: dict, lengths, device) -> tuple:
    """Drive the port's LM serving path for ``arch`` at full width through
    its CUDA graphs and check it; returns (the path's launch counts, the
    flash launches of one prefill replay and of one decode replay by the
    profiler).  The flash kernel runs once an attention layer a prefill
    (MLA's at (96, 64)) and never in a decode step.  A VLM's patch or an
    audio model's frame embeddings (``lm.extra_input``) are float32 normal
    draws of the path's generator after the prompts', as JAX's launcher
    makes them, and go with the tokens into every call."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE
    from repro_torch.serve.engine import LMServer, ServeConfig
    from repro_torch.serve.executor import params_signature

    cfg = get_config(arch, **overrides)
    scfg = ServeConfig(**serve_kw)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # each leaf is cast to the model dtype as it is drawn: one fp32 leaf at
    # a time beside the cast ones; its blocks go back to the card
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(math.prod(shape) for shape, _ in params_signature(params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(lengths[0], lengths[1] + 1, scfg.max_batch)]
    toks = np.zeros((scfg.max_batch, scfg.prompt_len), np.int32)
    for i, pr in enumerate(prompts):
        toks[i, -len(pr):] = pr  # LMServer's left padding
    extra = lm.extra_input(cfg, scfg.max_batch)
    extras = {} if extra is None else {
        extra[0]: rng.normal(size=extra[1]).astype(np.float32)}
    tokens = torch.from_numpy(toks).to(device)
    batch = {"tokens": tokens, **{k: torch.from_numpy(v).to(device)
                                  for k, v in extras.items()}}
    with_tokens = lambda t: {**batch, "tokens": t}
    srv = LMServer(params, cfg, scfg, device=device)
    ref_srv = LMServer(params, cfg, scfg, device=device, mode="reference")
    # the main path: the first generate warms prefill and the step eagerly,
    # captures both and replays them; the counters move at warm and capture
    reset_launches()
    gen, _ = srv.generate(prompts, extras=extras or None)
    launches = read_launches()
    n_layers = cfg.num_layers
    n_attn = sum(cfg.mixer_kind(i) == "attn" for i in range(n_layers))
    n_moe = sum(cfg.ffn_kind(i) == "moe" for i in range(n_layers))
    if launches["flash_attention.mma"] != 2 * n_attn or any(
            n for k, n in launches.items()
            if k not in ("flash_attention", "flash_attention.mma")):
        raise AssertionError(f"{arch}: launches {launches}; expected 2 x {n_attn} "
                             f"flash_attention (the warm prefill and the capture), all "
                             f"on the mma route")
    if gen.shape != (scfg.max_batch, scfg.max_new_tokens) or not (
            (gen >= 0) & (gen < cfg.vocab_size)).all():
        raise AssertionError(f"{arch}: tokens out of [0, {cfg.vocab_size}) or shape {gen.shape}")
    # replays: n_attn mma flash kernels a prefill, none a decode step (the
    # prefill replay rewinds the state the decode replay, up to PROFILE_TRIES
    # of them, advances)
    names = [e.name for e in device_events(srv.prefill_graph.replay)]
    step_names = [e.name for e in device_events(srv.decode_graph.replay)]
    replays = {"prefill": sum("flash_fwd" in n for n in names),
               "decode": sum("flash_fwd" in n for n in step_names)}
    if (replays != {"prefill": n_attn, "decode": 0}
            or sum("flash_fwd_mma" in n for n in names) != n_attn):
        raise AssertionError(f"{arch}: flash kernels a replay {replays}; expected "
                             f"{n_attn} (mma) a prefill and 0 a decode step")

    # graph against eager in one run: the same tokens, each timed LM_RUNS times
    graph_runs, eager_runs = [], []
    for _ in range(LM_RUNS):
        reset_launches()
        got, stats = srv.generate(prompts, extras=extras or None)
        if any(read_launches().values()) or srv.captures != 2:
            raise AssertionError(f"{arch}: a later generate captured or launched "
                                 f"{read_launches()}; captures {srv.captures}")
        eager, prefill_s, decode_s = eager_generate(params, cfg, scfg, batch)
        for name, toks_ in (("graph", got), ("eager loop", eager)):
            if not np.array_equal(toks_, gen):
                raise AssertionError(f"{arch}: the {name} tokens differ from the first "
                                     f"generate's in {int((toks_ != gen).sum())} places")
        graph_runs.append((stats["prefill_s"], stats["decode_s_per_token"]))
        eager_runs.append((prefill_s, decode_s))

    def path(server, forced):
        """(prefill last logits, teacher-forced decode logits, flash
        launches of the prefill) in ``server``'s mode; raises if a decode
        step launches the flash kernel."""
        reset_launches()
        cache, last, t = lm.prefill(server.params, batch, cfg, scfg.cache_len,
                                    kernel_mode=server.mode)
        torch.cuda.synchronize()
        counts = read_launches()
        n_prefill = counts["flash_attention"]
        if counts["flash_attention.mma"] != n_prefill:
            raise AssertionError(f"{arch}: prefill launches {counts}; not all on the "
                                 f"mma route")
        logits = []
        for i in range(forced.shape[1]):
            reset_launches()
            step, cache = lm.decode_step(server.params, cache, forced[:, i:i + 1], t + i, cfg)
            logits.append(step)
            if read_launches()["flash_attention"]:
                raise AssertionError(f"{arch}: flash_attention ran in a decode step")
        return last, torch.stack(logits, 1), n_prefill

    forced = torch.from_numpy(gen).to(device)
    moe = bool(cfg.num_experts)
    kernel_routes, free_routes = [], []
    with routing("record", kernel_routes):
        last_k, dec_k, n_prefill = path(srv, forced)
    with routing("record", free_routes):
        last_r, dec_r, n_ref = path(ref_srv, forced)
    if n_prefill != n_attn or n_ref != 0:
        raise AssertionError(f"{arch}: prefill launched flash_attention {n_prefill} times "
                             f"(reference mode {n_ref}); expected {n_attn} and 0")
    moe_note = ""
    if moe:
        # the two attentions differ by bf16 roundings, which flip a router's
        # choice where two experts nearly tie: reported, then the reference
        # runs again on the kernel path's routing and is held to the bound
        flips = route_flips(kernel_routes, free_routes)
        free = (rel_err("", last_k, last_r), rel_err("", dec_k, dec_r))
        with routing("force", kernel_routes):
            last_r, dec_r, _ = path(ref_srv, forced)
        kept, load = dispatch_stats(cfg, kernel_routes[:n_moe], scfg.max_batch,
                                    scfg.prompt_len)
        moe_note = (f"; routing against the reference's: {flips[0]} of {flips[1]} token "
                    f"routings differ (largest logit gap {flips[2]:.3g}), free-routing "
                    f"max|d|/max|ref| prefill {free[0]:.3g}, decode {free[1]:.3g}; held "
                    f"on the kernel path's routing; prefill keeps "
                    f"{statistics.mean(kept):.4f} of its (token, expert) assignments "
                    f"(layers {min(kept):.4f}-{max(kept):.4f}) at capacity "
                    f"{MOE.capacity(cfg, scfg.prompt_len)}, largest load of an expert "
                    f"in a row {load}")
    failures = []

    def held(name: str, got, want) -> float:
        """``rel_err``; a failure (raised after the line prints) past
        ``LM_BOUND``."""
        rel = rel_err(f"{arch} {name}", got, want)
        if not rel <= LM_BOUND:
            failures.append(f"{arch} {name}: max|d| / max|ref| = {rel:.3g} > {LM_BOUND}")
        return rel

    errs = {"prefill": held("prefill logits", last_k, last_r),
            "decode": held("teacher-forced decode logits", dec_k, dec_r)}
    # decode after prefill(S - 1) against prefill(S)'s last logits; a
    # recurrent path (Mamba, RWKV) as JAX's test runs it, in fp32 below,
    # here in bf16 for the record: under the random init its layers amplify
    # bf16 roundings (on the CPU, RWKV-6 at 24 reduced layers: the port's
    # bf16 prefill logits 0.117 max|ref| from JAX's on the same weights,
    # ChatGLM3's 0.012; fp32 1e-5), and on the card prefill(S) and the
    # decode step round apart (other GEMM kernels)
    recurrent = any(cfg.mixer_kind(i) != "attn" for i in range(cfg.group_size))
    if moe:
        # an MoE path as JAX's test runs it (tests/test_arch_smoke.py:47-57):
        # in fp32, at a capacity where neither run drops a token, below on a
        # copy of the weights; here in bf16 for the record
        cf = max(MOE_CHECK_CF, cfg.num_experts / cfg.experts_per_token)
        cfg_c = dataclasses.replace(cfg, capacity_factor=cf)
        bf16_step = decode_after_prefill(params, cfg_c, tokens, scfg.cache_len)
    else:
        cache, _, t = lm.prefill(params, with_tokens(tokens[:, :-1]), cfg, scfg.cache_len)
        step, _ = lm.decode_step(params, cache, tokens[:, -1:], t, cfg)
        del cache
        if recurrent:
            bf16_rel = rel_err(f"{arch} decode after prefill(S-1)", step, last_k)
        else:
            errs["decode_vs_prefill"] = held("decode after prefill(S-1)", step, last_k)
    # the reference server's capture holds its plain attention's (B, H, S, S)
    # buffers in its pool: give it the memory the eager checks left cached
    torch.cuda.empty_cache()
    ref_gen, _ = ref_srv.generate(prompts, extras=extras or None)
    agree_tokens = float((ref_gen == gen).mean())

    busy_graph = busy_share(decode_replays(srv, scfg.max_new_tokens))
    cache, _, t = lm.prefill(params, batch, cfg, scfg.cache_len)
    first = forced[:, :1]
    busy_eager = busy_share(lambda: [lm.decode_step(params, cache, first, t + i, cfg)
                                     for i in range(8)])
    del cache
    attn = time_decode_attention(arch, cfg, srv)
    captures, capture_s, pool_gb = srv.captures, srv.capture_seconds, srv.pool_bytes / 1e9
    # a decode step reads every decoder weight but the embedding's rows (a
    # dispatch MoE step runs every expert's GEMMs over its slots; a tied
    # embedding is the head and read whole), not an audio model's encoder
    # (``enc_*``), and an audio decoder's cross K/V from the cache
    decoder = {k: w for k, w in params.items() if not k.startswith("enc_")}
    cross = sum(w.numel() * w.element_size() for c in srv._cache for k, w in c.items()
                if k.startswith("cross_"))
    read = (tree_bytes(decoder) + cross
            - (0 if cfg.tie_embeddings else tree_bytes(params["embed"])))
    floor = read / PEAK_HBM_BYTES_S * 1e3
    med = statistics.median(r[1] for r in graph_runs) * 1e3
    LM_DECODE[arch] = dict(floor_ms=floor, graph_decode_ms=[r[1] * 1e3 for r in graph_runs],
                           batch=scfg.max_batch, cache_len=scfg.cache_len, layers=n_layers)
    floor_note = (f"; decode weight-read floor {read / 1e9:.3f} GB"
                  + (f" (the cross K/V {cross / 1e9:.3f} of it)" if cross else "")
                  + f" = {floor:.3f} ms/token at {PEAK_HBM_BYTES_S / 1e12:.2f} TB/s "
                  f"(graph decode {med / floor:.2f}x)")
    del srv, ref_srv
    if moe:
        moe_note += f"; decode after prefill(S-1), bf16 {bf16_step['note']}"
        float_in_place(params)
        torch.cuda.empty_cache()
        fp32 = decode_after_prefill(params, dataclasses.replace(cfg_c, dtype="float32"),
                                    tokens, scfg.cache_len)
        errs["decode_vs_prefill"] = held("decode after prefill(S-1), fp32", fp32["step"],
                                         fp32["last"])
        moe_note += f"; fp32 (held) {fp32['note']}"
    elif recurrent:
        float_in_place(params)
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        _, last32, _ = lm.prefill(params, batch, cfg32, scfg.cache_len)
        cache, _, t = lm.prefill(params, with_tokens(tokens[:, :-1]), cfg32, scfg.cache_len)
        step, _ = lm.decode_step(params, cache, tokens[:, -1:], t, cfg32)
        del cache
        errs["decode_vs_prefill"] = held("decode after prefill(S-1), fp32", step, last32)
        moe_note += (f"; decode after prefill(S-1) max|d|/max|ref| bf16 {bf16_rel:.3g}, "
                     f"fp32 (held) {errs['decode_vs_prefill']:.3g}")
    del params
    torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    col = lambda runs, i: spread([r[i] for r in runs])
    extra_note = "".join(f" with {v.shape[1]} {k}" for k, v in extras.items())
    print(f"[lm {arch}] {n_layers} layers, d {cfg.d_model}, {n_params / 1e9:.3f} B "
          f"params (init {init_s:.3f}s); B={scfg.max_batch} prompts "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens padded to "
          f"{scfg.prompt_len}{extra_note}, cache {scfg.cache_len}, "
          f"{scfg.max_new_tokens} new; "
          f"median (min-max) of {LM_RUNS} runs: graph prefill {col(graph_runs, 0)} ms, "
          f"decode {col(graph_runs, 1)} ms/token; eager loop prefill "
          f"{col(eager_runs, 0)} ms, decode {col(eager_runs, 1)} ms/token; graph tokens "
          f"== eager loop's in every run; decode replay {len(step_names)} device ops "
          f"({len(step_names) / n_layers:.1f} a layer), busy share over "
          f"{scfg.max_new_tokens} replays "
          f"{busy_graph[0]:.3f} (eager 8 steps {busy_eager[0]:.3f}, {busy_eager[1] // 8} "
          f"ops a step); {captures} captures in {capture_s:.3f}s, graph pool "
          f"{pool_gb:.3f} GB; vs reference mode max|d|/max|ref| prefill "
          f"{errs['prefill']:.3g}, decode {errs['decode']:.3g}, "
          f"decode-after-prefill(S-1) {errs['decode_vs_prefill']:.3g}; tokens equal to "
          f"the reference server's {agree_tokens:.3f}; flash_attention by the profiler "
          f"{replays['prefill']} a prefill replay (mma; {n_attn} attention layers), "
          f"{replays['decode']} a decode replay; launches {launches} (warm + capture); "
          f"{attn_note(attn)}; peak memory: init {init_peak_gb:.1f} GB, then serving "
          f"{peak_gb:.1f} GB{floor_note}{moe_note}")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, replays


# ------------------------------------------------------------ phases 11-11c: training


def check_flash_bwd(device) -> dict:
    """Phase 11: gradients through the kernel (``ops.FlashAttention``)
    against autograd of the plain forward at ``FLASH_BWD_CASES``, then the
    Function's forward and backward device times at the train step's shape
    beside SDPA's.  Returns the times for the flash row."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    gen = torch.Generator().manual_seed(19)
    worst = {}
    for name, b, hq, hkv, s, d, dv, window, softcap, dt in FLASH_BWD_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (t.detach().requires_grad_(True) for t in
                   attention_inputs(gen, b, hq, hkv, s, d, dtype, device, "bshd", dv))
        do = torch.randn((b, s, hq, dv), generator=gen).to(device, dtype).transpose(1, 2)
        kw = dict(window=window, softcap=softcap)
        before = dict(FA.launches_by_route)
        out = kops.flash_attention(q, k, v, mode="kernel", **kw)
        if type(out.grad_fn).__name__ != "FlashAttentionBackward":
            raise AssertionError(f"flash_attention bwd {name}: the kernel's output has "
                                 f"grad_fn {out.grad_fn}")
        chosen = FA.route(dtype, d, dv)
        if FA.launches_by_route != dict(before, **{chosen: before[chosen] + 1}):
            raise AssertionError(f"flash_attention bwd {name}: launches "
                                 f"{FA.launches_by_route}, expected one on {chosen}")
        got = torch.autograd.grad(out, (q, k, v), do)
        # autograd of the plain forward on fp32 copies of the same values: in
        # bf16 it casts each query head's dk / dv to bf16 and sums a KV
        # head's group there, less exact than the gradient it would check
        q32, k32, v32 = (t.detach().float().requires_grad_(True) for t in (q, k, v))
        want = torch.autograd.grad(
            kops.flash_attention(q32, k32, v32, mode="reference", **kw), (q32, k32, v32),
            do.float())
        errs = [checked_err(f"flash_attention bwd {name} d{n}", g.float(), w.float(),
                            FLASH_TOL[dt]) for n, g, w in zip("qkv", got, want)]
        worst[name] = max(errs)
        print(f"[flash_attention bwd] {name} B={b} Hq={hq} Hkv={hkv} S={s} D={d} Dv={dv} "
              f"window={window} softcap={softcap} {dt} ({chosen} forward): max abs err "
              f"dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} (tolerance "
              f"{FLASH_TOL[dt]['atol']:g} + {FLASH_TOL[dt]['rtol']:g} |plain|)")
        del q, k, v, do, out, got, want, q32, k32, v32
        torch.cuda.empty_cache()
    b, hq, hkv, s, d = FLASH_BWD_TIME_SHAPE
    q, k, v = (t.detach().requires_grad_(True) for t in
               attention_inputs(gen, b, hq, hkv, s, d, torch.bfloat16, device, "bshd"))
    do = torch.randn((b, s, hq, d), generator=gen).to(device, torch.bfloat16).transpose(1, 2)
    grads = lambda out: torch.autograd.grad(out, (q, k, v), do)
    sdpa = lambda: Fn.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=True)
    # CUDA events over calls queued back to back: the profiler lost or split
    # SDPA's backward records here (forward + backward read below its forward)
    times = dict(timer="events-queued")
    for key, fn, reps in (
            ("fwd_ms", lambda: kops.flash_attention(q, k, v, mode="kernel"), TIMING_REPS),
            ("bwd_ms", lambda: kref.flash_attention_bwd_ref(q, k, v, do), FLASH_BWD_REPS),
            ("fwd_bwd_ms", lambda: grads(kops.flash_attention(q, k, v, mode="kernel")),
             FLASH_BWD_REPS),
            ("sdpa_fwd_ms", sdpa, TIMING_REPS),
            ("sdpa_fwd_bwd_ms", lambda: grads(sdpa()), FLASH_BWD_REPS)):
        for _ in range(2):
            fn()
        times[key] = queued_ms(fn, reps)
    print(f"[flash_attention bwd] times at the train step's shape B={b} Hq={hq} Hkv={hkv} "
          f"S={s} D={d} bf16 causal: Function forward (kernel) {times['fwd_ms']:.3f} ms, "
          f"backward (plain) {times['bwd_ms']:.3f} ms, forward + backward "
          f"{times['fwd_bwd_ms']:.3f} ms; sdpa forward {times['sdpa_fwd_ms']:.3f} ms, "
          f"forward + backward {times['sdpa_fwd_bwd_ms']:.3f} ms ({device_line()})")
    del q, k, v, do
    torch.cuda.empty_cache()
    return dict(times, grad_max_abs_err=worst,
                time_shape=dict(b=b, hq=hq, hkv=hkv, s=s, d=d, dtype="bfloat16", causal=True))


def train_flops(cfg, params, tokens: int) -> tuple:
    """(model FLOPs, with the remat recompute) of one step: 6 N T for the N
    weights that multiply (all but the embedding table), attention's 4 B Hq
    pairs D a layer forward and twice that backward; the recompute adds one
    forward of the blocks (2 N_blocks T and attention's forward again)."""
    from repro_torch.optim import adamw

    n = sum(p.numel() for p in adamw.leaves(params)) - params["embed"].numel()
    n_blocks = sum(p.numel() for p in adamw.leaves(params["blocks"]))
    s = TRAIN_SEQ
    attn = 4.0 * (tokens // s) * cfg.num_heads * (s * (s + 1) / 2) * cfg.head_dim_
    model = 6.0 * n * tokens + 3 * attn * cfg.num_layers
    return model, model + 2.0 * n_blocks * tokens + attn * cfg.num_layers


def step_breakdown(prof, wall_s: float) -> dict:
    """Device ms of one profiled train step by kernel class: cuBLAS GEMMs,
    the flash kernel, copies / fills, everything else (elementwise,
    reductions, the plain attention backward's softmax); "idle" is the wall
    time the card ran none of them (overlapping records counted once each)."""
    from torch.autograd import DeviceType

    out = dict.fromkeys(("gemm", "flash_fwd", "memcpy_memset", "other"), 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        key = ("flash_fwd" if "flash_fwd" in name else
               "gemm" if any(w in name for w in ("gemm", "nvjet", "xmma", "cutlass")) else
               "memcpy_memset" if name.startswith(("memcpy", "memset")) else "other")
        out[key] += e.time_range.elapsed_us() / 1e3
    out["idle"] = max(0.0, wall_s * 1e3 - sum(out.values()))
    return out


def train_chatglm3(device) -> tuple:
    """Phase 11b; returns (the train steps' launch counts, the summary for
    the flash row)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens, TokenPipelineConfig
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train.loop import device_batch, loss_and_grads, make_train_step

    cfg = get_config(TRAIN_ARCH, num_layers=TRAIN_LAYERS, dtype="bfloat16", remat=True)
    tag = f"[train {TRAIN_ARCH}]"
    torch.cuda.empty_cache()
    params = lm.init_params(torch.Generator(device).manual_seed(0), cfg)
    n_params = sum(p.numel() for p in adamw.leaves(params))
    data = iter(SyntheticTokens(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)))
    first = device_batch(next(data), device)
    # every leaf's gradient on the kernel path, then the reference on a copy
    loss_k, _, grads = loss_and_grads(params, first, cfg)
    bad = [i for i, g in enumerate(adamw.leaves(grads))
           if not (torch.isfinite(g).all() and g.abs().max() > 0)]
    if bad:
        raise AssertionError(f"{tag}: leaves {bad} of {len(adamw.leaves(grads))} have a "
                             f"zero or non-finite gradient")
    gn_k = float(adamw.global_norm(grads))
    del grads
    ref_params = adamw.tree_map(torch.clone, params)
    loss_r, _, grads = loss_and_grads(ref_params, first, cfg, kernel_mode="reference")
    gn_r = float(adamw.global_norm(grads))
    del grads, ref_params
    torch.cuda.empty_cache()
    d_loss, d_gn = abs(float(loss_k) - float(loss_r)), abs(gn_k - gn_r) / gn_r
    print(f"{tag} {TRAIN_LAYERS} of 28 layers at full width, {n_params / 1e9:.3f} B "
          f"parameters, bf16, remat: every one of {len(adamw.leaves(params))} leaves has a "
          f"finite, non-zero gradient; first batch kernel vs reference mode: loss "
          f"{float(loss_k):.5f} / {float(loss_r):.5f} (|d| {d_loss:.3g} <= "
          f"{TRAIN_LOSS_TOL:g}), grad_norm {gn_k:.5f} / {gn_r:.5f} (relative {d_gn:.3g} "
          f"<= {TRAIN_GNORM_RTOL:g})")
    if not (d_loss <= TRAIN_LOSS_TOL and d_gn <= TRAIN_GNORM_RTOL):
        raise AssertionError(f"{tag}: kernel path vs reference mode out of tolerance")
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    opt_state = adamw.init(params)
    step_fn = make_train_step(cfg, opt_cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    model_flops, hw_flops = train_flops(cfg, params, tokens)
    # JAX's 6 N T counts the weights off the vocab: the blocks and the final norm
    nonvocab = sum(p.numel() for p in adamw.leaves(params["blocks"])) + params[
        "final_norm"].numel()
    steps = []
    reset_launches()
    for i in range(TRAIN_STEPS):
        batch = first if i == 0 else device_batch(next(data), device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = (FA.launches, FA.launches_by_route["mma"])
        profiled = i == TRAIN_STEPS - 1  # the last step under the profiler
        with (torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            params, opt_state, _, metrics = step_fn(params, opt_state, None, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launched = FA.launches - before[0]
        if not math.isfinite(metrics["loss"]) or launched != 2 * TRAIN_LAYERS or (
                FA.launches_by_route["mma"] - before[1] != launched):
            raise AssertionError(f"{tag} step {i}: loss {metrics['loss']}, {launched} flash "
                                 f"launches (expected {2 * TRAIN_LAYERS}, all mma)")
        row = dict(step=i, loss=metrics["loss"], grad_norm=metrics["grad_norm"],
                   lr=metrics["lr"], ms=dt * 1e3, tokens_per_s=tokens / dt,
                   mfu=model_flops / dt / PEAK_BF16_FLOP_S,
                   hfu=hw_flops / dt / PEAK_BF16_FLOP_S,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9, flash_launches=launched)
        if profiled:
            row["device_ms_by_class"] = step_breakdown(prof, dt)
        steps.append(row)
        print(f"{tag} step {i}: loss {row['loss']:.5f} grad_norm {row['grad_norm']:.4f} "
              f"lr {row['lr']:.3g}; {row['ms']:.1f} ms{' (profiled)' if profiled else ''}, "
              f"{row['tokens_per_s']:.0f} tokens/s, {row['mfu']:.3f} of the bf16 peak (6 N T "
              f"+ attention; {row['hfu']:.3f} with the recompute), peak "
              f"{row['peak_gb']:.2f} GB, {launched} flash launches")
    launches = read_launches()
    print(f"{tag} device time of the profiled step by kernel class (ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in steps[-1]["device_ms_by_class"].items()))
    zero = adamw.tree_map(torch.zeros_like, params)
    adamw_ms, adamw_timer = device_ms(lambda: adamw.update(opt_cfg, zero, opt_state, params), 3)
    del zero
    print(f"{tag} adamw.update alone: {adamw_ms:.2f} ms ({adamw_timer}; {n_params / 1e9:.3f} B "
          f"parameters, bf16, fp32 moments)")
    if steps[0]["loss"] != float(loss_k):
        print(f"{tag} note: step 0's loss {steps[0]['loss']!r} differs from the checked "
              f"pass's {float(loss_k)!r}")
    later = steps[1:-1]  # past the first, and not the profiled one
    # the same step as one CUDA graph, on from the eager steps' state
    cap = captured_steps(dict(tag=tag, steps=TRAIN_REPLAYS), step_fn, params, opt_state,
                         lambda: device_batch(next(data), device), torch.cuda.synchronize,
                         device)
    eager_ms = statistics.median(r["ms"] for r in later)
    cap_ms = statistics.median(st["ms"] for st in cap["steps"])
    print(f"{tag} captured (train.loop.make_runner: what train() and the launcher run on "
          f"the card; {TRAIN_REPLAYS} replays after steps 0-{TRAIN_STEPS - 1}): "
          + captured_note(cap) + f"; {cap_ms:.1f} ms a replay against {eager_ms:.1f} eager "
          f"({(cap_ms / eager_ms - 1) * 100:+.1f} %); {device_line()}")
    flash = (cap["profile"] or {}).get("flash_kernels", 2 * TRAIN_LAYERS)
    if flash != 2 * TRAIN_LAYERS or not all(math.isfinite(st["loss"]) for st in cap["steps"]):
        raise AssertionError(f"{tag} captured: {flash} flash kernels in a replay (expected "
                             f"{2 * TRAIN_LAYERS}), losses {cap['steps']}")
    del params, opt_state, first
    torch.cuda.empty_cache()
    summary = dict(train_step=dict(
        arch=TRAIN_ARCH, layers=TRAIN_LAYERS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        params=n_params, nonvocab_params=nonvocab, tokens=tokens, model_flops=model_flops,
        loss_vs_reference=d_loss, grad_norm_vs_reference=d_gn,
        median_ms=statistics.median(r["ms"] for r in later),
        median_tokens_per_s=statistics.median(r["tokens_per_s"] for r in later),
        median_mfu=statistics.median(r["mfu"] for r in later),
        peak_gb=max(r["peak_gb"] for r in steps), flash_launches_per_step=2 * TRAIN_LAYERS,
        adamw_ms=adamw_ms, captured_median_ms=cap_ms, steps=steps))
    return launches, summary


def eager_runner():
    """Within the block every runner of ``train.runner`` is the eager one
    (the card's comparison of a captured run with the op-by-op step)."""
    from unittest import mock

    from repro_torch.train import runner as TR

    return mock.patch.object(TR, "captures", lambda device, backend="none": False)


def runner_counts() -> tuple:
    from repro_torch.train import runner as TR

    return TR.capture_count, TR.replay_count


def history_gap(got: list, want: list) -> float:
    """The largest relative gap of two ``train()`` histories' metrics, row by
    row (inf where their steps differ)."""
    if [r["step"] for r in got] != [r["step"] for r in want]:
        return math.inf
    return max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) if g[k] != w[k] else 0.0
               for g, w in zip(got, want) for k in ("loss", "ce", "aux", "grad_norm", "lr"))


def launcher_lines(argv: list) -> tuple:
    """``launch/train.py``'s ``main(argv)`` in this process on the card: (its
    lines, graphs captured, replays)."""
    import io

    from repro_torch.launch import train as LT

    before = runner_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        LT.main(argv)
    after = runner_counts()
    return buf.getvalue().splitlines(), after[0] - before[0], after[1] - before[1]


def train_loop_phase(device) -> dict:
    """Phase 11c; returns the loop's launch counts.  ``train()`` runs its
    steps as one CUDA graph on the card; the eager runner on the same
    batches from the same weights (under deterministic algorithms both)
    holds every history row within ``LOOP_RTOL``, compression off and on."""
    import shutil

    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import SyntheticTokens, TokenPipelineConfig
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train.loop import (LoopConfig, device_batch, make_runner,
                                        make_train_step, train)

    cfg = get_reduced(TRAIN_ARCH, head_dim=64, dtype="bfloat16")
    ckpt = ROOT / "build" / "train_loop"
    shutil.rmtree(ckpt, ignore_errors=True)
    data = SyntheticTokens(TokenPipelineConfig(vocab_size=cfg.vocab_size, batch=4,
                                               seq_len=64))
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=LOOP_STEPS)

    def run(tag: str, compression: bool) -> dict:
        return train(cfg, opt_cfg,
                     LoopConfig(steps=LOOP_STEPS, log_every=1, ckpt_every=LOOP_CKPT_EVERY,
                                ckpt_dir=str(ckpt / tag), max_retries=2,
                                grad_compression=compression),
                     data, inject_failure_at=LOOP_FAIL_AT, device=device)

    torch.use_deterministic_algorithms(True)
    try:
        reset_launches()
        before = runner_counts()
        out = run("captured", False)
        launches = read_launches()
        graphs = [a - b for a, b in zip(runner_counts(), before)]
        with eager_runner():
            eager = run("eager", False)
        comp = run("captured compression", True)
        with eager_runner():
            comp_eager = run("eager compression", True)
    finally:
        torch.use_deterministic_algorithms(False)
    h = out["history"]
    failures = [e["step"] for e in out["events"] if e["event"] == "failure"]
    restored = LOOP_FAIL_AT // LOOP_CKPT_EVERY * LOOP_CKPT_EVERY
    # each batch is new: the loss falls as the mean of the first and last 5 steps
    first5, last5 = (statistics.mean(r["loss"] for r in rs) for rs in (h[:5], h[-5:]))
    if (h[-1]["step"] != LOOP_STEPS or failures != [LOOP_FAIL_AT]
            or [r["step"] for r in h] != list(range(1, LOOP_FAIL_AT + 1)) + list(
                range(restored + 1, LOOP_STEPS + 1))
            or not last5 < first5 or launches["flash_attention"] == 0):
        raise AssertionError(f"[train loop] history {h}, failures {failures}, launches "
                             f"{launches['flash_attention']}")
    if graphs != [1, len(h) - 1]:
        raise AssertionError(f"[train loop] {graphs[0]} captures and {graphs[1]} replays "
                             f"over {len(h)} steps (expected 1 and {len(h) - 1})")
    gaps = {"": history_gap(h, eager["history"]),
            " compression": history_gap(comp["history"], comp_eager["history"])}
    if max(gaps.values()) > LOOP_RTOL:
        raise AssertionError(f"[train loop] captured vs eager histories {gaps} > {LOOP_RTOL}")
    live = {"params": out["params"], "opt": out["opt_state"]}
    step, got = CheckpointManager(str(ckpt / "captured")).restore(template=live)
    same = lambda a, b: (a.device == b.device and a.dtype == b.dtype and torch.equal(
        *(t.view(torch.int16) if t.dtype == torch.bfloat16 else t for t in (a, b))))
    leaves = list(zip(adamw.leaves(got), adamw.leaves(live)))
    if step != LOOP_STEPS or not all(same(a, b) for a, b in leaves):
        raise AssertionError(f"[train loop] the restore of step {step} differs from the "
                             f"live tree")
    ms = lambda o: statistics.median(r["dt"] for r in o["history"][1:]) * 1e3
    # one replay of the same runner under the profiler: the flash kernel
    # inside the graph, as often as the capture launched it
    params = lm.init_params(torch.Generator(device).manual_seed(0), cfg)
    runner = make_runner(make_train_step(cfg, opt_cfg), params, adamw.init(params), None,
                         device)
    batches = iter(data)
    try:
        n0 = FA.launches
        runner(device_batch(next(batches), device))
        per_step = (FA.launches - n0) // 2  # the warm step and the capture
        batch = device_batch(next(batches), device)
        events = device_events(lambda: runner(batch)["loss"].item())
    finally:
        runner.close()
    flash = sum("flash_fwd" in e.name for e in events)
    if not flash == per_step > 0:
        raise AssertionError(f"[train loop] {flash} flash kernels in a profiled replay, "
                             f"{per_step} launched a step by the capture")
    launched = []
    for argv in (["--arch", "rwkv6-1.6b", "--reduced", "--steps", "3", "--batch", "2",
                  "--seq", "32"],
                 ["--arch", TRAIN_ARCH, "--reduced", "--steps", "3", "--batch", "2",
                  "--seq", "32", "--grad-compression"]):
        lines, caps, reps = launcher_lines(argv + ["--ckpt-dir", str(ckpt / "launcher")])
        if lines[-1] != "done" or (caps, reps) != (1, 2) or len(lines) != 4:
            raise AssertionError(f"[train loop] the launcher {argv}: {caps} captures, {reps} "
                                 f"replays, printed {lines}")
        launched.append(f"{' '.join(argv[1:2] + argv[9:])}: " + " | ".join(lines))
    shutil.rmtree(ckpt, ignore_errors=True)
    print(f"[train loop] reduced {TRAIN_ARCH} (D 64, bf16) on the card through train(), "
          f"captured: {LOOP_STEPS} steps, checkpoints every {LOOP_CKPT_EVERY}, the failure "
          f"injected at step {LOOP_FAIL_AT} recovered from step {restored} in place "
          f"({graphs[0]} capture, {graphs[1]} replays); mean loss of the first 5 steps "
          f"{first5:.4f}, of the last 5 {last5:.4f}; {launches['flash_attention']} flash "
          f"launches (the warm step and the capture); the restore of step {step} equals the "
          f"live tree bit for bit on the card ({len(leaves)} leaves); captured vs eager "
          f"runner under deterministic algorithms, largest relative gap of a history row "
          f"{gaps['']:.2e} (compression {gaps[' compression']:.2e}; limit {LOOP_RTOL:g}); "
          f"ms a step past the first (host clock to the metrics' read, deterministic "
          f"algorithms): captured {ms(out):.2f} / eager {ms(eager):.2f}, compression "
          f"{ms(comp):.2f} / {ms(comp_eager):.2f}; a profiled replay: {flash} flash kernels "
          f"of {len(events)} device records; {device_line()}")
    print("[train loop] the launcher in this process, captured (1 capture, 2 replays "
          "each): " + "; ".join(launched))
    return launches


# ------------------------------------------------------------ phase 6


def packed_plan(device):
    from repro_torch.core import batching as B
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream

    batch = [g[:4] for g in MoleculeStream(MOLHIV, seed=0).take(128)]
    packed, _ = B.pack_graphs(batch, B.BucketBudget(**PACKED), device=device)
    return packed, B.pack_layout(packed)


def design_split(counts: dict, kernel: str) -> dict:
    """{design: launches} of ``kernel`` from one path's ``read_launches``."""
    return {k.split(".", 1)[1]: n for k, n in counts.items()
            if k.startswith(kernel + ".")}


ALT_ROUNDS = 6  # rounds of each function in alternating_ms


def alternating_ms(fns: dict, rounds: int = ALT_ROUNDS) -> dict:
    """{name: device ms of each round} of ``fns`` timed by ``device_ms`` in
    turns, the order reversed every other round (a, b, b, a, ...), so that
    the card's clock and its neighbours weigh on each alike."""
    out = {name: [] for name in fns}
    for i in range(rounds):
        for name in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            out[name].append(device_ms(fns[name])[0])
    return out


def time_node_mlp(device, packed, launches: int, by_variant: dict) -> dict:
    import torch
    from repro_torch.kernels import node_mlp as NM
    from repro_torch.kernels import ops as kops

    gen = torch.Generator().manual_seed(4)
    # the shapes the packed GIN forward gives node_mlp (fused path:
    # encoder, edge embedding x5, head) plus the unfused MLP's first layer
    shapes = [(PACKED["n_pad"], 9, 100, "none"), (PACKED["e_pad"], 3, 100, "none"),
              (PACKED["g_pad"], 100, 1, "none"), (PACKED["n_pad"], 100, 200, "relu")]
    rows = []
    for m, k, n, act in shapes:
        x = torch.randn((m, k), generator=gen).to(device)
        w = (torch.randn((k, n), generator=gen) * (2.0 / (k + n)) ** 0.5).to(device)
        b = (0.1 * torch.randn((n,), generator=gen)).to(device)
        err = checked_err(f"node_mlp {(m, k, n, act)}",
                          kops.node_mlp(x, w, b, act, mode="kernel"),
                          kops.node_mlp(x, w, b, act, mode="reference"), TOL)
        ms, timer = device_ms(lambda: kops.node_mlp(x, w, b, act, mode="kernel"))
        plain_ms, _ = device_ms(lambda: kops.node_mlp(x, w, b, act, mode="reference"))
        lib = (lambda: torch.relu(torch.addmm(b, x, w))) if act == "relu" \
            else (lambda: torch.addmm(b, x, w))
        library_ms, _ = device_ms(lib)
        bound_ms, bound_by = bound(4.0 * (m * k + k * n + n + m * n),
                                   2.0 * m * k * n + 2.0 * m * n)
        rows.append(dict(shape=[m, k, n, act], variant=NM.variant(m, k, n),
                         max_abs_err=err, ms=ms, timer=timer,
                         call_ms=call_ms(lambda: kops.node_mlp(x, w, b, act, mode="kernel")),
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        if NM.variant(m, k, n) == "tiled":
            rounds = alternating_ms({
                "kernel": lambda: kops.node_mlp(x, w, b, act, mode="kernel"), "addmm": lib})
            rows[-1].update(ms=statistics.median(rounds["kernel"]),
                            library_ms=statistics.median(rounds["addmm"]), rounds=rounds)
    for r in rows:
        print(f"[time] node_mlp {r['shape']} ({r['variant']}): err {r['max_abs_err']:.3g}; "
              f"{r['ms']:.4f} ms ({r['timer']}; "
              f"per call {r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f}, "
              f"addmm {r['library_ms']:.4f}, bound {r['bound_ms']:.5f} "
              f"({r['bound_by']})")
        if "rounds" in r:
            print(f"[time] node_mlp {r['shape']} ({r['variant']}) in {ALT_ROUNDS} alternating "
                  "rounds of " + "; ".join(
                      f"{name} median {statistics.median(v):.4f} ms, range "
                      f"{min(v):.4f}-{max(v):.4f}" for name, v in r["rounds"].items()))
    main = rows[1]  # the edge embedding: five of the seven launches per forward
    return dict(name="node_mlp", route="cuda",
                source="src/repro_torch/kernels/csrc/node_mlp.cu",
                replaces="src/repro/kernels/node_mlp.py:55",
                launches=launches, launches_by_variant=by_variant,
                **{k: v for k, v in main.items() if k != "variant"},
                all_shapes=rows)


def time_window_edges(device, card: str) -> None:
    """The E_pad window's cost at the PubMed size (``PUBMED``, GIN: a
    forward gathers a rank's window of edge features once, then embeds
    them in each of its 5 layers): that edge work on a window of the whole
    plan's 88648 slots, which every rank runs, against windows cut to a
    rank's share on 2 and 4 ranks, in ALT_ROUNDS alternating rounds."""
    import torch
    from repro_torch.kernels import ops as kops

    gen = torch.Generator().manual_seed(6)
    e = PUBMED["e"]
    feat = torch.randn((e, 3), generator=gen).to(device)
    w = (torch.randn((3, 100), generator=gen) * (2.0 / 103) ** 0.5).to(device)
    b = (0.1 * torch.randn((100,), generator=gen)).to(device)
    perm = torch.randperm(e, generator=gen).to(device)

    def edge_work(rows: int):
        idx = perm[:rows]
        return lambda: [kops.node_mlp(feat[idx], w, b, "none", mode="kernel")
                        for _ in range(5)]

    rounds = alternating_ms({rows: edge_work(rows) for rows in (e, -(-e // 2), -(-e // 4))})
    print("[time] window edge work (PubMed GIN, a rank's forward: gather + 5 x node_mlp "
          f"(rows, 3->100)) in {ALT_ROUNDS} alternating rounds: " + "; ".join(
              f"{rows} rows median {statistics.median(v) * 1e3:.2f} us, range "
              f"{min(v) * 1e3:.2f}-{max(v) * 1e3:.2f}" for rows, v in rounds.items())
          + f"; {card}")


def time_fused_mp(device, packed, lay, launches: int) -> dict:
    """The fp32 ``fused_mp`` at the packed plan's shapes: GIN (F=100, H=200),
    the main row, PNA (F=80, K1=960) and GCN (F=100); no single library
    call computes a fused layer."""
    import torch
    from repro_torch.kernels import ops as kops

    gen = torch.Generator().manual_seed(5)
    n, e = packed.num_nodes, packed.num_edges
    n_real = int(packed.node_mask.sum())
    e_real = int(lay.offsets[-1])
    rows = []
    for gamma, f in (("gin", 100), ("pna", 80), ("gcn", 100)):
        spec, kw = fused_operands(gen, gamma, n, e, f, device)
        args = (spec, lay.ids_sorted, lay.offsets, lay.src_sorted, lay.in_degree,
                packed.node_mask)
        kern = lambda: kops.fused_mp(*args, mode="kernel", **kw)
        plain = lambda: kops.fused_mp(*args, mode="reference", **kw)
        err = checked_err(f"fused_mp {gamma} (packed shapes)", kern(), plain(),
                          PNA_TOL if gamma == "pna" else TOL)
        ms, timer = device_ms(kern)
        plain_ms, _ = device_ms(plain)
        plan_b = 4.0 * ((n + 1) + e_real + n) + n  # offsets, src ids, deg, mask
        if gamma == "gin":
            h = 2 * f
            k1, n_ops = f, 1
            nbytes = plan_b + 4.0 * (2 * n * f + e_real * f + f * h + h + h * f + f + n * f)
            flops = (3.0 * e_real * f + n_real * f + 2.0 * n_real * f * h
                     + 2.0 * n_real * h + 2.0 * n_real * h * f + n_real * f)
        elif gamma == "gcn":
            h, k1, n_ops = 0, 0, 1
            nbytes = plan_b + 4.0 * (2 * n * f + n + n * f)  # msrc, x_res, nop, out
            # the sum per edge; residual add and scale per node
            flops = e_real * f + 2.0 * n_real * f
        else:
            h, k1, n_ops = 0, 12 * f, 4
            nbytes = plan_b + 4.0 * (2 * n * f + 3 * n + k1 * f + f + n * f)
            # sum, sqsum, max, min per edge; mean/std/scalers; the product;
            # bias, relu and residual
            flops = (5.0 * e_real * f + 18.0 * n_real * f + 2.0 * n_real * k1 * f
                     + 3.0 * n_real * f)
        bound_ms, bound_by = bound(nbytes, flops)
        rows.append(dict(gamma=gamma, max_abs_err=err, ms=ms, timer=timer,
                         call_ms=call_ms(kern), plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by,
                         **tile_census(packed.node_mask, f, n_ops, k1, h, False),
                         shape=dict(gamma=gamma, n=n, e_pad=e, e_real=e_real, f=f,
                                    h=h, k1=k1)))
    for r in rows:
        print(f"[time] fused_mp {r['gamma']} N={n} E={e_real}/{e} F={r['shape']['f']}: "
              f"err {r['max_abs_err']:.3g}; {r['ms']:.4f} ms ({r['timer']}; per call "
              f"{r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']}); {r['rows']} rows per block, "
              f"{r['live_tiles']} of {r['tiles']} tiles live")
    main = {k: v for k, v in rows[0].items() if k != "gamma"}
    return dict(name="fused_mp", route="cuda",
                source="src/repro_torch/kernels/csrc/fused_mp.cu",
                replaces="src/repro/kernels/fused_mp.py:210",
                launches=launches, library_ms=None, **main, all_shapes=rows)


def floor_ms(offsets, n: int, blocks: int, group: int, device) -> float:
    """Median device ms of ``csrc/latency_probe.cu`` on a grid of ``blocks``
    blocks, ``group`` threads a destination, after checking that it wrote
    each thread's degree."""
    import ctypes

    import torch
    from repro_torch.kernels import _build

    lib = _build.load("latency_probe", {"latency_probe_launch": (
        ctypes.c_int, (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))})
    out = torch.empty(blocks * PROBE_THREADS, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def probe():
        err = lib.latency_probe_launch(offsets.data_ptr(), out.data_ptr(), n, group,
                                       blocks, stream)
        if err != 0:
            raise RuntimeError(f"latency_probe launch failed: cudaError_t {err}")

    probe()
    deg = (offsets[1:] - offsets[:-1]).float()
    d = torch.arange(out.numel(), device=device).div(group, rounding_mode="floor")
    if not torch.equal(out, deg[d.clamp(max=n - 1)]):
        raise AssertionError("latency_probe: wrong degrees")
    return device_ms(probe)[0]


def time_segment_reduce(device, packed, lay, launches: int) -> dict:
    """GAT's weighted sum: (E_pad, H * F_head) = (12288, 64) plan-ordered
    values into (4096, 64); the yardstick is ``torch.segment_reduce``."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import segment_reduce as SR

    gen = torch.Generator().manual_seed(10)
    n, e, f = packed.num_nodes, packed.num_edges, 64
    e_real = int(lay.offsets[-1])
    values = torch.randn((e, f), generator=gen).to(device)
    args = (values, lay.ids_sorted, lay.offsets, n, "sum")
    kern = lambda: kops.segment_reduce(*args, mode="kernel")
    plain = lambda: kops.segment_reduce(*args, mode="reference")
    lib = lambda: torch.segment_reduce(values[:e_real], "sum", offsets=lay.offsets,
                                       axis=0)
    err = checked_err("segment_reduce sum (packed GAT shapes)", kern(), plain(), TOL)
    checked_err("torch.segment_reduce (packed GAT shapes)", lib(), plain(), TOL)
    ms, timer = device_ms(kern)
    plain_ms, _ = device_ms(plain)
    library_ms, _ = device_ms(lib)
    vec = SR.vector_width(f, values, torch.empty((n, f), device=device))
    blocks, group = SR.launch_shape(n, f, vec)
    floor = floor_ms(lay.offsets, n, blocks, group, device)
    bound_ms, bound_by = bound(4.0 * (e_real * f + (n + 1) + n * f), 1.0 * e_real * f)
    row = dict(name="segment_reduce", route="cuda",
               source="src/repro_torch/kernels/csrc/segment_reduce.cu",
               replaces="src/repro/kernels/segment_reduce.py:112",
               launches=launches, max_abs_err=err, ms=ms, timer=timer,
               call_ms=call_ms(kern), plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms, floor_ms=floor,
               shape=dict(op="sum", n=n, e_pad=e, e_real=e_real, f=f, vec=vec,
                          blocks=blocks))
    print(f"[time] segment_reduce sum N={n} E={e_real}/{e} F={f}: err {err:.3g}; "
          f"{ms:.4f} ms ({timer}; per call {row['call_ms']:.4f} ms), plain "
          f"{plain_ms:.4f}, torch.segment_reduce {library_ms:.4f}, bound "
          f"{bound_ms:.5f} ({bound_by}), floor {floor:.4f} ({blocks} blocks, "
          f"{group} threads a destination, float{vec if vec > 1 else ''} reads)")
    return row


def time_edge_softmax(device, packed, lay, launches: int) -> dict:
    """GAT's softmax: (12288, 4) plan-ordered logits; no single library
    call computes it."""
    import torch
    from repro_torch.kernels import edge_softmax as ES
    from repro_torch.kernels import ops as kops

    gen = torch.Generator().manual_seed(11)
    n, e, h = packed.num_nodes, packed.num_edges, 4
    e_real = int(lay.offsets[-1])
    logits = torch.randn((e, h), generator=gen).to(device)
    args = (logits, lay.ids_sorted, lay.offsets, n)
    kern = lambda: kops.edge_softmax(*args, mode="kernel")
    plain = lambda: kops.edge_softmax(*args, mode="reference")
    err = checked_err("edge_softmax (packed GAT shapes)", kern(), plain(), TOL)
    ms, timer = device_ms(kern)
    plain_ms, _ = device_ms(plain)
    # read the real logits and the offsets, write every row; per real
    # logit: max, subtract, exp, add, subtract, exp, divide
    bound_ms, bound_by = bound(4.0 * (e_real * h + (n + 1) + e * h), 7.0 * e_real * h)
    blocks, group = ES.launch_shape(n, h, e)
    floor = floor_ms(lay.offsets, n, blocks, group, device)
    row = dict(name="edge_softmax", route="cuda",
               source="src/repro_torch/kernels/csrc/edge_softmax.cu",
               replaces="src/repro/kernels/edge_softmax.py:28",
               launches=launches, max_abs_err=err, ms=ms, timer=timer,
               call_ms=call_ms(kern), plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None, floor_ms=floor,
               shape=dict(n=n, e_pad=e, e_real=e_real, heads=h, blocks=blocks))
    print(f"[time] edge_softmax N={n} E={e_real}/{e} H={h}: err {err:.3g}; "
          f"{ms:.4f} ms ({timer}; per call {row['call_ms']:.4f} ms), plain "
          f"{plain_ms:.4f}, bound {bound_ms:.5f} ({bound_by}), floor {floor:.4f} "
          f"({blocks} blocks, {group} threads a destination)")
    return row


def time_quant_node_mlp(device, lay, launches: int, by_entry: dict) -> dict:
    """``quant_node_mlp`` at the packed GIN int8 path's shapes, the encoder
    (4096, 9 -> 100) and the unfused MLP's first layer (4096, 100 -> 200,
    relu).  The int8 entry (row scales) beside ``torch._int_mm`` (K and N
    zero-padded to multiples of 8 before the timed call, as its shape rules
    need) plus the epilogue in torch; the dynamic entry on fp32 x beside
    the composition it replaced: the row quantization's eager ops (abs,
    amax, clamp, the scale's division, the division, round, + zero, clamp,
    int8 cast) and then the int8 entry.  No single library call quantizes
    rows and multiplies.  Both beside ``floor_ms`` on the launch's 128
    blocks.  The main row is the dynamic entry at the encoder's shape, the
    launch the GIN int8 path makes."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.core.ieee import div_rn
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import quant_mlp as QM
    from repro_torch.quant.qconfig import quantize_int8

    gen = torch.Generator().manual_seed(15)
    n_dst = lay.offsets.numel() - 1
    rows = []
    for m, k, n, act in ((PACKED["n_pad"], 9, 100, "none"),
                         (PACKED["n_pad"], 100, 200, "relu")):
        x_q, w_q, scale, rs, b = qmlp_inputs(gen, m, k, n, device)
        x = dynamic_rows(gen, m, k, device)
        kern = lambda: kops.quant_node_mlp(x_q, w_q, scale, b, act, row_scale=rs,
                                           mode="kernel")
        plain = lambda: kops.quant_node_mlp(x_q, w_q, scale, b, act, row_scale=rs,
                                            mode="reference")
        dyn = lambda: kops.quant_node_mlp_dynamic(x, w_q, scale, b, act, mode="kernel")
        dyn_plain = lambda: kops.quant_node_mlp_dynamic(x, w_q, scale, b, act,
                                                        mode="reference")

        def composition():
            r = div_rn(torch.clamp(torch.abs(x.float()).amax(dim=1, keepdim=True),
                                   min=1e-8), 127.0)
            return kops.quant_node_mlp(quantize_int8(x, r), w_q, scale, b, act,
                                       row_scale=r, mode="kernel")

        kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
        x_p = Fn.pad(x_q, (0, kp - k)).contiguous()
        w_p = Fn.pad(w_q, (0, np_ - n, 0, kp - k)).contiguous()

        def lib():
            y = torch._int_mm(x_p, w_p)[:, :n].float() * scale * rs + b
            return torch.relu(y) if act == "relu" else y

        err = checked_err(f"quant_node_mlp {(m, k, n, act)}", kern(), plain(), QMLP_TOL)
        checked_err(f"torch._int_mm + epilogue {(m, k, n, act)}", lib(), plain(),
                    QMLP_TOL)
        dyn_err = checked_err(f"quant_node_mlp_dynamic {(m, k, n, act)}", dyn(),
                              dyn_plain(), QMLP_TOL)
        checked_err(f"quantize + quant_node_mlp {(m, k, n, act)}", composition(),
                    dyn_plain(), QMLP_TOL)
        floor = floor_ms(lay.offsets, n_dst, QM.blocks(m, n), 8, device)
        # int8 entry: read x_q, w_q, scale, row scales, bias once; write y
        # once; the tail's 4 operations an output
        ms, timer = device_ms(kern)
        plain_ms, _ = device_ms(plain)
        library_ms, _ = device_ms(lib)
        bound_ms, bound_by = bound(m * k + k * n + 4.0 * (n + m + n + m * n),
                                   4.0 * m * n, int8_ops=2.0 * m * k * n)
        rows.append(dict(entry="static", shape=[m, k, n, act, "row_scale"],
                         max_abs_err=err, ms=ms, timer=timer, call_ms=call_ms(kern),
                         plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, floor_ms=floor, blocks=QM.blocks(m, n)))
        # dynamic entry: read fp32 x instead of x_q and the row scales; 6
        # operations an input to quantize (abs, max, divide, round, two
        # clamps)
        ms, timer = device_ms(dyn)
        plain_ms, _ = device_ms(dyn_plain)
        comp_ms, comp_timer = device_ms(composition)
        bound_ms, bound_by = bound(4.0 * m * k + k * n + 4.0 * (n + n + m * n),
                                   6.0 * m * k + 4.0 * m * n, int8_ops=2.0 * m * k * n)
        rows.append(dict(entry="dynamic", shape=[m, k, n, act], max_abs_err=dyn_err,
                         ms=ms, timer=timer, call_ms=call_ms(dyn), plain_ms=plain_ms,
                         library_ms=None, composition_ms=comp_ms,
                         composition_timer=comp_timer, bound_ms=bound_ms,
                         bound_by=bound_by, floor_ms=floor, blocks=QM.blocks(m, n)))
    for r in rows:
        other = (f"_int_mm+epilogue {r['library_ms']:.4f}" if r["entry"] == "static"
                 else f"composition {r['composition_ms']:.4f} ({r['composition_timer']})")
        print(f"[time] quant_node_mlp {r['entry']} {r['shape']}: err "
              f"{r['max_abs_err']:.3g}; {r['ms']:.4f} ms ({r['timer']}; per call "
              f"{r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f}, {other}, bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']}), floor {r['floor_ms']:.4f} "
              f"({r['blocks']} blocks)")
    main = {k: v for k, v in rows[1].items() if k != "entry"}
    return dict(name="quant_node_mlp", route="cuda",
                source="src/repro_torch/kernels/csrc/quant_mlp.cu",
                replaces="src/repro/kernels/quant_mlp.py:60",
                launches=launches, launches_by_entry=by_entry, **main, all_shapes=rows)


def time_fused_mp_int8(device, packed, lay, launches: int) -> dict:
    """The int8 gamma of ``fused_mp`` at the packed plan's shapes, GIN
    (F=100, H=200) and PNA (F=80, K1=960), on exact-aggregate operands; no
    single library call computes a fused layer."""
    import torch
    from repro_torch.kernels import ops as kops

    gen = torch.Generator().manual_seed(16)
    n, e = packed.num_nodes, packed.num_edges
    n_real = int(packed.node_mask.sum())
    e_real = int(lay.offsets[-1])
    rows = []
    for gamma, f in (("gin", 100), ("pna", 80)):
        spec, kw = exact_int8_operands(gen, gamma, n, e, f, device)
        args = (spec, lay.ids_sorted, lay.offsets, lay.src_sorted, lay.in_degree,
                packed.node_mask)
        kern = lambda: kops.fused_mp(*args, mode="kernel", **kw)
        plain = lambda: kops.fused_mp(*args, mode="reference", **kw)
        err = checked_err(f"fused_mp int8 {gamma} (packed shapes)", kern(), plain(),
                          INT8_TOL if gamma == "gin" else dict(rtol=0.0, atol=0.0))
        ms, timer = device_ms(kern)
        plain_ms, _ = device_ms(plain)
        # the plan (offsets, real src ids), msrc and x_res, deg and mask,
        # the weights (w1 int8 + scales), and the output, each once
        plan_b = 4.0 * ((n + 1) + e_real + n) + n
        if gamma == "gin":
            h = 2 * f
            nbytes = (plan_b + 4.0 * (2 * n * f + e_real * f + n * f)
                      + f * h + 4.0 * (2 * h + h * f + f))
            # phi + sum; tower; quantize (abs-max, divide, round); epilogue;
            # second linear
            flops = (3.0 * e_real * f + n_real * f + 3.0 * n_real * f
                     + 4.0 * n_real * h + 2.0 * n_real * h * f + n_real * f)
            int8_ops = 2.0 * n_real * f * h
        else:
            k1 = 12 * f
            nbytes = (plan_b + 4.0 * (2 * n * f + 3 * n + n * f)
                      + k1 * f + 4.0 * 2 * f)
            # sum, sqsum, max, min per edge; mean/std/scalers; quantize;
            # epilogue and residual
            flops = (5.0 * e_real * f + 18.0 * n_real * f + 3.0 * n_real * k1
                     + 5.0 * n_real * f)
            int8_ops = 2.0 * n_real * k1 * f
        bound_ms, bound_by = bound(nbytes, flops, int8_ops=int8_ops)
        census = (tile_census(packed.node_mask, f, 1, f, 2 * f, True) if gamma == "gin"
                  else tile_census(packed.node_mask, f, 4, 12 * f, 0, True))
        rows.append(dict(gamma=gamma, max_abs_err=err, ms=ms, timer=timer,
                         call_ms=call_ms(kern), plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, **census,
                         shape=dict(gamma=gamma, n=n, e_pad=e, e_real=e_real, f=f)))
    for r in rows:
        print(f"[time] fused_mp int8 {r['gamma']} N={n} E={e_real}/{e}: err "
              f"{r['max_abs_err']:.3g}; {r['ms']:.4f} ms ({r['timer']}; per call "
              f"{r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']}); {r['rows']} rows per block, "
              f"{r['live_tiles']} of {r['tiles']} tiles live")
    main = {k: v for k, v in rows[0].items() if k != "gamma"}
    return dict(name="fused_mp_int8", route="cuda",
                source="src/repro_torch/kernels/csrc/fused_mp.cu",
                replaces="src/repro/kernels/fused_mp.py:50",
                launches=launches, library_ms=None, **main, all_shapes=rows)


def time_flash_attention(device, launches: int, by_route: dict, mla_launches: int,
                         mla_by_route: dict) -> list:
    """``flash_attention`` (bf16, causal, the path's (B, S, H, D) layout) at
    ChatGLM3's prefill shape (B 8, Hq 32, Hkv 16 after kv_pad_to, S 512, D
    128), Gemma-3's global layer (B 2, Hq 16, Hkv 16, S 2048, D 256),
    MiniCPM3's MLA prefill (B 8, H 40, S 1024, D 96, Dv 64), InternVL2's
    prefill (B 4, Hq 48, Hkv 16, S 1536 = 1024 patches + 512 tokens, D 128)
    and Whisper's decoder prefill (B 8, H 8, S 64, D 64): the kernel on
    the route the path takes (mma), the CUDA-core route it replaces there
    (simt, forced on the same bf16 tensors), the plain version and
    ``scaled_dot_product_attention`` on the same tensors (``is_causal``,
    ``enable_gqa``).  Returns two kernel rows: the (D, D) instances' (at
    ChatGLM3's shape, with ``launches``) and the (96, 64) instance's (at
    MiniCPM3's, with ``mla_launches``)."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops as kops

    gen = torch.Generator().manual_seed(18)
    rows = []
    for name, (b, hq, hkv, s, d, dv) in (
            ("chatglm3-6b prefill", (8, 32, 16, 512, 128, 128)),
            ("gemma3-12b global layer", (2, 16, 16, 2048, 256, 256)),
            ("minicpm3-4b prefill", (8, 40, 40, 1024, 96, 64)),
            ("internvl2-26b prefill", (4, 48, 16, 1536, 128, 128)),
            ("whisper-base decoder prefill", (8, 8, 8, 64, 64, 64))):
        q, k, v = attention_inputs(gen, b, hq, hkv, s, d, torch.bfloat16, device, "bshd",
                                   dv)
        kern = lambda: kops.flash_attention(q, k, v, mode="kernel")
        simt = lambda: FA.flash_attention(q, k, v, force_route="simt")
        plain = lambda: kops.flash_attention(q, k, v, mode="reference")
        lib = lambda: Fn.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
        want = plain().float()
        err = checked_err(f"flash_attention ({name} shape)", kern().float(), want,
                          FLASH_TOL["bfloat16"])
        simt_err = checked_err(f"flash_attention simt route ({name} shape)",
                               simt().float(), want, FLASH_TOL["bfloat16"])
        checked_err(f"scaled_dot_product_attention ({name} shape)", lib().float(),
                    want, FLASH_TOL["bfloat16"])
        del want
        ms, timer = device_ms(kern)
        simt_ms, _ = device_ms(simt, 10)
        plain_ms, _ = device_ms(plain, 10)
        library_ms, _ = device_ms(lib)
        # q, k, v read once, o written once; 2 (D + Dv) operations per causal
        # pair (a D-long and a Dv-long dot product)
        nbytes = 2.0 * (b * hq * s * (d + dv) + b * hkv * s * (d + dv))
        pairs = s * (s + 1) / 2
        bound_ms, bound_by = bound(nbytes, 0.0, bf16_ops=2.0 * (d + dv) * b * hq * pairs)
        row = dict(max_abs_err=err, ms=ms, timer=timer, call_ms=call_ms(kern),
                   design=FA.route(q.dtype, d, dv), simt_ms=simt_ms,
                   simt_max_abs_err=simt_err, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms,
                   shape=dict(name=name, b=b, hq=hq, hkv=hkv, s=s, d=d, dv=dv,
                              dtype="bfloat16", causal=True, layout="bshd"))
        rows.append(row)
        print(f"[time] flash_attention {name} B={b} Hq={hq} Hkv={hkv} S={s} D={d} Dv={dv} bf16 "
              f"causal: err {err:.3g}; {row['design']} {ms:.4f} ms ({timer}; per call "
              f"{row['call_ms']:.4f} ms), simt route {simt_ms:.4f} (err {simt_err:.3g}), "
              f"plain {plain_ms:.4f}, sdpa {library_ms:.4f}, bound {bound_ms:.5f} "
              f"({bound_by})")
        del q, k, v
        torch.cuda.empty_cache()
    main, mla = ({k: v for k, v in r.items() if k != "design"} for r in (rows[0], rows[2]))
    common = dict(route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
                  replaces="src/repro/kernels/flash_attention.py:90")
    # the (96, 64) instance's row counts the launches of the MiniCPM3 path,
    # whose every flash launch is at (96, 64); "counter" names the wrapper
    # counter both rows read
    return [dict(name="flash_attention", **common, launches=launches,
                 launches_by_route=by_route, **main, all_shapes=rows),
            dict(name="flash_attention_d96_dv64", counter="flash_attention", **common,
                 launches=mla_launches, launches_by_route=mla_by_route, **mla)]


# ------------------------------------------------------------ entry point


# ---------------------------------------------------------------------------
# phase 12: the multi-rank substrate and the sharded GNN path
# ---------------------------------------------------------------------------

MESH_WORLD = 2  # gloo ranks, all on the one card
MESH_TIMEOUT_S = 300  # a world, its ranks killed past it
MESH_MODELS = ("gcn", "gin", "gin_vn", "gat", "pna", "dgn")
MESH_BATCH = (4, 128, 384)  # JAX's sharded-serving bucket: graphs, n_pad, e_pad
MESH_GRAPHS = 32
MESH_REPS = 3
MESH_TOL = dict(rtol=1e-5, atol=1e-5)  # make_sharded_mp vs the dense sum
CPSUM_BOUND = 0.02  # JAX's int8 bound (tests/test_distributed.py)
PUBMED = dict(n=19717, e=88648, f=100)  # the substrate's PubMed-sized graph
PUBMED_GIN_FEAT = 500  # PubMed's node features, for the GIN forward
MESH_PATH_KERNELS = {"gat": ("node_mlp", "edge_softmax", "segment_reduce")}
MESH_STREAM = dict(qps=500.0, max_wait_s=0.004)  # GIN's stream with arrivals
# node-level outputs sharded = whole bit for bit: every reduction of these
# models runs per destination in the plan's edge order (GIN+VN's virtual
# node pools a graph's rows across ranks, two partial sums: tolerance)
NODE_BITS_MODELS = ("gcn", "gin", "gat", "pna", "dgn")


def mesh_graphs(k: int, feat: int = 9, edge: int = 3) -> list:
    """JAX's sharded-serving graphs (tests/test_gnn_serving.py, seed 0)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(k):
        n = int(rng.integers(6, 16))
        e = int(rng.integers(n, 2 * n))
        out.append((rng.integers(0, n, e).astype(np.int32),
                    rng.integers(0, n, e).astype(np.int32),
                    rng.normal(size=(n, feat)).astype(np.float32),
                    rng.normal(size=(e, edge)).astype(np.float32)))
    return out


def mesh_sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mp_case(mesh, n: int, e: int, f: int, device, n_pad: int) -> dict:
    """make_sharded_mp, both strategies, against the dense sum on one
    graph drawn as tests/test_distributed.py draws it (seed 0; ``n`` real
    nodes of ``n_pad`` rows); -> errors, times and bytes received."""
    import torch
    from repro_torch import runtime as RT
    from repro_torch.runtime import partitioning as PT

    p = mesh.size
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    x = np.zeros((n_pad, f), np.float32)
    x[:n] = rng.normal(size=(n, f)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)
    ref = torch.zeros((n_pad, f), dtype=torch.float64, device=device)
    ref.index_add_(0, t(dst).long(), 2.0 * t(x).double()[t(src).long()])
    ref = ref.float()
    phi = lambda m: m * 2.0
    n_local = n_pad // p
    order = np.argsort(src // n_local, kind="stable")
    src_s, dst_s = src[order], dst[order]
    per = int(np.bincount(src_s // n_local, minlength=p).max())
    src_p = np.zeros((p, per), np.int32)
    dst_p = np.zeros((p, per), np.int32)
    msk_p = np.zeros((p, per), bool)
    pairs = np.zeros((p, p), np.int64)
    for r in range(p):
        e_r = np.where(src_s // n_local == r)[0]
        src_p[r, :len(e_r)] = src_s[e_r] % n_local
        dst_p[r, :len(e_r)] = dst_s[e_r]
        msk_p[r, :len(e_r)] = True
        pairs[r] = np.bincount(dst_s[e_r] // n_local, minlength=p)
    cases = {
        "allgather": (RT.make_sharded_mp(mesh, "data", phi, "allgather"),
                      (t(x), t(src), t(dst), t(np.ones(e, bool)))),
        # the busiest (source rank -> destination rank) pair bounds the
        # slots, so nothing drops
        "alltoall": (RT.make_sharded_mp(mesh, "data", phi, "alltoall",
                                        capacity=int(pairs.max())),
                     (t(x), t(src_p.reshape(-1)), t(dst_p.reshape(-1)),
                      t(msk_p.reshape(-1)))),
    }
    res = {}
    for name, (fn, args) in cases.items():
        out = fn(*args)
        mesh_sync(device)
        err = max_err(out, ref)
        if not close(out, ref, MESH_TOL) or not torch.isfinite(out).all():
            raise AssertionError(f"mesh {name} n={n}: max err {err:.3g}")
        times = []
        for _ in range(MESH_REPS):
            PT.reset_collective_bytes()
            t0 = time.perf_counter()
            fn(*args)
            mesh_sync(device)
            times.append(time.perf_counter() - t0)
        res[name] = {"max_abs_err": err, "ms": statistics.median(times) * 1e3,
                     "bytes": dict(PT.collective_bytes)}
    return res


def mesh_substrate(mesh, device) -> dict:
    """make_sharded_mp on JAX's data (N 32, E 64, F 6) and at the PubMed
    size; compressed_psum against the exact sum."""
    import torch
    from repro_torch.optim.compression import compressed_psum

    p = mesh.size
    out = {"jax_data": mp_case(mesh, 32, 64, 6, device, 32)}
    n_pad = -(-PUBMED["n"] // p) * p
    out["pubmed"] = mp_case(mesh, PUBMED["n"], PUBMED["e"], PUBMED["f"], device, n_pad)
    g = np.random.default_rng(0).normal(size=(p, 128)).astype(np.float32)
    got = compressed_psum(torch.from_numpy(g[mesh.coordinate("data")]).to(device))
    want = g.sum(axis=0)
    rel = float(np.abs(got.cpu().numpy() - want).max() / (np.abs(want).max() + 1e-9))
    if not rel < CPSUM_BOUND:
        raise AssertionError(f"compressed_psum relative error {rel:.3g}")
    out["compressed_psum_rel"] = rel
    return out


def batch_runs(ex, prepared: list) -> tuple:
    """(outputs, per-batch seconds over MESH_REPS passes, the warm's
    collective bytes) of prepared batches through ``ex``, warmed first,
    untimed; the launch counters and ``PT.collective_bytes`` then count the
    timed passes only (a captured executor's replays run no wrapper and no
    Python collective: its warm, an eager forward and a capture a
    signature, counts them)."""
    from repro_torch.runtime import partitioning as PT

    PT.reset_collective_bytes()
    for p_ in prepared:
        ex.warm(p_)
    warm_bytes = dict(PT.collective_bytes)
    reset_launches()
    PT.reset_collective_bytes()
    outs, secs = None, []
    for _ in range(MESH_REPS):
        res = [ex.run(p_) for p_ in prepared]
        outs = np.concatenate([o[: p_.num_graphs] for (o, _), p_ in zip(res, prepared)])
        secs += [dt for _, dt in res]
    return outs, secs, warm_bytes


MESH_PROFILE_SESSIONS = 2  # the same on every rank: each runs the forward


def mesh_replay_kernels(fn) -> tuple:
    """({counter: launches}, NCCL kernels, device ops) of one call of
    ``fn`` (a served replay) by ``torch.profiler``: the larger record of
    MESH_PROFILE_SESSIONS sessions, so that every rank of a world calls
    ``fn`` (and its collectives) as often (``device_events`` profiles
    again where a session lost its record)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    records = []
    for _ in range(MESH_PROFILE_SESSIONS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        records.append([e.name for e in prof.events() if e.device_type == DeviceType.CUDA])
    names = max(records, key=len)
    counts = {name: sum(symbol in n for n in names) for symbol, name in KERNEL_SYMBOLS}
    return counts, sum("nccl" in n.lower() for n in names), len(names)


def served_node_bits(mesh, model: str, graphs: list, device) -> dict:
    """A node task's outputs served through ``Executor.run`` sharded over
    ``mesh`` (captured on NCCL) and through an executor without a mesh,
    both warmed and run under deterministic algorithms: bit for bit?"""
    import torch
    from repro_torch.configs.gengnn_models import get_gnn_config
    from repro_torch.gnn import init
    from repro_torch.serve.executor import Executor

    bsz, n_pad, e_pad = MESH_BATCH
    cfg = dataclasses.replace(get_gnn_config(model), task="node")
    params = init(torch.Generator().manual_seed(0), cfg)
    torch.use_deterministic_algorithms(True)
    try:
        outs = []
        for m in (mesh, None):
            ex = Executor(buckets=((n_pad, e_pad),), device=device, mesh=m)
            ex.register("node", cfg, params, fused=True)
            p = ex.prepare_batched(graphs[:bsz], bsz, n_pad, e_pad,
                                   with_eigvec=model == "dgn")
            outs.append((ex.run(p)[0], ex.captured, ex.lowered_count))
    finally:
        torch.use_deterministic_algorithms(False)
    (a, captured, lowered), (b, _, _) = outs
    return {"bits": bool(np.array_equal(a, b)), "captured": captured, "lowered": lowered,
            "max_abs_err": float(np.abs(a - b).max())}


def node_outputs(ex, tenant, p, sharded: bool):
    """A node task's outputs of one prepared batch: every layer's rows
    through the head, sharded under the executor's mesh or whole."""
    import torch
    from repro_torch.core import layout as LY
    from repro_torch.core import message_passing as MP
    from repro_torch.gnn import models as M
    from repro_torch.runtime import partitioning as PT

    cfg = dataclasses.replace(tenant.cfg, task="node")
    g, eig, _ = p.inputs
    was = torch.are_deterministic_algorithms_enabled()
    # the plain segment sums (index_add_) in edge order, not by atomics
    torch.use_deterministic_algorithms(True)
    with torch.inference_mode(), ex._mesh_scope():
        if sharded:
            shard = PT.row_shard(g.num_nodes)
            if shard is None:
                raise AssertionError(f"{cfg.model}: the batch did not shard")
            g, eig, lay = MP.shard_inputs(g, eig, LY.build_layout(g), shard)
        else:
            lay = None
        out = M.apply(tenant.params, g, cfg, eigvec=eig, num_graphs=p.num_graphs,
                      layout=lay, fused=tenant.fused)
    mesh_sync(out.device)
    torch.use_deterministic_algorithms(was)
    return out


def mesh_serve(mesh, device) -> dict:
    """The six paper models at paper width through GNNEngine(mesh=...)
    batched (4 graphs to a (128, 384) bucket) against the unsharded
    engine; node-level outputs sharded against whole bit for bit; GIN
    fp32 and int8 packed through the StreamScheduler."""
    import torch
    from repro_torch.configs.gengnn_models import get_gnn_config
    from repro_torch.gnn import init
    from repro_torch.runtime import partitioning as PT
    from repro_torch.serve.executor import captures
    from repro_torch.serve.gnn_engine import GNNEngine
    from repro_torch.serve.scheduler import StreamScheduler

    from repro_torch.data.pipeline import MOLHIV, MoleculeStream

    bsz, n_pad, e_pad = MESH_BATCH
    # MolHIV-like graphs fill 77-106 of a batch's 128 rows, so both ranks
    # hold real nodes (JAX's 6-16-node test graphs would leave rank 1 only
    # padding)
    graphs = [g[:4] for g in MoleculeStream(MOLHIV, seed=0).take(MESH_GRAPHS)]
    res = {}
    launches_total = None
    for model in MESH_MODELS:
        cfg = get_gnn_config(model)
        params = init(torch.Generator().manual_seed(0), cfg)
        eig = model == "dgn"
        plain = GNNEngine(cfg, params, fused=True, device=device)
        sharded = GNNEngine(cfg, params, fused=True, device=device, mesh=mesh)
        prep = lambda eng: [eng.executor.prepare_batched(
            graphs[i:i + bsz], bsz, n_pad, e_pad, with_eigvec=eig)
            for i in range(0, len(graphs), bsz)]
        out_s, secs_s, warm_bytes = batch_runs(sharded.executor, prep(sharded))
        launches = read_launches()
        gathered = dict(PT.collective_bytes)
        forwards = MESH_REPS * len(graphs) // bsz
        out_p, secs_p, _ = batch_runs(plain.executor, prep(plain))
        agree(f"mesh {model} sharded vs unsharded", out_s, out_p, SERVE_TOL)
        ex = sharded.executor
        captured = captures(device.type, mesh.size, mesh.backend)
        if ex.captured != captured or bool(ex.lowered_count) != captured:
            raise AssertionError(f"mesh {model} over {mesh.backend}: captured "
                                 f"{ex.captured}, {ex.lowered_count} captures")
        p0 = prep(sharded)[0]
        nccl = ops = None
        if captured:
            # a replay runs no wrapper: its kernels by the profiler; the
            # warm's bytes are two forwards' (eager + capture), one bucket
            launches, nccl, ops = mesh_replay_kernels(lambda: ex.run(p0))
            gathered, forwards = warm_bytes, 2
        if device.type == "cuda":
            for kernel in MESH_PATH_KERNELS.get(model, ("node_mlp", "fused_mp")):
                if launches[kernel] <= 0:
                    raise AssertionError(f"mesh {model}: {kernel} never launched")
        a = node_outputs(sharded.executor, sharded._tenant, p0, True)
        b = node_outputs(sharded.executor, sharded._tenant, p0, False)
        agree(f"mesh {model} node outputs", a.cpu(), b.cpu(), SERVE_TOL)
        bits = bool(torch.equal(a, b))
        served = served_node_bits(mesh, model, graphs, device)
        if device.type == "cuda" and model in NODE_BITS_MODELS and not (
                bits and served["bits"]):
            raise AssertionError(f"mesh {model}: node outputs differ in bits, max err "
                                 f"{max_err(a, b):.3g}; served {served}")
        if served["captured"] != captured:
            raise AssertionError(f"mesh {model}: the node task's executor {served}")
        res[model] = {
            "p50_ms": statistics.median(secs_s) * 1e3,
            "plain_p50_ms": statistics.median(secs_p) * 1e3,
            "all_gather_bytes_per_layer": gathered["all_gather"] / (forwards * cfg.num_layers),
            "all_reduce_bytes_per_forward": gathered["all_reduce"] / forwards,
            "captured": sharded.executor.captured,
            "plain_captured": plain.executor.captured,
            "max_abs_err": max_err(torch.as_tensor(out_s), torch.as_tensor(out_p)),
            "node_bits_equal": bits, "served_node_bits_equal": served["bits"],
            "launches": launches, "nccl_kernels": nccl, "device_ops": ops,
        }
        launches_total = launches if launches_total is None else {
            k: launches_total[k] + v for k, v in launches.items()}
        del plain, sharded
    cfg = get_gnn_config("gin")
    params = init(torch.Generator().manual_seed(0), cfg)
    plain_outs = {}
    for precision in ("fp32", "int8"):
        reps = [StreamScheduler(GNNEngine(cfg, params, fused=True, device=device,
                                          precision=precision, mesh=m),
                                capacity=4).run(graphs, qps=0.0)
                for m in (None, mesh)]
        plain_outs[precision] = np.stack(reps[0].outputs)
        agree(f"mesh gin {precision} packed", np.stack(reps[1].outputs),
              plain_outs[precision], SERVE_TOL)
        res[f"gin {precision} packed"] = {
            "flushes": len(reps[1].batch_sizes),
            "p50_ms": reps[1].percentile_ms(50), "plain_p50_ms": reps[0].percentile_ms(50)}
    res["gin stream"] = mesh_stream(mesh, cfg, params, graphs, plain_outs["fp32"], device)
    res["launches_total"] = launches_total
    return res


def mesh_stream(mesh, cfg, params, graphs, want, device) -> dict:
    """GIN fp32 as a stream with arrivals (MESH_STREAM) through the
    StreamScheduler on the mesh: each rank measures its own flush times,
    and the ranks must keep one schedule (flushes, rungs and their
    instants equal on every rank) and serve ``want``."""
    import torch.distributed as dist
    from repro_torch.serve.gnn_engine import GNNEngine
    from repro_torch.serve.scheduler import StreamScheduler

    rep = StreamScheduler(GNNEngine(cfg, params, fused=True, device=device, mesh=mesh),
                          capacity=4, max_wait_s=MESH_STREAM["max_wait_s"]
                          ).run(graphs, qps=MESH_STREAM["qps"])
    schedule = [(f.rids, f.rung_multiple, f.at_s, f.done_s) for f in rep.flush_log]
    every = [None] * mesh.size
    dist.all_gather_object(every, schedule)
    if any(other != schedule for other in every):
        raise AssertionError("mesh gin stream: the ranks took different schedules")
    agree("mesh gin stream", np.stack(rep.outputs), want, SERVE_TOL)
    return {"flushes": len(schedule), "rungs": sorted({f[1] for f in schedule}),
            "p50_ms": rep.percentile_ms(50), "p99_ms": rep.percentile_ms(99)}


def mesh_pubmed_gin(mesh, device) -> dict:
    """One GIN forward (paper width, node task, 3 classes) on a synthetic
    PubMed-sized graph: 19,717 nodes (19,718 rows), 88,648 edges,
    PUBMED_GIN_FEAT features.  Served: ``Executor.run`` on the prepared
    batch, sharded (the executor's own path: captured on NCCL, eager on
    gloo) against an executor without a mesh (captured on the card), timed
    over MESH_REPS runs; on NCCL also the sharded program run eagerly.  Bit
    for bit: the node outputs of the same forward sharded and whole, run
    directly under deterministic algorithms (``node_outputs``)."""
    import torch
    from repro_torch.configs.gengnn_models import get_gnn_config
    from repro_torch.core import graph as G
    from repro_torch.gnn import init
    from repro_torch.serve.executor import Executor, captures, prepared

    cfg = get_gnn_config("gin", feat_dim=PUBMED_GIN_FEAT, task="node", out_dim=3)
    rng = np.random.default_rng(1)
    n, e = PUBMED["n"], PUBMED["e"]
    n_pad = -(-n // mesh.size) * mesh.size
    raw = (rng.integers(0, n, e).astype(np.int32), rng.integers(0, n, e).astype(np.int32),
           rng.normal(size=(n, cfg.feat_dim)).astype(np.float32),
           rng.normal(size=(e, cfg.edge_dim)).astype(np.float32))
    params = init(torch.Generator().manual_seed(0), cfg)
    ex = Executor(buckets=((n_pad, e),), device=device, mesh=mesh)
    whole = Executor(buckets=((n_pad, e),), device=device)
    tenant = ex.register("pubmed", cfg, params, fused=True)
    whole.register("pubmed", cfg, params, fused=True)
    g = G.from_numpy(*raw, n_pad=n_pad, e_pad=e, device=device)
    p = prepared(g, None, None, ("pubmed", n_pad, e), 1)
    served = {}
    for name, x in (("sharded", ex), ("whole", whole)):
        reset_launches()
        x.warm(p)
        runs = [x.run(p) for _ in range(MESH_REPS)]
        launches = read_launches()  # a captured executor's: its warm's
        if name == "sharded" and device.type == "cuda" and not (
                launches["fused_mp"] > 0 and launches["node_mlp"] > 0):
            raise AssertionError(f"pubmed gin: launches {launches}")
        served[name] = (runs[-1][0], statistics.median(dt for _, dt in runs))
    captured = captures(device.type, mesh.size, mesh.backend)
    if ex.captured != captured or bool(ex.lowered_count) != captured:
        raise AssertionError(f"pubmed gin over {mesh.backend}: captured {ex.captured}, "
                             f"{ex.lowered_count} captures")
    eager_ms = None
    if captured:  # the same sharded program run eagerly, timed alike
        fn = ex._program(tenant, p.bucket_key, p.num_graphs).fn
        times = []
        with torch.inference_mode():
            for _ in range(MESH_REPS + 1):
                mesh_sync(device)
                t0 = time.perf_counter()
                fn(tenant.params, *ex._inputs(p))
                mesh_sync(device)
                times.append(time.perf_counter() - t0)
        eager_ms = statistics.median(times[1:]) * 1e3
    agree("mesh pubmed gin served", served["sharded"][0], served["whole"][0], SERVE_TOL)
    a = node_outputs(ex, tenant, p, True)
    b = node_outputs(ex, tenant, p, False)
    agree("mesh pubmed gin", a.cpu(), b.cpu(), SERVE_TOL)
    bits = bool(torch.equal(a, b))
    if device.type == "cuda" and not bits:
        raise AssertionError(f"pubmed gin: bits differ, max err {max_err(a, b):.3g}")
    return {"ms": served["sharded"][1] * 1e3, "plain_ms": served["whole"][1] * 1e3,
            "eager_ms": eager_ms, "captured": ex.captured, "plain_captured": whole.captured,
            "max_abs_err": max_err(torch.as_tensor(served["sharded"][0]),
                                   torch.as_tensor(served["whole"][0])),
            "node_bits_equal": bits, "out_shape": list(a.shape)}


def mesh_nccl_engine(mesh, device) -> dict:
    """GIN batched through a 1-rank NCCL mesh: the executor captures, and
    serves the unsharded engine's bits."""
    import torch
    from repro_torch.configs.gengnn_models import get_gnn_config
    from repro_torch.gnn import init
    from repro_torch.serve.gnn_engine import GNNEngine

    bsz, n_pad, e_pad = MESH_BATCH
    graphs = mesh_graphs(8)
    cfg = get_gnn_config("gin")
    params = init(torch.Generator().manual_seed(0), cfg)
    a = GNNEngine(cfg, params, fused=True, device=device, mesh=mesh)
    b = GNNEngine(cfg, params, fused=True, device=device)
    out_a = a.infer_batched(graphs, bsz, n_pad, e_pad)[0]
    out_b = b.infer_batched(graphs, bsz, n_pad, e_pad)[0]
    if device.type == "cuda" and not (a.executor.captured and a.executor.lowered_count):
        raise AssertionError("nccl mesh: the executor did not capture")
    agree("nccl mesh engine vs unsharded", out_a, out_b, SERVE_TOL)
    return {"captured": a.executor.captured, "lowered": a.executor.lowered_count}


def mesh_rank_main(argv: list) -> int:
    """One rank of a phase-12 world (``--mesh-rank R --mesh-world W
    --mesh-backend B --mesh-init URL --mesh-out DIR [--mesh-device D]``):
    join the process group, run the world's checks, write
    ``rank<R>.json``."""
    import argparse

    import torch
    import torch.distributed as dist
    from repro_torch import runtime as RT

    ap = argparse.ArgumentParser()
    for flag in ("--mesh-rank", "--mesh-world"):
        ap.add_argument(flag, type=int, required=True)
    for flag in ("--mesh-backend", "--mesh-init", "--mesh-out"):
        ap.add_argument(flag, required=True)
    ap.add_argument("--mesh-device", default="cuda")
    ap.add_argument("--mesh-job", default="gnn",
                    choices=("gnn", "train", "hang", "decode"))
    a = ap.parse_args(argv)
    device = torch.device(a.mesh_device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # NCCL: a card a rank; gloo: every rank on the first card
        index = a.mesh_rank if a.mesh_backend == "nccl" else 0
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
    step = lambda what: print(f"[rank {a.mesh_rank}] {what}", flush=True)
    dist.init_process_group(a.mesh_backend, init_method=a.mesh_init,
                            world_size=a.mesh_world, rank=a.mesh_rank)
    try:
        if a.mesh_job == "train":
            res = train_mesh_rank(a.mesh_out, device, step)
            Path(a.mesh_out, f"rank{a.mesh_rank}.json").write_text(json.dumps(res))
            gc.collect()  # graphs that captured NCCL go before their communicators
            dist.barrier()
            return 0
        if a.mesh_job == "decode":
            res = mesh_decode_rank(device, step)
            Path(a.mesh_out, f"rank{a.mesh_rank}.json").write_text(json.dumps(res))
            dist.barrier()
            return 0
        if a.mesh_job == "hang":
            res = hang_case_rank(device, step)
            Path(a.mesh_out, f"rank{a.mesh_rank}.json").write_text(json.dumps(res))
            return 0
        mesh = RT.make_flat_mesh(a.mesh_world, axis="data", device=device)
        step(f"joined {mesh}")
        res = {"backend": mesh.backend, "substrate": mesh_substrate(mesh, device)}
        step("substrate done")
        if a.mesh_world > 1:
            res["serve"] = mesh_serve(mesh, device)
            step("serving done")
            res["pubmed_gin"] = mesh_pubmed_gin(mesh, device)
        else:
            res["engine"] = mesh_nccl_engine(mesh, device)
        step("done")
        Path(a.mesh_out, f"rank{a.mesh_rank}.json").write_text(json.dumps(res))
        gc.collect()  # graphs that captured NCCL go before their communicators
        dist.barrier()
    finally:
        dist.destroy_process_group()
        step("left the process group")
    return 0


def mesh_world(backend: str, world: int, out_dir: Path, device: str = "cuda",
               job: str = "gnn", cases=None, timeout_s: float = MESH_TIMEOUT_S) -> list:
    """Start a world of ``world`` ranks of this script (``job`` "gnn": phase
    12's checks; "train": phase 13's ``cases``, written to
    ``out_dir/cases.json``), wait for all of them (killed at
    ``timeout_s``) and return each rank's results."""
    import shutil

    if out_dir.exists():
        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    if cases is not None:
        (out_dir / "cases.json").write_text(json.dumps(cases))
    init = "file://" + str(out_dir / "rendezvous")
    env = dict(child_env(), PYTHONFAULTHANDLER="1")  # a crashed rank's stack
    if backend == "nccl":
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")  # bootstrap over the loopback
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank", str(r),
         "--mesh-world", str(world), "--mesh-backend", backend, "--mesh-init", init,
         "--mesh-out", str(out_dir), "--mesh-device", device, "--mesh-job", job],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT)) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    outs, hung = [], False
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0)))
        except subprocess.TimeoutExpired:
            hung = True
            for q in procs:
                q.kill()
            outs.append(p.communicate())  # how far it came
    failed = [f"rank {r} exited {p.returncode}:\n{o[-2000:]}\n{e[-4000:]}"
              for r, (p, (o, e)) in enumerate(zip(procs, outs)) if p.returncode != 0]
    if failed:
        what = f"hung past {timeout_s} s" if hung else "failed"
        raise AssertionError(f"mesh {backend} x{world} {what}: " + "\n".join(failed))
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]


def mp_line(tag: str, sub: dict) -> str:
    return " ".join(
        f"{name} err {c['max_abs_err']:.2e} {c['ms']:.3f} ms "
        f"{sum(c['bytes'].values()) / 1e6:.3f} MB"
        for name, c in sub.items()) + f" ({tag})"


def serve_lines(ranks: list, backend: str, card: str) -> None:
    """The ``[mesh gnn ...]`` and ``[mesh pubmed gin]`` lines of a world's
    ranks (``mesh_serve``, ``mesh_pubmed_gin``); a captured executor's
    launches are a replay's, by the profiler, with its NCCL kernels."""
    world = len(ranks)
    r0 = ranks[0]["serve"]
    for model in MESH_MODELS:
        rows = [g["serve"][model] for g in ranks]
        kind = "a replay's (profiler)" if rows[0]["captured"] else "timed passes'"
        print(f"[mesh gnn {model}] {world} {backend} ranks, batched 4 x (128, 384): p50 "
              f"{rows[0]['p50_ms']:.3f} ms sharded (captured {rows[0]['captured']}) | "
              f"{rows[0]['plain_p50_ms']:.3f} ms unsharded (captured "
              f"{rows[0]['plain_captured']}); all-gathered "
              f"{rows[0]['all_gather_bytes_per_layer']:.0f} B/layer/rank, all-reduced "
              f"{rows[0]['all_reduce_bytes_per_forward']:.0f} B/forward; max err "
              f"{rows[0]['max_abs_err']:.2e}; node outputs bit for bit "
              f"{rows[0]['node_bits_equal']} (served {rows[0]['served_node_bits_equal']}); "
              f"launches fused_mp / node_mlp, {kind}: " + ", ".join(
                  f"rank {r} {row['launches']['fused_mp']}/{row['launches']['node_mlp']}"
                  + (f" + {row['nccl_kernels']} nccl of {row['device_ops']} ops"
                     if row["nccl_kernels"] is not None else "")
                  for r, row in enumerate(rows)) + f"; {card}")
    for precision in ("fp32", "int8"):
        row = r0[f"gin {precision} packed"]
        print(f"[mesh gnn gin {precision} packed] {world} {backend} ranks, StreamScheduler "
              f"capacity 4, {MESH_GRAPHS} graphs, {row['flushes']} flushes: p50 "
              f"{row['p50_ms']:.3f} ms sharded | {row['plain_p50_ms']:.3f} ms unsharded; "
              f"{card}")
    st = r0["gin stream"]
    print(f"[mesh gnn gin stream] {world} {backend} ranks, StreamScheduler capacity 4, "
          f"{MESH_GRAPHS} graphs at {MESH_STREAM['qps']:g} qps, max-wait "
          f"{MESH_STREAM['max_wait_s'] * 1e3:g} ms: {st['flushes']} flushes at rungs "
          f"{st['rungs']}, one schedule on every rank; p50 {st['p50_ms']:.3f} ms p99 "
          f"{st['p99_ms']:.3f} ms; {card}")
    pm = ranks[0]["pubmed_gin"]
    eager = "" if pm["eager_ms"] is None else f" | {pm['eager_ms']:.2f} ms sharded eager"
    print(f"[mesh pubmed gin] 19717 nodes, 88648 edges, {PUBMED_GIN_FEAT} features, "
          f"node task, Executor.run median of {MESH_REPS}: {pm['ms']:.2f} ms sharded "
          f"over {world} {backend} (captured {pm['captured']}){eager} | "
          f"{pm['plain_ms']:.2f} ms whole (captured {pm['plain_captured']}); max err "
          f"{pm['max_abs_err']:.2e}; out {pm['out_shape']}, bit for bit under "
          f"deterministic algorithms {pm['node_bits_equal']}; {card}")


def mesh_phase(device, card: str) -> dict:
    """Phase 12: a 2-rank gloo world on the card (substrate, six models
    sharded, GIN packed, the PubMed-sized GIN forward), a 1-rank NCCL world
    (substrate, a capturing mesh engine), and the launcher with --gnn-mesh
    2 as a child process; -> each gloo rank's launch counts on the sharded
    paths."""
    t0 = time.perf_counter()
    out_root = ROOT / "build" / "mesh"
    dev = "cuda" if device.type == "cuda" else "cpu"
    gloo = mesh_world("gloo", MESH_WORLD, out_root / "gloo", dev)
    nccl = (mesh_world("nccl", 1, out_root / "nccl", dev)
            if device.type == "cuda" else [])
    for tag, ranks in (("gloo", gloo), ("nccl", nccl)):
        for r, res in enumerate(ranks):
            sub = res["substrate"]
            print(f"[mesh substrate {tag} x{len(ranks)} rank {r}] jax data: "
                  f"{mp_line('N 32, E 64, F 6', sub['jax_data'])}; pubmed: "
                  f"{mp_line('N 19717, E 88648, F 100', sub['pubmed'])}; "
                  f"compressed_psum rel {sub['compressed_psum_rel']:.2e}; {card}")
    for res in nccl:
        print(f"[mesh nccl x1 engine] gin batched: captured {res['engine']['captured']}, "
              f"{res['engine']['lowered']} captures, = the unsharded engine; {card}")
    serve_lines(gloo, "gloo", card)
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--gnn", "gin",
            "--batched", "--gnn-mesh", "2", "--n-graphs", "12", "--batch", "4"]
    if device.type != "cuda":
        argv += ["--device", "cpu"]
    out = run_child(argv, "launcher --gnn-mesh 2")
    line = next((ln for ln in out.splitlines() if "mesh=2" in ln), "")
    if "backend=gloo" not in line:
        raise AssertionError(f"launcher --gnn-mesh 2 printed no mesh line:\n{out}")
    print(f"[mesh launcher] {line.strip()}")
    print(f"[mesh] phase 12 took {time.perf_counter() - t0:.1f}s")
    return {f"mesh gloo rank{r}": g["serve"]["launches_total"]
            for r, g in enumerate(gloo)}


# ---------------------------------------------------------------------------
# four cards: NCCL communicators under captured replays (--gnn-mesh-cards)
# ---------------------------------------------------------------------------

# The hang case: HANG_ROUNDS rounds of HANG_REPLAYS replays of a sharded,
# captured forward, their harvests and a barrier; a world past
# HANG_TIMEOUT_S is killed.
HANG_REPLAYS = 200
HANG_ROUNDS = 5
HANG_TIMEOUT_S = 75


def hang_case_rank(device, step) -> dict:
    """One rank of the executor's hang case: GIN (paper width, fp32 fused)
    sharded and captured on the world's NCCL mesh at the (128, 384) bucket;
    HANG_ROUNDS rounds of HANG_REPLAYS ``run_async`` replays, then their
    harvests (each waits for its event, all-reduces its seconds MAX on the
    mesh's group: ``Executor._slowest``, and copies its output to the
    host) and a barrier, with no synchronize between; then a profiled
    replay and a barrier, and the executor dropped and a barrier."""
    import torch
    import torch.distributed as dist
    from repro_torch import runtime as RT
    from repro_torch.configs.gengnn_models import get_gnn_config
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream
    from repro_torch.gnn import init
    from repro_torch.serve.executor import Executor

    bsz, n_pad, e_pad = MESH_BATCH
    mesh = RT.make_flat_mesh(dist.get_world_size(), axis="data", device=device)
    cfg = get_gnn_config("gin")
    ex = Executor(buckets=((n_pad, e_pad),), device=device, mesh=mesh)
    ex.register("gin", cfg, init(torch.Generator().manual_seed(0), cfg), fused=True)
    graphs = [g[:4] for g in MoleculeStream(MOLHIV, seed=0).take(bsz)]
    p = ex.prepare_batched(graphs, bsz, n_pad, e_pad)
    want = ex.run(p)[0]
    if not (ex.captured and ex.lowered_count == 1):
        raise AssertionError(f"hang case: captured {ex.captured}, {ex.lowered_count} captures")
    step("captured")
    rounds, err, right = [], 0.0, True
    for r in range(HANG_ROUNDS):
        t0 = time.perf_counter()
        pending = [ex.run_async(p) for _ in range(HANG_REPLAYS)]
        outs = [q.result()[0] for q in pending]
        dist.barrier()
        rounds.append(time.perf_counter() - t0)
        err = max([err] + [float(np.abs(o - want).max()) for o in outs])
        right &= all(np.allclose(o, want, **SERVE_TOL) for o in outs)
        step(f"round {r} {rounds[-1]:.3f}s")
    mesh_replay_kernels(lambda: ex.run(p))
    dist.barrier()
    step("a profiled replay, then a barrier")
    del ex, pending, outs
    gc.collect()
    step("the executor dropped")
    dist.barrier()
    step("a barrier after the executor was dropped")
    return {"rounds_s": rounds, "max_abs_err": err, "right": right}


# ---------------------------------------------------------------------------
# phase 13: the LM train loop's mesh branch
# ---------------------------------------------------------------------------

# (tag, arch, config overrides, dtype, steps; steps 0: the first step's loss
# and grad_norm only).  ChatGLM3-6B at full width (d 4096, 32 -> 16 heads by
# kv_pad_to, d_ff 13696, vocab 65024) cut to 4 of 28 layers (2 in fp32),
# Qwen3-MoE-30B-A3B at full width (128 experts top-8) cut to 2 of 48, in
# fp32 so that routing does not flip; B 4 x S 1024, remat on
TRAIN_MESH_MODELS = (("dense fp32", "chatglm3-6b", dict(num_layers=2), "float32", 0),
                     ("dense bf16", "chatglm3-6b", dict(num_layers=4), "bfloat16", 3),
                     ("moe fp32", "qwen3-moe-30b-a3b", dict(num_layers=2), "float32", 0))
TRAIN_MESH_BATCH, TRAIN_MESH_SEQ = 4, 1024
# the 2 gloo ranks' (mesh, rules) and the 1-rank NCCL world's
TRAIN_MESH_GLOO = (((1, 2), "default"), ((1, 2), "fsdp"))
TRAIN_MESH_NCCL = (((1, 1), "default"),)
TRAIN_MESH_RTOL = {"float32": 1e-4, "bfloat16": 5e-3}  # each step's loss vs unsharded
# the flash kernel on a gloo rank's own block of the 1x2 bf16 step: ChatGLM3's
# 32 q heads and 16 kv heads (kv_pad_to) cut over "model" -> (B, Hq, Hkv, S, D)
TRAIN_MESH_BLOCK = (4, 16, 8, 1024, 128)
TRAIN_MESH_TIMEOUT_S = 600
# four cards (``--train-mesh-cards 4``, not part of the default run): the
# launcher's 2x2 NCCL mesh of ChatGLM3-6B at full width, 8 layers
TRAIN_MESH_CARDS = (("dense bf16", "chatglm3-6b", dict(num_layers=8), "bfloat16", 3),)
# and train() itself on that mesh: at TRAIN_MESH_CARDS' cell (its one
# checkpoint, at the end, ~21.6 GB: bf16 weights, fp32 moments), held to
# one card's eager steps above; and a reduced ChatGLM3-6B with a failure,
# its restore in place and compression, held to one card's train()
TRAIN_LOOP_CARDS = (
    dict(tag="loop full width", arch="chatglm3-6b", overrides=dict(num_layers=8),
         dtype="bfloat16", steps=3, batch=8, seq=TRAIN_MESH_SEQ, ckpt_every=1000,
         fail_at=None, compression=False, rules="default"),
    dict(tag="loop reduced", arch="chatglm3-6b", overrides=dict(head_dim=64), reduced=True,
         dtype="bfloat16", steps=8, batch=8, seq=64, ckpt_every=4, fail_at=6,
         compression=True, rules="fsdp"))


def train_mesh_cases(models, meshes=(((1, 1), "default"),), **extra) -> list:
    """The case dicts of ``models`` on each (mesh, rules) of ``meshes``: the
    fp32 first-step checks under the default rules only; ``extra`` (batch,
    reduced) goes into each."""
    return [dict(tag=tag, arch=arch, overrides=ov, dtype=dt, steps=steps, mesh=list(mesh),
                 rules=rules, **extra)
            for tag, arch, ov, dt, steps in models for mesh, rules in meshes
            if rules == "default" or dt == "bfloat16"]


def train_mesh_config(case: dict):
    from repro_torch.configs import get_config, get_reduced

    get = get_reduced if case.get("reduced") else get_config
    return get(case["arch"], dtype=case["dtype"], remat=True, **case["overrides"])


def train_mesh_run(case: dict, device, mesh=None, rules=None) -> dict:
    """One case of phase 13 on ``device``: the whole model without a mesh
    (``mesh`` None: the reference) or placed on ``mesh``.  Returns the
    first step's loss and grad_norm (``steps`` 0), or each step's loss,
    grad_norm, ms, tokens/s, peak GB, flash launches and collectives."""
    import torch
    from repro_torch import runtime as RT
    from repro_torch.data.pipeline import SyntheticTokens, TokenPipelineConfig
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train.loop import device_batch, loss_and_grads, make_train_step, mesh_scope

    cfg = train_mesh_config(case)
    torch.cuda.empty_cache() if device.type == "cuda" else None
    params = lm.init_params(torch.Generator(device).manual_seed(0), cfg)
    params = RT.place_tree(params, lm.param_axes(cfg), mesh, rules)
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the whole draws, once placed
    batch_size = case.get("batch", TRAIN_MESH_BATCH)
    data = iter(SyntheticTokens(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, batch=batch_size, seq_len=TRAIN_MESH_SEQ)))
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (
        lambda: None)
    out = {"tag": case["tag"], "steps": []}
    if case["steps"] == 0:
        with mesh_scope(mesh, rules):
            loss, _, grads = loss_and_grads(params, device_batch(next(data), device, mesh,
                                                                 rules), cfg)
            out.update(loss=float(loss), grad_norm=float(adamw.global_norm(grads)))
        return out
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=case["steps"])
    opt_state = adamw.init(params)
    step_fn = make_train_step(cfg, opt_cfg)
    tokens = batch_size * TRAIN_MESH_SEQ
    from repro_torch.roofline import CollectiveRecorder

    comm = CollectiveRecorder()
    with mesh_scope(mesh, rules):
        for i in range(case["steps"]):
            batch = device_batch(next(data), device, mesh, rules)
            sync()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            before = FA.launches
            with comm:
                t0 = time.perf_counter()
                params, opt_state, _, metrics = step_fn(params, opt_state, None, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                sync()
                dt = time.perf_counter() - t0
            out["steps"].append(dict(
                loss=metrics["loss"], grad_norm=metrics["grad_norm"], ms=dt * 1e3,
                tokens_per_s=tokens / dt, flash_launches=FA.launches - before,
                peak_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                         if device.type == "cuda" else 0.0),
                collectives=collectives_by_kind(comm)))
        if case.get("profile") and device.type == "cuda":
            # one more step on every rank (a rank that stepped once more than
            # another would hang the world), under the profiler
            batch = device_batch(next(data), device, mesh, rules)
            ran = []
            out["profile"] = step_profile(
                lambda: ran.append(step_fn(params, opt_state, None, batch))
                or ran[-1][3]["loss"].item())
            params, opt_state = ran[-1][0], ran[-1][1]
        if (case.get("capture") and device.type == "cuda"
                and (mesh is None or mesh.backend == "nccl")):
            out["captured"] = captured_steps(case, step_fn, params, opt_state,
                                             lambda: device_batch(next(data), device, mesh,
                                                                  rules), sync, device, mesh)
    return out


def captured_steps(case: dict, step_fn, params, opt_state, next_batch, sync, device,
                   mesh=None) -> dict:
    """The step as one CUDA graph (``train.loop.make_runner``, the runner
    ``train()`` and the launcher take on the card): the warm step's loss,
    the seconds of the warm step and the capture, then ``case["steps"]``
    replays (loss, grad_norm, ms each) and one replay under the profiler."""
    import torch
    from repro_torch.train import runner as TR
    from repro_torch.train.loop import make_runner

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run = make_runner(step_fn, params, opt_state, None, device, mesh)
    if not isinstance(run, TR.CapturedStep):
        raise AssertionError(f"{case['tag']}: the rule gave {type(run).__name__} on {mesh}")
    try:
        warm = float(run(next_batch())["loss"])
        sync()
        res = dict(warm_loss=warm, capture_s=time.perf_counter() - t0, steps=[])
        for _ in range(case["steps"]):
            batch = next_batch()
            sync()
            t0 = time.perf_counter()
            m = run(batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            sync()
            res["steps"].append(dict(loss=loss, grad_norm=gnorm,
                                     ms=(time.perf_counter() - t0) * 1e3))
        batch = next_batch()
        res["profile"] = step_profile(lambda: run(batch)["loss"].item())
    finally:
        run.close()
    return res


def train_loop_run(case: dict, device, mesh=None, rules=None) -> dict:
    """One ``train()`` of a loop case (``train_mesh_cards``) on ``device``,
    whole (``mesh`` None) or on ``mesh``: its history (step, loss,
    grad_norm, ms), failure steps and the graphs it captured and replayed.
    Its checkpoints go to a directory of the case's own under
    ``build/train_mesh/loop``, which the caller removes."""
    from repro_torch.data.pipeline import SyntheticTokens, TokenPipelineConfig
    from repro_torch.optim import adamw
    from repro_torch.train.loop import LoopConfig, train

    cfg = train_mesh_config(case)
    ckpt = ROOT / "build" / "train_mesh" / "loop" / (
        f"{case['tag']} {'mesh' if mesh is not None else 'one'}".replace(" ", "_"))
    data = SyntheticTokens(TokenPipelineConfig(vocab_size=cfg.vocab_size,
                                               batch=case["batch"], seq_len=case["seq"]))
    before = runner_counts()
    out = train(cfg, adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=case["steps"]),
                LoopConfig(steps=case["steps"], log_every=1, ckpt_every=case["ckpt_every"],
                           ckpt_dir=str(ckpt), grad_compression=case["compression"]),
                data, mesh=mesh, rules=rules, inject_failure_at=case["fail_at"],
                device=device)
    return dict(tag=case["tag"],
                history=[dict(step=r["step"], loss=r["loss"], grad_norm=r["grad_norm"],
                              ms=r["dt"] * 1e3) for r in out["history"]],
                failures=[e["step"] for e in out["events"] if e["event"] == "failure"],
                graphs=[a - b for a, b in zip(runner_counts(), before)])


def loop_note(run: dict) -> str:
    """A ``train_loop_run``'s figures for a report line."""
    h = run["history"]
    later = h[1:] or h
    return (f"steps {[r['step'] for r in h]}, failures {run['failures']}, "
            f"{run['graphs'][0]} capture / {run['graphs'][1]} replays; losses "
            + " / ".join(f"{r['loss']:.5f}" for r in h)
            + f"; {statistics.median(r['ms'] for r in later):.1f} ms a step past the first "
            "(" + ", ".join(f"{r['ms']:.0f}" for r in h) + ")")


def collectives_by_kind(comm) -> dict:
    """{kind: [count, bytes, wire bytes]} of a ``CollectiveRecorder``'s
    step: bytes the larger of each call's input and output buffers, wire
    bytes by the dry-run's ring model (``roofline.wire_bytes``)."""
    out = {kind: [c, b, 0.0] for kind, (c, b) in comm.counts.items()}
    for r in comm.records:
        kind = r["op"].replace("-", "_")
        if kind in out:
            out[kind][2] += r["wire_bytes"]
    return out


def step_profile(fn) -> dict:
    """One call of ``fn`` (a mesh train step, ending at a host read) in one
    ``torch.profiler`` session: its wall ms, the device kernels' count and
    the union of their intervals, NCCL's kernels' count and summed time,
    and the idle share (1 - union / wall).  One session only: on a mesh
    every rank must run the step as often as the others; a session that
    lost its device records gives None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    return dict(wall_ms=wall_ms, kernels=len(kernels), busy_ms=busy / 1e3,
                flash_kernels=sum("flash_fwd" in e.name for e in kernels),
                nccl_kernels=len(nccl),
                nccl_ms=sum(e.time_range.elapsed_us() for e in nccl) / 1e3,
                idle_share=max(0.0, 1.0 - busy / 1e3 / wall_ms))


def train_mesh_rank(out_dir: str, device, step) -> dict:
    """One rank of a phase-13 world: every case of ``cases.json`` on its
    debug mesh, the launch counters reset before and read after."""
    import torch
    from repro_torch import runtime as RT

    cases = json.loads(Path(out_dir, "cases.json").read_text())
    res = {"cases": []}
    reset_launches()
    for case in cases:
        mesh = RT.make_debug_mesh(*case["mesh"], device=device)
        rules = (RT.fsdp_rules if case["rules"] == "fsdp" else RT.batch_rules)(
            mesh, case.get("batch", TRAIN_MESH_BATCH))
        step(f"{case['tag']} on {mesh} {case['rules']}")
        run = train_loop_run if case.get("loop") else train_mesh_run
        res["cases"].append(run(case, device, mesh, rules))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    res["launches"] = read_launches()
    res["backend"] = str(torch.distributed.get_backend())
    if (device.type == "cuda" and res["backend"] == "gloo"
            and torch.distributed.get_rank() == 0):
        # after the counts (these launches are no path's), on one rank while
        # the other waits in the closing barrier, so the card is its own
        res["flash_block"] = flash_block_times(device)
    return res


def flash_block_times(device) -> dict:
    """The flash kernel at a rank's own (batch, head) block of the mesh
    train step (``TRAIN_MESH_BLOCK``, bf16, causal, the path's (B, S, H, D)
    views) beside the plain version, ``scaled_dot_product_attention`` on
    the same tensors and the card's bound; the kernel held to the plain
    version at ``FLASH_TOL``."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels import ops as kops

    b, hq, hkv, s, d = TRAIN_MESH_BLOCK
    gen = torch.Generator().manual_seed(29)
    q, k, v = attention_inputs(gen, b, hq, hkv, s, d, torch.bfloat16, device, "bshd")
    kern = lambda: kops.flash_attention(q, k, v, mode="kernel")
    plain = lambda: kops.flash_attention(q, k, v, mode="reference")
    lib = lambda: Fn.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    err = checked_err("flash_attention (a mesh rank's block)", kern().float(),
                      plain().float(), FLASH_TOL["bfloat16"])
    ms, timer = device_ms(kern)
    plain_ms, _ = device_ms(plain, 10)
    library_ms, _ = device_ms(lib)
    nbytes = 2.0 * (b * hq * s * 2 * d + b * hkv * s * 2 * d)
    bound_ms, bound_by = bound(nbytes, 0.0, bf16_ops=4.0 * d * b * hq * s * (s + 1) / 2)
    return dict(shape=list(TRAIN_MESH_BLOCK), max_abs_err=err, ms=ms, timer=timer,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def captured_note(cap: dict) -> str:
    """A captured run's figures (``captured_steps``) for a report line."""
    return (f"warm step loss {cap['warm_loss']:.5f}, capture {cap['capture_s']:.1f} s, "
            f"replays: losses " + " / ".join(f"{st['loss']:.5f}" for st in cap["steps"])
            + ", ms " + ", ".join(f"{st['ms']:.1f}" for st in cap["steps"]) + "; "
            + profile_note(cap.get("profile")))


def profile_note(prof) -> str:
    """A profiled step's figures (``step_profile``) for a report line."""
    if prof is None:
        return "profiled step: not measured (the session lost its device records)"
    return (f"profiled step {prof['wall_ms']:.1f} ms wall, {prof['kernels']} kernels busy "
            f"{prof['busy_ms']:.1f} ms (idle share {prof['idle_share']:.3f}), "
            f"{prof['flash_kernels']} flash_attention, NCCL "
            f"{prof['nccl_kernels']} kernels {prof['nccl_ms']:.1f} ms")


def steps_note(steps: list) -> str:
    """ms a step (median past the first, each step's), tokens/s, peak GB,
    flash launches and collectives of the last step."""
    later = steps[1:] or steps
    med = lambda k: statistics.median(st[k] for st in later)
    coll = steps[-1]["collectives"]
    return (f"{med('ms'):.1f} ms a step (" + ", ".join(f"{st['ms']:.0f}" for st in steps)
            + f"), {med('tokens_per_s'):.0f} tokens/s, peak "
            f"{max(st['peak_gb'] for st in steps):.2f} GB, {steps[-1]['flash_launches']} "
            f"flash launches a step, {sum(c[0] for c in coll.values())} collectives a step "
            "(buffer / ring-model wire MB) "
            + (", ".join(f"{k} {c[0]}x {c[1] / 1e6:.1f} / {c[2] / 1e6:.1f} MB"
                         for k, c in sorted(coll.items())) or "none"))


def train_mesh_line(tag: str, case: dict, rank_runs: list, ref: dict, card: str) -> float:
    """Print one ``[mesh train ...]`` line for ``case`` over its ranks and
    check it against the unsharded ``ref``; -> the largest relative loss
    gap (raises past ``TRAIN_MESH_RTOL``)."""
    rtol = TRAIN_MESH_RTOL[case["dtype"]]
    head = (f"[mesh train {case['tag']} {tag} {case['mesh'][0]}x{case['mesh'][1]} "
            f"{case['rules']}]")
    if case["steps"] == 0:
        gaps = []
        for r, run in enumerate(rank_runs):
            gl = abs(run["loss"] - ref["loss"]) / abs(ref["loss"])
            gn = abs(run["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
            gaps.append((gl, gn))
        gl, gn = max(g[0] for g in gaps), max(g[1] for g in gaps)
        print(f"{head} first step: loss {rank_runs[0]['loss']:.6f} (unsharded "
              f"{ref['loss']:.6f}, relative {gl:.2e}), grad_norm "
              f"{rank_runs[0]['grad_norm']:.6f} ({ref['grad_norm']:.6f}, {gn:.2e}); "
              f"limit {rtol:g}; {card}")
        if gl > rtol or (case["arch"] == "chatglm3-6b" and gn > rtol):
            raise AssertionError(f"{head}: loss / grad_norm {gl:.3g} / {gn:.3g} > {rtol}")
        return gl
    gap = 0.0
    for i, want in enumerate(ref["steps"]):
        for r, run in enumerate(rank_runs):
            got = run["steps"][i]
            gap = max(gap, abs(got["loss"] - want["loss"]) / abs(want["loss"]))
            if not got["flash_launches"] and card != "cpu":
                raise AssertionError(f"{head} rank {r} step {i}: no flash launch")
    per_rank = [f"rank {r}: " + steps_note(run["steps"]) for r, run in enumerate(rank_runs)]
    print(f"{head} {len(ref['steps'])} steps, losses "
          + " / ".join(f"{st['loss']:.5f}" for st in rank_runs[0]["steps"])
          + " (unsharded " + " / ".join(f"{st['loss']:.5f}" for st in ref["steps"])
          + f"; largest relative gap {gap:.2e}, limit {rtol:g}); unsharded: "
          + steps_note(ref["steps"]) + "; " + "; ".join(per_rank) + f"; {card}")
    if gap > rtol:
        raise AssertionError(f"{head}: a step's loss {gap:.3g} from the unsharded > {rtol}")
    return gap


def train_mesh_phase(device, card: str, models=TRAIN_MESH_MODELS, **extra) -> dict:
    """Phase 13: the unsharded reference of each model first (on this
    process, each freed before the next), then a 2-rank gloo world on the
    card (``TRAIN_MESH_GLOO``) and a 1-rank NCCL world (``TRAIN_MESH_NCCL``)
    of this script's child processes; -> each rank's launch counts.
    ``extra`` (``reduced=True``, a batch) goes into every case."""
    import torch

    t0 = time.perf_counter()
    dev = "cuda" if device.type == "cuda" else "cpu"
    refs = {}
    for case in train_mesh_cases(models, **extra):
        refs[case["tag"]] = train_mesh_run(case, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out_root = ROOT / "build" / "train_mesh"
    worlds = [("gloo", 2, TRAIN_MESH_GLOO)]
    if device.type == "cuda":
        worlds.append(("nccl", 1, TRAIN_MESH_NCCL))
    launches = {}
    for backend, world, meshes in worlds:
        cases = train_mesh_cases(models, meshes, **extra)
        ranks = mesh_world(backend, world, out_root / backend, dev, job="train",
                           cases=cases, timeout_s=TRAIN_MESH_TIMEOUT_S)
        for i, case in enumerate(cases):
            train_mesh_line(f"{backend} x{world}", case,
                            [r["cases"][i] for r in ranks], refs[case["tag"]],
                            card if device.type == "cuda" else "cpu")
        for r, res in enumerate(ranks):
            if device.type == "cuda" and res["launches"]["flash_attention"] == 0:
                raise AssertionError(f"mesh train {backend} rank {r}: no flash launch")
            launches[f"mesh train {backend} rank{r}"] = res["launches"]
            fb = res.get("flash_block")
            if fb is not None:
                b, hq, hkv, s, d = fb["shape"]
                print(f"[mesh train flash block {backend} rank {r}] B={b} Hq={hq} Hkv={hkv} "
                      f"S={s} D={d} bf16 causal (the rank's block of the 1x2 step): err "
                      f"{fb['max_abs_err']:.3g}; mma {fb['ms']:.4f} ms ({fb['timer']}), plain "
                      f"{fb['plain_ms']:.4f}, sdpa {fb['library_ms']:.4f}, bound "
                      f"{fb['bound_ms']:.5f} ({fb['bound_by']}); {card}")
    print(f"[mesh train] phase 13 took {time.perf_counter() - t0:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# phase 13b: decode on a mesh (models/layers.py: _decode_sharded, MLA's
# _mla_decode_sharded)
# ---------------------------------------------------------------------------

# (arch, layers, mesh, batch, prompt, cache): the published widths, depth
# cut, fp32.  MiniCPM3-4B (MLA: kv_lora 256, 40 heads, vocab 73448) with
# its latent caches whole on "model" and q's heads cut there (1x2) or cut
# on batch (2x1); a batch-1 Mixtral-8x7B (8 experts of d_ff 14336), every
# cache cut on its positions in two blocks of 4224: the decode step's slot
# 8328 is in rank 1's block and its 4096 window (8232..8328] masks rank 0's
# block [0, 4224) wholly
MESH_DECODE_CASES = (("minicpm3-4b", 2, (1, 2), 4, 256, 384),
                     ("minicpm3-4b", 2, (2, 1), 4, 256, 384),
                     ("mixtral-8x7b", 1, (2, 1), 1, 8328, 8448))
MESH_DECODE_LOGITS = 1e-5  # max |mesh - one rank| over max |one rank|, fp32
MESH_DECODE_CACHE = 1e-6


def mesh_decode_rank(device, step) -> dict:
    """One rank of phase 13b's gloo world: each case's decode step on the
    mesh (DTensors of the rank's blocks, on the card) against the one-rank
    step on the same prefilled cache, on this rank."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import runtime as RT
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime import partitioning as SH
    from repro_torch.train.loop import mesh_scope

    out = {}
    for arch, layers, shape, batch, prompt_len, cache_len in MESH_DECODE_CASES:
        cfg = get_config(arch, num_layers=layers, dtype="float32")
        params = lm.init_params(torch.Generator(device=device).manual_seed(0), cfg)
        rng = np.random.default_rng(3)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt_len))
                                  .astype(np.int32)).to(device)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, 1))
                               .astype(np.int32)).to(device)
        # the prefill on the flash kernel (fp32: its simt route); Mixtral's
        # 8328 positions in plain torch would hold 8.9 GB of logits a layer
        cache, _, t0 = lm.prefill(params, {"tokens": prompt}, cfg, cache_len)
        t = torch.full((), t0, dtype=torch.long, device=device)
        want_cache = adamw.tree_map(lambda x: x.clone(), cache)
        want, _ = lm.decode_step(params, want_cache, tok, t, cfg)
        mesh = RT.make_mesh(shape, ("data", "model"), device=device.type)
        rules = SH.batch_rules(mesh, batch)
        put = lambda x, axes: SH.place(x, SH.resolve_spec(axes, tuple(x.shape), mesh, rules),
                                       mesh)
        placed = SH.place_tree(params, lm.param_axes(cfg), mesh, rules)
        pc = SH._map_with_axes(lambda x, axes: put(x.clone(), axes), cache, lm.cache_axes(cfg))
        del cache
        mesh_sync(device)
        t1 = time.perf_counter()
        with mesh_scope(mesh, rules):
            got, got_cache = lm.decode_step(placed, pc, put(tok, ("batch", None)), t, cfg)
        mesh_sync(device)
        ms = (time.perf_counter() - t1) * 1e3
        got = got.full_tensor() if isinstance(got, DTensor) else got
        pairs = [(a.full_tensor() if isinstance(a, DTensor) else a, b)
                 for a, b in zip(adamw.leaves(got_cache), adamw.leaves(want_cache))]
        key = f"{arch} {shape[0]}x{shape[1]}"
        out[key] = dict(
            logits=float((got - want).abs().max() / want.abs().max()),
            cache=max(float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
                      for a, b in pairs),
            finite=bool(torch.isfinite(got).all()), ms=ms, on=str(got.device),
            placements=sorted({str(a.placements) for a in adamw.leaves(got_cache)
                               if isinstance(a, DTensor)}))
        del params, placed, pc, got_cache, want_cache, pairs
        torch.cuda.empty_cache() if device.type == "cuda" else None
        step(f"decode {key} done")
    return out


def mesh_decode_phase(device, card: str) -> None:
    """Phase 13b: ``MESH_DECODE_CASES`` on 2 gloo ranks sharing the card
    (real CUDA tensors, fp32), each case's logits within 1e-5 of their
    largest and every cache within 1e-6 of the one-rank step's, no NaN."""
    t0 = time.perf_counter()
    dev = "cuda" if device.type == "cuda" else "cpu"
    ranks = mesh_world("gloo", 2, ROOT / "build" / "mesh" / "decode", dev, job="decode")
    for arch, layers, shape, batch, prompt_len, cache_len in MESH_DECODE_CASES:
        key = f"{arch} {shape[0]}x{shape[1]}"
        rows = [r[key] for r in ranks]
        print(f"[mesh decode {key}] 2 gloo ranks on {rows[0]['on']}, fp32, {layers} layers, "
              f"B {batch}, prompt {prompt_len}, cache {cache_len}, caches "
              f"{rows[0]['placements']}: "
              f"logits err {max(r['logits'] for r in rows):.3e} (bound "
              f"{MESH_DECODE_LOGITS:g}), caches {max(r['cache'] for r in rows):.3e} (bound "
              f"{MESH_DECODE_CACHE:g}), finite {all(r['finite'] for r in rows)}; the step "
              f"{rows[0]['ms']:.1f} ms on rank 0 (DTensor's first step); {card}")
        for r in rows:
            if not (r["finite"] and r["logits"] <= MESH_DECODE_LOGITS
                    and r["cache"] <= MESH_DECODE_CACHE):
                raise AssertionError(f"mesh decode {key}: {r}")
            if dev == "cuda" and not r["on"].startswith("cuda"):
                raise AssertionError(f"mesh decode {key}: the step ran on {r['on']}")
    print(f"[mesh decode] phase 13b took {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 14: the dry-run and the roofline (fake tensors in child processes)
# ---------------------------------------------------------------------------

SHARE_MAX = 1.05  # no card reads more: a share past it is a miscount
# the decode cell's memory_s over phase 9's weight-read floor: the dry-run
# also counts the embedding table (its B rows read), the whole cache read
# and written back as the step's output, and the logits
DECODE_FLOOR_BAND = (1.0, 1.5)
MFU_RTOL = 1e-6  # phase 14's mfu / phase 11b's against the ratio of their counts
DRYRUN_CELL = ("chatglm3-6b", "train_4k")  # the fake 256-rank cell
# decode on each rank's block of the cache: cut on batch and kv heads
# (ChatGLM3-6B), MLA's latent caches cut on batch (MiniCPM3-4B), and, at
# batch 1, cut on their positions (Mixtral-8x7B's long_500k)
DRYRUN_DECODE_CELLS = (("chatglm3-6b", "decode_32k"), ("minicpm3-4b", "decode_32k"),
                       ("mixtral-8x7b", "long_500k"))
DRYRUN_TIMEOUT_S = 600
_ONE_RANK_CELLS = r"""
import json, sys
from repro_torch.launch import dryrun as D
from repro_torch.models.config import ShapeConfig

out = {}
for tag, arch, (name, seq, batch, kind), ov in json.loads(sys.argv[1]):
    out[tag] = D.run_cell(arch, ShapeConfig(name, seq, batch, kind), False, mesh=(1, 1),
                          overrides=ov)
print(json.dumps(out))
"""


def dryrun_children() -> dict:
    """Start phase 14's dry-runs as child processes (they run while the card
    works: a fake world cannot share a process with phases 12-13's process
    groups, and none of them touches the card): phase 11b's and phase 9's
    ChatGLM3-6B cells on one rank, ``DRYRUN_CELL`` on a fake world of 256
    and the GNN large-graph layer; -> {name: Popen}."""
    arch = TRAIN_ARCH
    cells = [("train", arch, ("train_b8_s1024", TRAIN_SEQ, TRAIN_BATCH, "train"),
              dict(num_layers=TRAIN_LAYERS, dtype="bfloat16", remat=True)),
             ("decode", arch, ("decode_b8_c1024", LM_PATHS[0][2]["cache_len"],
                               LM_PATHS[0][2]["max_batch"], "decode"),
              dict(LM_PATHS[0][1], dtype="bfloat16"))]
    env = dict(child_env(), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    start = lambda argv: subprocess.Popen(argv, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True, env=env,
                                          cwd=str(ROOT), preexec_fn=lambda: os.nice(10))
    return {"one rank": start([sys.executable, "-c", _ONE_RANK_CELLS, json.dumps(cells)]),
            "dryrun": start([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                             DRYRUN_CELL[0], "--shape", DRYRUN_CELL[1], "--mesh", "single",
                             "--force"]),
            **{f"dryrun decode {arch} {shape}": start(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--shape", shape, "--mesh", "single", "--force"])
               for arch, shape in DRYRUN_DECODE_CELLS},
            "gnn_dryrun": start([sys.executable, "-m", "repro_torch.launch.gnn_dryrun"])}


def child_output(children: dict, name: str) -> str:
    p = children[name]
    try:
        out, err = p.communicate(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        raise AssertionError(f"phase 14: {name} ran past {DRYRUN_TIMEOUT_S} s")
    if p.returncode != 0:
        raise AssertionError(f"phase 14: {name} exited {p.returncode}:\n{out[-3000:]}\n"
                             f"{err[-3000:]}")
    return out


def share_ok(tag: str, **shares) -> None:
    bad = {k: v for k, v in shares.items() if not 0.0 < v <= SHARE_MAX}
    if bad:
        raise AssertionError(f"{tag}: shares {bad} out of (0, {SHARE_MAX}]")


def roofline_phase(children: dict, train_summary: dict, card: str) -> None:
    """Phase 14: the records of ``dryrun_children``, beside what the card
    measured: phase 11b's step (its roofline terms, ``roofline_fraction`` =
    the lower bound over the measured median, ``mfu`` from
    ``roofline.model_flops``), phase 9's decode (its ``memory_s`` beside the
    weight-read floor and the graph decode), the 256-rank train cell and the
    GNN large-graph layer.  Launches no kernel."""
    from repro_torch import roofline as R
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import gnn_dryrun as G

    t0 = time.perf_counter()
    one = json.loads(child_output(children, "one rank").strip().splitlines()[-1])
    ts = train_summary["train_step"]
    later = ts["steps"][1:-1]  # phase 11b's median: past the first, not the profiled
    measured_s = ts["median_ms"] / 1e3
    tr = one["train"]
    rf = tr["roofline"]
    mf = tr["model_flops_per_device"]
    mfu = statistics.median(mf / (r["ms"] / 1e3) / R.PEAK_FLOPS for r in later)
    want_ratio = 6.0 * ts["nonvocab_params"] * ts["tokens"] / ts["model_flops"]
    got_ratio = mfu / ts["median_mfu"]
    fraction = rf["step_lower_bound_s"] / measured_s
    tag = f"[roofline train {TRAIN_ARCH}]"
    print(f"{tag} {TRAIN_LAYERS} layers, B {TRAIN_BATCH} x S {TRAIN_SEQ}, bf16, remat, one "
          f"rank, reference attention (the dry-run's): compute_s {rf['compute_s']:.6f}, "
          f"memory_s {rf['memory_s']:.6f} (memory_s_hlo {rf['memory_s_hlo']:.6f}), "
          f"collective_s {rf['collective_s']:.6f}, step_lower_bound_s "
          f"{rf['step_lower_bound_s']:.6f} ({rf['bound']}) beside phase 11b's measured "
          f"median {measured_s:.6f} s: roofline_fraction {fraction:.4f}; mfu "
          f"{mfu:.4f} (roofline.model_flops: 6 N T, N the {ts['nonvocab_params'] / 1e9:.4f} "
          f"B weights off the vocab) beside phase 11b's {ts['median_mfu']:.4f} (its 6 N T "
          f"adds the head, and attention 3x): ratio {got_ratio:.6f}, the counts' "
          f"{want_ratio:.6f}; useful_flops_ratio {rf['useful_flops_ratio']:.4f}; "
          f"temp {tr['memory']['temp_bytes'] / 1e9:.2f} GB; trace_s {tr['trace_s']}; {card}")
    if tr["model_flops_per_device"] != 6.0 * ts["nonvocab_params"] * ts["tokens"]:
        raise AssertionError(f"{tag}: the fake init's 6 N T {mf:.6e} is not the card's "
                             f"{6.0 * ts['nonvocab_params'] * ts['tokens']:.6e}")
    if abs(got_ratio - want_ratio) > MFU_RTOL * want_ratio:
        raise AssertionError(f"{tag}: mfu {mfu:.6f} disagrees with phase 11b's "
                             f"{ts['median_mfu']:.6f} (ratio {got_ratio} != {want_ratio})")
    share_ok(tag, roofline_fraction=fraction, mfu=mfu)

    dec, lmd = one["decode"], LM_DECODE[TRAIN_ARCH]
    rd, mem = dec["roofline"], dec["memory"]
    graph_ms = statistics.median(lmd["graph_decode_ms"])
    over = rd["memory_s"] * 1e3 / lmd["floor_ms"]
    tag = f"[roofline decode {TRAIN_ARCH}]"
    print(f"{tag} {lmd['layers']} layers, B {lmd['batch']}, cache {lmd['cache_len']}, bf16, "
          f"one rank: memory_s {rd['memory_s'] * 1e3:.4f} ms (arguments "
          f"{mem['argument_bytes'] / 1e9:.3f} GB + outputs {mem['output_bytes'] / 1e9:.3f} + "
          f"2 x temps {mem['temp_bytes'] / 1e9:.3f} at {R.HBM_BW / 1e12:.2f} TB/s) beside "
          f"phase 9's weight-read floor {lmd['floor_ms']:.4f} ms ({over:.3f}x; band "
          f"{DECODE_FLOOR_BAND[0]:g}-{DECODE_FLOOR_BAND[1]:g}x: the dry-run also reads the "
          f"embedding table and the whole cache, and writes the cache back) and the "
          f"measured graph decode {graph_ms:.4f} ms/token ({spread(lmd['graph_decode_ms'])}): "
          f"share {rd['memory_s'] * 1e3 / graph_ms:.4f}; compute_s {rd['compute_s']:.6f}; "
          f"trace_s {dec['trace_s']}; {card}")
    if not DECODE_FLOOR_BAND[0] <= over <= DECODE_FLOOR_BAND[1]:
        raise AssertionError(f"{tag}: memory_s / floor {over:.3f} out of {DECODE_FLOOR_BAND}")
    share_ok(tag, memory_share=rd["memory_s"] * 1e3 / graph_ms)

    said = child_output(children, "dryrun").strip().splitlines()
    rec = json.loads(Path(D.cell_path(DRYRUN_CELL[0], DRYRUN_CELL[1], False)).read_text())
    decodes = []
    for arch, shape in DRYRUN_DECODE_CELLS:
        dsaid = child_output(children, f"dryrun decode {arch} {shape}").strip().splitlines()
        decodes.append((json.loads(Path(D.cell_path(arch, shape, False)).read_text()),
                        dsaid[-2] if len(dsaid) > 1 else dsaid[-1]))
    gsaid = child_output(children, "gnn_dryrun").strip().splitlines()
    grec = json.loads(Path(G.record_path(dict(multi_pod=False, shape="n2^27_e2^31_f256")))
                      .read_text())
    for r, line in ((rec, said[-2] if len(said) > 1 else said[-1]), *decodes,
                    (grec, gsaid[-1])):
        rf, m, cs = r["roofline"], r["memory"], r["collective_summary"]
        hbm = r.get("hbm_estimate", {})
        print(f"[dryrun {r['arch']} {r['shape']} {r['mesh']}] a fake world of "
              f"{512 if r['multi_pod'] else 256} ranks, rank 0's step on fake tensors: "
              f"flops/dev {r['flops_per_device']:.4e}, bytes/dev {r['bytes_per_device']:.4e}; "
              f"arguments {m['argument_bytes'] / 1e9:.3f} GB, temps "
              f"{m['temp_bytes'] / 1e9:.3f} GB"
              + (f", HBM estimate {hbm['total'] / 1e9:.2f} GB (fits 80 GB: "
                 f"{hbm[D.CAPACITY_KEY]})" if hbm else "")
              + f"; terms (c/m/n) {rf['compute_s']:.6f} / {rf['memory_s']:.6f} / "
              f"{rf['collective_s']:.6f} s"
              + (f", bound {rf['bound']}, useful_flops_ratio "
                 f"{rf.get('useful_flops_ratio', 0):.4f}" if "bound" in rf else "")
              + "; collectives " + ", ".join(f"{op} {v['count']}x {v['wire_bytes'] / 1e9:.3f} GB"
                                             for op, v in sorted(cs.items()))
              + f"; trace_s {r['trace_s']} (the child said: {line.strip()[:120]})")
        if not (m["argument_bytes"] > 0 and cs and r["bytes_per_device"] > 0):
            raise AssertionError(f"[dryrun {r['arch']}]: an empty record")
    if not rec["flops_per_device"] > 0:
        raise AssertionError(f"[dryrun {rec['arch']}]: no FLOPs counted")
    for drec, _ in decodes:
        check_decode_cell(drec)
    print(f"[roofline] phase 14 took {time.perf_counter() - t0:.1f}s past phase 13 "
          "(its children ran beside the earlier phases)")


# ---------------------------------------------------------------------------
# phase 15: GNN training through the kernels (kernels/ops.py:KernelFunction)
# ---------------------------------------------------------------------------

# max|grad kernel - grad reference| over max|grad reference|, per leaf: the
# kernels' fp32 sums round apart from the plain versions' (and index_add_ on
# the card adds in no fixed order; reference mode against itself: printed).
# Each limit is about 3-20 times the worst spread read on an H100 (five
# runs of this phase): fp32 kernel against reference 2.0e-7-1.3e-5; int8 GIN
# 1.6e-7-2.8e-5 (the reference against itself the same: an int8 row whose
# fp32 input moved by an ulp rounds to the next level); PNA 3.0e-4-1.02e-3
# and the reference against itself up to 9.7e-4, since its std passes
# 0.5 / std back, and where a node's neighbours send nearly equal messages
# its variance is rounding noise
GNN_GRAD_TOL = {"fp32": 1e-4, "pna": 3e-3, "int8": 5e-4}
GNN_GRAD_BATCH = 16  # graphs, padded to (64, 192) each, as the train example's
GNN_GRAD_PATHS = tuple((m, "fp32", fused) for m in ("gcn", "gin", "gin_vn", "gat", "pna",
                                                    "dgn") for fused in (False, True)
                       if not (fused and m == "gat")) + (("gin", "int8", False),
                                                         ("gin", "int8", True))
GNN_TRAIN_STEPS = 50
GNN_TRAIN_SKIP = 5  # steps left out of the median step time
GNN_EXACT_STEPS = 10  # captured vs eager example, bit for bit (deterministic algorithms)
GNN_PROFILE_KEEP = 4  # profiler sessions of a replay of the example's step
GNN_EXAMPLES = (("torch_quickstart.py",), ("torch_serve_realtime_stream.py", "32"),
                ("torch_large_graph_dgn.py",))
# the wrappers of kernels/ops.py that take KernelFunction (the paths run all
# but quant_node_mlp's static entry)
GNN_GRAD_OPS = ("node_mlp", "segment_reduce", "edge_softmax", "quant_node_mlp",
                "quant_node_mlp_dynamic", "fused_mp")


def grad_leaves(tree) -> list:
    """The floating tensors of a GNN parameter tree in JAX's order (sorted
    keys); a quantized linear's are its weight scales and bias (its int8
    weights take no gradient)."""
    import torch
    from repro_torch.quant.qconfig import QuantizedLinear

    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in grad_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in grad_leaves(v)]
    if isinstance(tree, QuantizedLinear):
        return grad_leaves([tree.w_scale, tree.b])
    return [tree] if isinstance(tree, torch.Tensor) and tree.is_floating_point() else []


@contextlib.contextmanager
def grad_fn_census(names: dict):
    """Within the block, the ``grad_fn`` class name of each output of the
    six GNN wrappers of ``kernels/ops.py``, by wrapper, into ``names``."""
    from repro_torch.kernels import ops as kops

    real = {op: getattr(kops, op) for op in GNN_GRAD_OPS}

    def spy(op):
        def wrapper(*a, **k):
            out = real[op](*a, **k)
            names.setdefault(op, set()).add(type(out.grad_fn).__name__)
            return out
        return wrapper

    for op in GNN_GRAD_OPS:
        setattr(kops, op, spy(op))
    try:
        yield names
    finally:
        for op, fn in real.items():
            setattr(kops, op, fn)


def gnn_grad_batch(device):
    """The train example's first batch (16 MolHIV graphs, (1024, 3072)),
    its labels and DGN's eigenvector (each graph's, packed)."""
    import torch
    from repro_torch.core.graph import batch_graphs
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream, laplacian_eigvec

    raw = MoleculeStream(MOLHIV, seed=0).take(GNN_GRAD_BATCH)
    n_pad, e_pad = GNN_GRAD_BATCH * 64, GNN_GRAD_BATCH * 192
    g = batch_graphs([r[:4] for r in raw], n_pad, e_pad, device=device)
    y = torch.tensor([float(r[4]) for r in raw], device=device)
    eig = np.zeros((n_pad,), np.float32)
    eig[:sum(r[2].shape[0] for r in raw)] = np.concatenate(
        [laplacian_eigvec(r[0], r[1], r[2].shape[0]) for r in raw])
    return g, y, torch.from_numpy(eig).to(device)


def gnn_grads(params, g, y, eig, cfg, fused: bool):
    """(loss, every floating leaf's gradient) of the train example's BCE on
    ``g``; the leaves require grad only within the call."""
    import torch
    from repro_torch.gnn import apply

    flat = grad_leaves(params)
    for p in flat:
        p.requires_grad_(True)
    try:
        logits = apply(params, g, cfg, eigvec=eig if cfg.model == "dgn" else None,
                       num_graphs=GNN_GRAD_BATCH, fused=fused)[:GNN_GRAD_BATCH, 0]
        loss = torch.mean(torch.clamp(logits, min=0) - logits * y
                          + torch.log1p(torch.exp(-torch.abs(logits))))
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    finally:
        for p in flat:
            p.requires_grad_(False)
    return float(loss.detach()), grads


def leaf_errors(got, want) -> list:
    """max|a - b| / max|b| of each leaf (b the reference)."""
    return [float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
            for a, b in zip(got, want)]


def check_gnn_grads(device, card: str) -> dict:
    """Phase 15, step 1: ``GNN_GRAD_PATHS`` in mode ``kernel`` against mode
    ``reference``; returns the launches under grad."""
    import torch
    from repro_torch.configs.gengnn_models import get_gnn_config
    from repro_torch.gnn import init
    from repro_torch.quant.apply import precision_qconfig, quantize_params

    g, y, eig = gnn_grad_batch(device)
    launches, names = {}, {}
    for model, precision, fused in GNN_GRAD_PATHS:
        cfg = get_gnn_config(model, kernel_mode="kernel")
        params = init(torch.Generator().manual_seed(0), cfg, device)
        if precision == "int8":
            params, _ = quantize_params(params, None, precision_qconfig("int8"))
        tag = f"[gnn grad {model} {precision}{' fused' if fused else ''}]"
        reset_launches()
        with grad_fn_census(names):
            loss_k, got = gnn_grads(params, g, y, eig, cfg, fused)
        torch.cuda.synchronize()
        run = read_launches()
        for k, v in run.items():
            launches[k] = launches.get(k, 0) + v
        ref_cfg = dataclasses.replace(cfg, kernel_mode="reference")
        loss_r, want = gnn_grads(params, g, y, eig, ref_cfg, fused)
        again = max(leaf_errors(gnn_grads(params, g, y, eig, ref_cfg, fused)[1], want))
        tol = GNN_GRAD_TOL["int8" if precision == "int8" else
                           "pna" if model == "pna" else "fp32"]
        missing = []
        for i, (a, b) in enumerate(zip(got, want)):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{tag}: leaf {i} has a non-finite gradient")
            if b.abs().max() > 0 and not a.abs().max() > 0:
                missing.append(i)
        errs = leaf_errors(got, want)
        worst = max(errs)
        norm = max(float((a - b).norm() / b.norm().clamp(min=1e-30))
                   for a, b in zip(got, want))
        ran = {k: v for k, v in run.items() if v and "." not in k}
        print(f"{tag} paper width, {GNN_GRAD_BATCH} graphs ({g.num_nodes}, {g.num_edges}), "
              f"{len(got)} leaves: loss kernel {loss_k:.6f} / reference {loss_r:.6f}; worst "
              f"leaf max|dg| / max|g_ref| {worst:.3e} (leaf {errs.index(worst)}; tol "
              f"{tol:g}; reference against itself {again:.3e}), |dg| / |g_ref| {norm:.3e}; nonzero {sum(int(bool(w.abs().max() > 0)) for w in want)} of "
              f"{len(want)}; launches under grad {ran}; {card}")
        if missing:
            raise AssertionError(f"{tag}: leaves {missing} get no gradient in kernel mode")
        if worst > tol or abs(loss_k - loss_r) > tol * max(abs(loss_r), 1.0):
            raise AssertionError(f"{tag}: gradients differ from reference mode ({worst:.3e})")
        del params, got, want
    bad = {op: n for op, n in names.items() if n != {"KernelFunctionBackward"}}
    if bad or not set(GNN_GRAD_OPS) - {"quant_node_mlp"} <= set(names):
        raise AssertionError(f"[gnn grad] outputs under grad not from KernelFunction: {bad}; "
                             f"wrappers seen {sorted(names)}")
    need = ("node_mlp", "fused_mp", "fused_mp_int8", "segment_reduce", "edge_softmax",
            "quant_node_mlp")
    if not all(launches.get(k, 0) > 0 for k in need):
        raise AssertionError(f"[gnn grad] a kernel did not run under grad: {launches}")
    return launches


def example_module(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_gin_example(device, card: str) -> dict:
    """Phase 15, step 2: ``examples/torch_train_gin_molhiv.py``'s ``main``
    for ``GNN_TRAIN_STEPS`` steps on the card, in this process: its step as
    one CUDA graph (one capture, a replay each later step), then the same
    run through the eager runner for its times, then one replay of the
    example's step under the profiler (``node_mlp`` inside the graph)."""
    import shutil

    import torch
    from repro_torch.configs.gengnn_models import get_gnn_config
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream
    from repro_torch.gnn import init
    from repro_torch.kernels import node_mlp as NM
    from repro_torch.optim import adamw
    from repro_torch.train import runner as TR

    ex = example_module("torch_train_gin_molhiv")
    ckpt = ROOT / "build" / "train_gin"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = [str(GNN_TRAIN_STEPS), "--device", str(device), "--ckpt-dir", str(ckpt)]
    seconds, eager_s = [], []
    names = {}
    reset_launches()
    before = runner_counts()
    with grad_fn_census(names):
        out = ex.main(argv, on_step=lambda step, s: seconds.append(s))
    graphs = [a - b for a, b in zip(runner_counts(), before)]
    launches = read_launches()
    with eager_runner():
        eager = ex.main(argv, on_step=lambda step, s: eager_s.append(s))
    # the same kernels on the same inputs: under deterministic algorithms the
    # captured run gives the eager one's losses and weights bit for bit
    short = [str(GNN_EXACT_STEPS), *argv[1:]]
    torch.use_deterministic_algorithms(True)
    try:
        exact = ex.main(short)
        with eager_runner():
            exact_eager = ex.main(short)
    finally:
        torch.use_deterministic_algorithms(False)
    same = exact["losses"] == exact_eager["losses"] and all(
        torch.equal(a, b) for a, b in zip(adamw.leaves(exact["params"]),
                                          adamw.leaves(exact_eager["params"])))
    losses = out["losses"]
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    later, eager_later = seconds[GNN_TRAIN_SKIP:], eager_s[GNN_TRAIN_SKIP:]
    gap = max(abs(a - b) for a, b in zip(losses, eager["losses"]))
    # one replay of the example's step under the profiler
    cfg = get_gnn_config("gin")
    params = init(torch.Generator().manual_seed(0), cfg, device)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=GNN_TRAIN_STEPS,
                                weight_decay=0.01)
    runner = TR.runner(ex.train_step(opt_cfg, cfg),
                       {"params": params, "opt": adamw.init(params)}, device)
    stream, rng = MoleculeStream(MOLHIV, seed=0), np.random.default_rng(0)
    try:
        n0, v0 = NM.launches, dict(NM.launches_by_variant)
        runner(ex.make_batch(stream, rng, 0, device=device))
        per_step = (NM.launches - n0) // 2  # the warm step and the capture
        split = {k: (n - v0[k]) // 2 for k, n in NM.launches_by_variant.items()}
        batch = ex.make_batch(stream, rng, 1, device=device)
        events = device_events(lambda: runner(batch)[0].item(), keep=GNN_PROFILE_KEEP)
    finally:
        runner.close()
    in_replay = sum("node_mlp_" in e.name for e in events)
    replay_split = {k: sum(f"node_mlp_{k}" in e.name for e in events) for k in split}
    print(f"[train gin] examples/torch_train_gin_molhiv.py, GIN paper width (5 x 100), "
          f"{GNN_TRAIN_STEPS} steps of 16 graphs (1024, 3072), AdamW, the step as one CUDA "
          f"graph ({graphs[0]} capture, {graphs[1]} replays): bce mean of the first 10 "
          f"steps {first:.4f} -> last 10 {last:.4f} (step 0 {losses[0]:.4f}, last "
          f"{losses[-1]:.4f}, acc {out['accs'][-1]:.2f}); {statistics.median(later) * 1e3:.3f} "
          f"ms a step (median (min-max) of steps {GNN_TRAIN_SKIP}-{GNN_TRAIN_STEPS - 1}, CUDA "
          f"events around a replay and its input copies: {spread(later)}) against "
          f"{statistics.median(eager_later) * 1e3:.3f} through the eager runner "
          f"({spread(eager_later)}; largest loss gap {gap:.2e}, deterministic "
          f"algorithms off); under deterministic algorithms {GNN_EXACT_STEPS} captured "
          f"steps {'equal' if same else 'DIFFER FROM'} the eager runner's bit for bit "
          f"(losses and weights); node_mlp launches {launches['node_mlp']} (the warm step "
          f"and the capture: {split} a step), {in_replay} in a profiled replay "
          f"({replay_split}) of {len(events)} device records (the largest of "
          f"{GNN_PROFILE_KEEP} sessions); {card}")
    if not (all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"[train gin]: the loss did not fall: {losses}")
    if graphs != [1, GNN_TRAIN_STEPS - 1]:
        raise AssertionError(f"[train gin]: {graphs} captures / replays")
    if names.get("node_mlp") != {"KernelFunctionBackward", "NoneType"}:
        raise AssertionError(f"[train gin]: node_mlp outputs {names}: every forward under "
                             "grad through KernelFunction, the accuracy's without")
    if not same:
        raise AssertionError("[train gin]: the captured steps differ from the eager "
                             "runner's under deterministic algorithms")
    # the profiler can drop records of a session: at most the capture's
    if not 0 < in_replay <= per_step or launches["node_mlp"] != 2 * per_step:
        raise AssertionError(f"[train gin]: node_mlp {launches['node_mlp']} launches at the "
                             f"warm step and capture, {in_replay} in a replay")
    return launches


def run_examples(card: str) -> None:
    """Phase 15, step 3: the other three examples as child processes on the
    card, all three at once (each is mostly its process's start: CUDA,
    the kernel libraries, the warm-up)."""
    import re

    t0 = time.perf_counter()
    procs = [(argv, subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / argv[0]), *argv[1:]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=child_env(),
        cwd=str(ROOT))) for argv in GNN_EXAMPLES]
    try:
        for argv, p in procs:
            out, err = p.communicate(timeout=COLD_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"examples/{argv[0]} exited {p.returncode}:\n"
                                     f"{out[-4000:]}\n{err[-4000:]}")
            print(f"[example {' '.join(argv)}] a new process on the card, "
                  f"{time.perf_counter() - t0:.1f}s from the three's start: "
                  + " | ".join(out.strip().splitlines()) + f"; {card}")
            if re.search(r"\bnan\b", out, re.I):
                raise AssertionError(f"examples/{argv[0]} printed a NaN:\n{out}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def gnn_train_phase(device, card: str) -> dict:
    """Phase 15: gradients through the GNN kernels, the training example and
    the other examples; returns its paths' launch counts."""
    t0 = time.perf_counter()
    paths = {"gnn grads": check_gnn_grads(device, card),
             "train gin": train_gin_example(device, card)}
    run_examples(card)
    print(f"[gnn train] phase 15 took {time.perf_counter() - t0:.1f}s")
    return paths


def check_decode_cell(rec: dict) -> None:
    """A decode cell on 16x16 (``DRYRUN_DECODE_CELLS``): a record with no
    error and no all-gather of the cache (no gathered shape holds the
    cache's positions; ``roofline.CollectiveRecorder`` keeps each result's
    shape)."""
    from repro_torch.models.config import SHAPES

    tag = f"[dryrun {rec['arch']} {rec['shape']} {rec.get('mesh', '?')}]"
    if "error" in rec:
        raise AssertionError(f"{tag}: {rec['error']}")
    s = SHAPES[rec["shape"]].seq_len
    gathers = [c["shape"] for c in rec["collectives"] if c["op"] == "all-gather"]
    cache = [shape for shape in gathers if s in shape]
    print(f"{tag} decode on each rank's block of the cache: {len(gathers)} all-gathers "
          f"({', '.join(str(g) for g in gathers) or 'none'}), {len(cache)} of them the "
          f"cache ({s} positions); flops/dev {rec['flops_per_device']:.4e}")
    if cache or not rec["flops_per_device"] > 0:
        raise AssertionError(f"{tag}: the cache was all-gathered {len(cache)} times")


def run(device) -> list:
    """Phases 2-7b, 6, 6c, 6b, 10, 9m, 9-9j, 11-11c, 12, 13, 14, 15 and 8 on
    ``device``; returns the kernels' JSON rows.  Phase 14's dry-runs start
    first, as child processes on the host's other cores, and are stopped
    whatever happens."""
    children = dryrun_children()
    try:
        return run_phases(device, children)
    finally:
        for p in children.values():
            if p.poll() is None:
                p.kill()
            p.communicate()


def run_phases(device, children: dict) -> list:
    check_node_mlp(device)
    check_fused_mp(device)
    check_segment_reduce(device)
    check_edge_softmax(device)
    check_quant_node_mlp(device)
    check_fused_mp_int8(device)
    check_flash_attention(device)
    paths = {"gin": serve_model("gin", device, packed_too=True)}
    serve_feature_dtypes(device)
    paths.update({"gcn": serve_model("gcn", device, packed_too=False),
             "gat": serve_model("gat", device, packed_too=True)})
    for model in ("pna", "dgn", "gin_vn"):
        paths[model] = serve_model(model, device, packed_too=False)
    for model in ("gin", "gcn", "gat", "pna", "dgn", "gin_vn"):
        paths[f"{model} int8"] = serve_model(model, device, packed_too=model == "gin",
                                             precision="int8")
    for precision in ("int8-static", "fixed"):
        paths[f"gin {precision}"] = serve_model("gin", device, packed_too=False,
                                                precision=precision, n_stream=8)
    graphs = graph_phase(device)
    layout_launches, layout_replays = layout_phase(device)
    paths.update(layout_launches)
    paths.update(stream_phase(device, device_line()))
    coldstart_phase(device_line())
    check_moe(device)
    lm_replays = {}
    for arch, overrides, serve_kw, lengths in LM_PATHS:
        paths[arch], replays = serve_lm(arch, overrides, serve_kw, lengths, device)
        lm_replays.update({f"{arch} {program}": {"flash_attention": n}
                           for program, n in replays.items()})
    flash_training = check_flash_bwd(device)
    paths[f"train {TRAIN_ARCH}"], train_summary = train_chatglm3(device)
    flash_training.update(train_summary)
    paths["train loop"] = train_loop_phase(device)
    paths.update(mesh_phase(device, device_line()))
    paths.update(train_mesh_phase(device, device_line()))
    mesh_decode_phase(device, device_line())
    roofline_phase(children, train_summary, device_line())
    paths.update(gnn_train_phase(device, device_line()))
    packed, lay = packed_plan(device)
    rows = [time_node_mlp(device, packed, paths["gin"]["node_mlp"],
                          design_split(paths["gin"], "node_mlp")),
            time_fused_mp(device, packed, lay, paths["gin"]["fused_mp"]),
            time_segment_reduce(device, packed, lay, paths["gat"]["segment_reduce"]),
            time_edge_softmax(device, packed, lay, paths["gat"]["edge_softmax"]),
            time_quant_node_mlp(device, lay, paths["gin int8"]["quant_node_mlp"],
                                design_split(paths["gin int8"], "quant_node_mlp")),
            time_fused_mp_int8(device, packed, lay,
                               paths["gin int8"]["fused_mp_int8"])]
    rows += time_flash_attention(device, paths["chatglm3-6b"]["flash_attention"],
                                 design_split(paths["chatglm3-6b"], "flash_attention"),
                                 paths["minicpm3-4b"]["flash_attention"],
                                 design_split(paths["minicpm3-4b"], "flash_attention"))
    next(r for r in rows if r["name"] == "flash_attention")["training"] = flash_training
    time_window_edges(device, device_line())
    for row in rows:
        counter = row.get("counter", row["name"])
        row["launches_by_path"] = {path: counts[counter]
                                   for path, counts in paths.items()}
        row["launches_per_replay"] = {
            " ".join(k for k in (model, precision, "packed" if packed else "") if k):
                replay.get(counter, 0)
            for (model, precision, packed), replay in graphs.items()}
        row["launches_per_replay"].update(
            {path: replay.get(counter, 0) for path, replay in layout_replays.items()})
        row["launches_per_replay"].update(
            {program: replay.get(counter, 0) for program, replay in lm_replays.items()})
    return rows


def train_mesh_cards(cards: int) -> int:
    """``--train-mesh-cards N`` (development, not the default run): phase
    13's rank code on a (2, N / 2) NCCL mesh of N cards, a card a rank, for
    ``TRAIN_MESH_CARDS`` under both presets at B 8 x S 1024 (eager steps,
    then the runner's captured steps), ``train()`` for ``TRAIN_LOOP_CARDS``,
    then the launcher (reduced ChatGLM3-6B, ``--debug-mesh 2xM --rules
    fsdp``, 3 steps) as a child, its NCCL ranks started by itself."""
    import shutil

    import torch

    card = device_line()
    build_kernels()
    cases = train_mesh_cases(TRAIN_MESH_CARDS, (((2, cards // 2), "default"),
                                                ((2, cards // 2), "fsdp")), batch=8,
                             profile=True, capture=True)
    # one card at the same global batch first, freed before the ranks start
    ref = train_mesh_run(dict(cases[0], profile=True), torch.device("cuda", 0))
    torch.cuda.empty_cache()
    one_ms = statistics.median(st["ms"] for st in (ref["steps"][1:] or ref["steps"]))
    print(f"[mesh train cards {ref['tag']} one card] losses "
          + " / ".join(f"{st['loss']:.5f}" for st in ref["steps"]) + "; "
          + steps_note(ref["steps"]) + "; " + profile_note(ref.get("profile")) + f"; {card}")
    one_cap = ref.get("captured")
    if one_cap:
        print(f"[mesh train cards {ref['tag']} one card captured] " + captured_note(one_cap)
              + f"; {card}")
    loops = [dict(c, loop=True, mesh=[2, cards // 2]) for c in TRAIN_LOOP_CARDS]
    loop_dir = ROOT / "build" / "train_mesh" / "loop"
    shutil.rmtree(loop_dir, ignore_errors=True)
    print(f"[mesh train cards] {shutil.disk_usage(ROOT).free / 1e9:.0f} GB free on the "
          f"checkout's disk")
    one_loop = train_loop_run(loops[1], torch.device("cuda", 0))
    torch.cuda.empty_cache()
    print(f"[mesh train cards {one_loop['tag']} one card] train(): " + loop_note(one_loop)
          + f"; {card}")
    ranks = mesh_world("nccl", cards, ROOT / "build" / "train_mesh" / "cards", "cuda",
                       job="train", cases=cases + loops, timeout_s=TRAIN_MESH_TIMEOUT_S)
    shutil.rmtree(loop_dir, ignore_errors=True)
    gaps = []
    for j, case in enumerate(loops):
        want = (one_loop["history"] if case.get("reduced") else
                [dict(step=k + 1, loss=st["loss"]) for k, st in enumerate(ref["steps"])])
        head = f"[mesh train cards {case['tag']} 2x{cards // 2} {case['rules']}]"
        for r, res in enumerate(ranks):
            run = res["cases"][len(cases) + j]
            h = run["history"]
            gap = (max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(h, want))
                   if [a["step"] for a in h] == [b["step"] for b in want] else math.inf)
            gaps.append((head, gap))
            against = "one card's train()" if case.get("reduced") else "one card's eager steps"
            print(f"{head} rank {r} train(): " + loop_note(run) + f"; against {against} "
                  f"largest relative loss gap {gap:.2e}; {card}")
            if run["graphs"] != [1, len(h) - 1]:
                raise AssertionError(f"{head} rank {r}: {run['graphs']} captures / replays")
    for i, case in enumerate(cases):
        head = f"[mesh train cards {case['tag']} 2x{cards // 2} {case['rules']}]"
        for r, res in enumerate(ranks):
            run = res["cases"][i]
            gap = max(abs(st["loss"] - want["loss"]) / abs(want["loss"])
                      for st, want in zip(run["steps"], ref["steps"]))
            gaps.append((head, gap))
            print(f"{head} rank {r} losses "
                  + " / ".join(f"{st['loss']:.5f}" for st in run["steps"])
                  + f" (one card's largest relative gap {gap:.2e}, limit "
                  f"{TRAIN_MESH_RTOL[case['dtype']]:g}); " + steps_note(run["steps"]) + "; "
                  + profile_note(run.get("profile")) + f"; {card}")
        ms = statistics.median(st["ms"] for st in (ranks[0]["cases"][i]["steps"][1:]
                                                   or ranks[0]["cases"][i]["steps"]))
        print(f"{head} rank 0 {ms:.1f} ms a step against one card's {one_ms:.1f} ms at the "
              f"same global batch (B {case['batch']} x S {TRAIN_MESH_SEQ}): "
              f"{one_ms / ms:.3f}x one card's speed; {card}")
        if one_cap and ranks[0]["cases"][i].get("captured"):
            for r, res in enumerate(ranks):
                cap = res["cases"][i]["captured"]
                gap = max(abs(st["loss"] - want["loss"]) / abs(want["loss"])
                          for st, want in zip(cap["steps"], one_cap["steps"]))
                gaps.append((head + " captured", gap))
                print(f"{head} captured rank {r} " + captured_note(cap)
                      + f"; one card captured's largest relative loss gap {gap:.2e}; {card}")
            cms = statistics.median(st["ms"] for st in ranks[0]["cases"][i]["captured"]["steps"])
            one_cms = statistics.median(st["ms"] for st in one_cap["steps"])
            print(f"{head} captured: rank 0 {cms:.1f} ms a step against one card's "
                  f"{one_ms:.1f} eager / {one_cms:.1f} captured: {one_ms / cms:.3f}x / "
                  f"{one_cms / cms:.3f}x one card's speed; {card}")
    bad = [(h, g) for h, g in gaps if g > TRAIN_MESH_RTOL["bfloat16"]]
    if bad:
        raise AssertionError(f"four-card losses past one card's: {bad}")
    out = run_child([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                     "chatglm3-6b", "--reduced", "--steps", "3", "--batch", "8", "--seq",
                     "64", "--debug-mesh", f"2x{cards // 2}", "--rules", "fsdp",
                     "--ckpt-dir", str(ROOT / "build" / "train_mesh" / "launcher")],
                    "the train launcher on the cards")
    print(f"[mesh train cards launcher] reduced chatglm3-6b, --debug-mesh 2x{cards // 2} "
          "--rules fsdp: " + " | ".join(out.splitlines()))
    return 0


def hang_worlds(cards: int, out_root: Path, card: str) -> None:
    """The hang case (``hang_case_rank``) in a world of its own, killed past
    HANG_TIMEOUT_S; a world that fails prints how far each rank came."""
    hang = mesh_world("nccl", cards, out_root / "hang", "cuda", job="hang",
                      timeout_s=HANG_TIMEOUT_S)
    worst = max(h["max_abs_err"] for h in hang)
    print(f"[mesh hang case] ran: {HANG_ROUNDS} rounds of {HANG_REPLAYS} replays, their "
          f"harvests (timing all-reduce MAX each) and a barrier, no synchronize; rank 0 "
          f"rounds " + " / ".join(f"{x:.3f}" for x in hang[0]["rounds_s"])
          + f" s; replays against the first max err {worst:.2e}; {card}")
    if not all(h["right"] for h in hang):
        raise AssertionError(f"hang case: a replay's output moved by {worst}")


def gnn_mesh_cards(cards: int) -> int:
    """``--gnn-mesh-cards N`` (development, not the default run): phase
    12's rank code on an N-rank NCCL world, a card a rank: the substrate,
    the six models sharded and captured against the unsharded engine (node
    outputs bit for bit under deterministic algorithms, directly and
    served), GIN fp32 / int8 packed and GIN's stream with arrivals through
    the scheduler, the PubMed-sized GIN sharded captured, sharded eager and
    whole; then the hang case (``hang_worlds``); then the launcher with
    ``--gnn-mesh N``."""
    import torch

    if torch.cuda.device_count() < cards:
        raise SystemExit(f"--gnn-mesh-cards {cards}: {torch.cuda.device_count()} cards")
    card = device_line()
    t0 = time.perf_counter()
    build_kernels()
    out_root = ROOT / "build" / "mesh" / "cards"
    ranks = mesh_world("nccl", cards, out_root / "gnn", "cuda")
    for r, res in enumerate(ranks):
        sub = res["substrate"]
        print(f"[mesh substrate nccl x{cards} rank {r}] jax data: "
              f"{mp_line('N 32, E 64, F 6', sub['jax_data'])}; pubmed: "
              f"{mp_line('N 19717, E 88648, F 100', sub['pubmed'])}; "
              f"compressed_psum rel {sub['compressed_psum_rel']:.2e}; {card}")
    serve_lines(ranks, "nccl", card)
    hang_worlds(cards, out_root, card)
    out = run_child([sys.executable, "-m", "repro_torch.launch.serve", "--gnn", "gin",
                     "--batched", "--gnn-mesh", str(cards), "--n-graphs", "12", "--batch",
                     "4"], f"launcher --gnn-mesh {cards}")
    line = next((ln for ln in out.splitlines() if f"mesh={cards}" in ln), "")
    if "backend=nccl captured=True" not in line:
        raise AssertionError(f"launcher --gnn-mesh {cards} did not capture on NCCL:\n{out}")
    print(f"[mesh cards launcher] {line.strip()}")
    print(f"[mesh cards] took {time.perf_counter() - t0:.1f}s")
    return 0


def main() -> int:
    if "--mesh-rank" in sys.argv:
        return mesh_rank_main(sys.argv[1:])
    import torch

    if "--train-mesh-cards" in sys.argv:
        return train_mesh_cards(int(sys.argv[sys.argv.index("--train-mesh-cards") + 1]))
    if "--gnn-mesh-cards" in sys.argv:
        return gnn_mesh_cards(int(sys.argv[sys.argv.index("--gnn-mesh-cards") + 1]))

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    build_kernels()
    card = device_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    rows = run(torch.device("cuda"))
    print(f"[total] {time.perf_counter() - t0:.1f}s, the kernels' build included")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

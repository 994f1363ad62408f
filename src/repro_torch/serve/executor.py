"""The serving executor (port of ``repro.serve.executor``).

    prepare  ->  warm  ->  run

* **prepare** — ``prepare_stream`` / ``prepare_batched`` /
  ``prepare_packed`` pad raw input into a ``PreparedBatch`` on the
  executor's device: padded graph, DGN's eigenvector input when asked
  for (host eigensolve, memoised), optional layout plan (packed batches
  carry their host-built plan), bucket key and warm signature.  With
  ``host=True`` the batch stays on the CPU; :func:`staged` pins it and,
  when asked, copies it to the card without blocking
  (``core.batching.pack_prepared`` pins, ``serve.pipeline.PipelinedStream``
  pins and copies).
* **warm** — every (tenant, program, signature) is made servable once,
  untimed, before it may be timed.  On the card that is three steps: the
  forward runs eagerly on a side stream (it builds the CUDA kernels at
  first use, makes their shared-memory opt-ins and sets up the libraries),
  then the forward is captured into a ``torch.cuda.CUDAGraph`` over static
  copies of the batch's tensors (the ``Graph``, eigenvector and
  ``GraphLayout`` leaves; the tenant's params are static already), then
  the graph is replayed once.  The static buffers are allocated on the
  executor's device whatever device the warming batch lies on, and the
  capture runs in ``thread_local`` error mode, so a prepare worker's
  pinning and copies on another thread (``serve/pipeline.py``) do not
  invalidate it.  The capture is accounted as
  ``compile_seconds`` (JAX's trace + lower + compile), the eager run and
  the first replay as ``warm_seconds``.  On the CPU, which a caller must
  ask for, nothing is captured: the warm is one eager forward and
  compile costs 0.  A capture that fails raises; there is no way back to
  the eager path on the card.
* **run** — :meth:`Executor.run_async` opens the timed region, copies the
  batch's tensors into the signature's static buffers (from pinned host
  memory too, without blocking), replays the graph, clones its output (a
  later replay overwrites the static one) and records an event;
  :class:`PendingRun` harvests it: the event's synchronise closes the
  timed region, then the output is copied to the host under the
  ``unpack_d2h`` accounting.  ``run`` is
  ``run_async(...).result()``.

Programs are cached by ``(program_key, bucket_key, num_graphs)`` with
``program_key = (cfg, precision, share_layout, fused)``, in JAX's order,
so tenants of one architecture share the record.  A captured graph holds
the addresses of the params it was captured with, so, unlike JAX's
executables, graphs are keyed by tenant: the warm signature is ``(tenant
name, params signature) + batch signature``, and each tenant captures its
own.  ``register(precision=...)``
quantizes once (``quant.apply.quantize_model``, calibrating first for
int8-static) on the parameters as the caller gave them, then moves the
quantized tree to the executor's device.

**Dispatch census.**  ``kernels_dispatch_total`` counts one forward per
JAX warm key, ``(program record, params signature + batch signature)``:
JAX traces once per such key, and two same-architecture tenants share its
executable.  The executor mutes the census (``kernels.ops.census_muted``)
for every other forward: on the card it counts the capture, not the eager
warm forward; on the CPU the warm forward, not the runs; and nothing for
a second tenant's warm of a key already counted.

``register(share_layout=False)`` admits a tenant on the per-call-sort
path (``gnn.models.apply(share_layout=False)``): its batches carry no plan
(``prepare_packed(model=...)`` and the scheduler's packer build none for
it) and every aggregation of its forward sorts its own edges, bit for bit
the shared forward.  JAX keeps that path for the layout-parity tests and
the sort-count A/B, and so does the port.

**Telemetry.**  ``tracer=`` / ``metrics=`` sinks (``repro_torch.obs``;
attachable later by :meth:`Executor.attach_telemetry`) receive program
builds, warms with their untimed cost, timed device seconds and the D2H
copy, as in JAX.  Both default off, and then no extra clock is read.

**Kernel-library cache.**  With ``aot_cache=`` (a ``serve.aot.AOTCache``)
the CUDA kernels' libraries are looked up on disk before ``nvcc`` runs,
under the environment fingerprint (``_fingerprint``: torch, CUDA, the
``nvcc`` release, the driver, the GPU, the ``nvcc`` flags), and written
back on a miss or a stale entry (``kernels/_build.py``).  That is the
port's counterpart of JAX's persisted executables: a CUDA graph cannot be
serialized, so ``lowered_count`` (captures) is the same in a restarted
process, and what a warm cache saves is the compiler.  Each lookup, made
at the first load of a library (inside a warm's eager forward), counts in
``aot_stats()`` and, when the sinks are on, in
``serve_aot_cache_total{result}`` and an ``aot_load`` trace event.  The
libraries are per process: the cache set by the last executor built with
one serves every later first load.

The executor runs on ``device="cuda"`` unless the caller asks for the CPU,
and raises if CUDA is missing.

**Mesh.**  With ``mesh=`` (a ``runtime.Mesh`` over the ranks of a process
group; every rank builds its own executor and serves the same batches)
and ``rules=`` (default ``runtime.gnn_rules(mesh)``), every forward runs
under :meth:`Executor._mesh_scope`, and :meth:`Executor._constrain_graph`
gives the rank its part of the batch (``core.message_passing.
shard_inputs``: its block of the padded node rows, its destinations'
in-edges from the plan, its rows of the eigenvector and the plan).  A
tenant that shares layouts gets the plan built once there when the batch
has none.  A bucket whose padded node rows do not divide the axis runs
whole on every rank (JAX's replicated fallback).  Every rank returns the
whole batch's output.  A rank's window of the plan has the plan's length
and starts at a device offset (``core.message_passing.owned_edges``), so
the sharded forward reads nothing back to the host.  On the card an NCCL
mesh captures its forwards as one rank does (:func:`captures`): each rank
runs the eager warm forward, which makes the communicator, before its
capture, and every rank captures the same signatures in the same order.
A CUDA graph that captured NCCL collectives must be gone before its
communicator is (``destroy_process_group`` hung while one lived): an
executor is freed, graphs and all, with its last reference (no reference
cycle holds it).  A gloo mesh of several ranks runs every forward eagerly
(a gloo collective cannot be captured into a CUDA graph); a failed capture
raises.
:attr:`Executor.captured` says which.  Each timed run's seconds are the
slowest rank's (an all-reduce of the measured time), so every rank's
stream scheduler sees one timeline and takes the same flushes, sheds and
rungs, and so issues the same collectives.  Only this path
takes a mesh on the serving side (JAX serves no LM on a mesh either);
LM training takes one in ``train.loop.train``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core import batching as B
from repro_torch.core import graph as G
from repro_torch.core import layout as LY
from repro_torch.core import message_passing as MP
from repro_torch.data.pipeline import laplacian_eigvec
from repro_torch.device import resolve_device
from repro_torch.gnn import models as M
from repro_torch.kernels import _build, ops
from repro_torch.obs.metrics import MetricsRegistry, ServingInstruments
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.runtime import compat as RC
from repro_torch.runtime import partitioning as PT
from repro_torch.serve.aot import AOTCache, environment_fingerprint
from repro_torch.serve.clock import Clock, RealClock

DEFAULT_BUCKETS: Sequence[tuple] = ((32, 96), (64, 192), (128, 384), (256, 768))


def _tensor_leaves(obj):
    """Every tensor in a nest of dataclasses / dicts / lists / tuples."""
    if obj is None:
        return
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for fld in dataclasses.fields(obj):
            yield from _tensor_leaves(getattr(obj, fld.name))
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensor_leaves(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensor_leaves(v)


def _map_tensors(fn: Callable, obj):
    """The nest with ``fn`` applied to every tensor; dataclasses (``Graph``,
    ``GraphLayout``, ``QuantizedLinear``) are rebuilt around the results."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, v) for v in obj)
    return obj


def trace_signature(graph: G.Graph, eigvec=None, layout=None) -> tuple:
    """Warm signature of one prepared input: whether it carries an
    eigenvector and a plan, plus (shape, dtype) of every tensor."""
    leaves = _tensor_leaves((graph, eigvec, layout))
    return (("eig", eigvec is not None), ("lay", layout is not None)) + tuple(
        (tuple(v.shape), str(v.dtype)) for v in leaves
    )


def params_signature(params) -> tuple:
    """Structural signature of a parameter tree (leaf shapes / dtypes,
    ``QuantizedLinear`` fields included)."""
    return tuple((tuple(v.shape), str(v.dtype)) for v in _tensor_leaves(params))


def _params_to(params, device: torch.device):
    """The tree with every tensor on ``device`` (dtypes kept: int8 weights
    stay int8)."""
    return _map_tensors(lambda t: t.to(device), params)


@dataclasses.dataclass(frozen=True)
class PreparedBatch:
    """One batch staged for the executor: padded (possibly packed) graph,
    optional eigenvector and layout plan, and its routing facts."""

    graph: G.Graph
    eigvec: Optional[torch.Tensor]
    layout: Optional[LY.GraphLayout]
    bucket_key: tuple
    num_graphs: int
    signature: tuple

    @property
    def inputs(self) -> tuple:
        """The forward's batch arguments: ``(graph, eigvec, layout)``."""
        return self.graph, self.eigvec, self.layout


def prepared(graph: G.Graph, eigvec, layout, bucket_key: tuple,
             num_graphs: int) -> PreparedBatch:
    return PreparedBatch(graph=graph, eigvec=eigvec, layout=layout,
                         bucket_key=bucket_key, num_graphs=num_graphs,
                         signature=trace_signature(graph, eigvec, layout))


def staged(p: PreparedBatch, device, copy: bool = True) -> PreparedBatch:
    """A host-built batch made ready for a run on ``device``.  On a card its
    CPU tensors are pinned and, with ``copy``, sent to the card by
    ``non_blocking`` copies on the current stream (the caching host
    allocator keeps each pinned block until its copy is done); without
    ``copy`` the pinned tensors go to :meth:`Executor.run_async` as they
    are, which copies them into the graph's static buffers.  On the CPU
    ``p`` itself.  The signature does not change: it keys on shapes and
    dtypes."""
    device = torch.device(device)
    if device.type != "cuda":
        return p
    p = _map_tensors(lambda t: t.pin_memory() if t.device.type == "cpu" else t, p)
    if copy:
        p = _map_tensors(lambda t: t.to(device, non_blocking=True), p)
    return p


@dataclasses.dataclass
class _Captured:
    """One warm signature's CUDA graph: its static input leaves (in
    :func:`_tensor_leaves` order of ``PreparedBatch.inputs``) and its static
    output, which every replay overwrites."""

    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]
    output: torch.Tensor


@dataclasses.dataclass
class _CompiledBucket:
    """Program-cache record: the forward closure and, per warm signature,
    its captured graph (``None`` on the CPU, where the forward runs
    eagerly).  ``compile_s`` is capture seconds, ``warm_s`` the eager warm
    forward plus the first replay; ``lowered_count`` counts the captures
    (JAX: fresh trace + lower + compiles).  ``counted`` holds the JAX warm
    keys (params signature + batch signature, no tenant name) whose forward
    the dispatch census has recorded."""

    fn: Callable
    num_graphs: Optional[int]
    warm: Set[tuple] = dataclasses.field(default_factory=set)
    counted: Set[tuple] = dataclasses.field(default_factory=set)
    executables: Dict[tuple, Optional[_Captured]] = dataclasses.field(
        default_factory=dict)
    compile_s: float = 0.0
    warm_s: float = 0.0
    lowered_count: int = 0


@dataclasses.dataclass
class Tenant:
    """One registered model: config, params (on the executor's device,
    quantized for precisions other than fp32), the quantization report,
    and the derived program key / params signature."""

    name: str
    cfg: M.GNNConfig
    params: dict
    precision: str = "fp32"
    share_layout: bool = True
    fused: bool = False
    quant_report: object = None
    params_sig: tuple = ()

    @property
    def program_key(self) -> tuple:
        """Program records are shared by tenants with equal keys: the
        forward depends on (cfg, precision, layout sharing, fusion), never
        on the parameter values."""
        return (self.cfg, self.precision, self.share_layout, self.fused)


class Executor:
    """The single program-cache / warm / timing path of the port."""

    def __init__(self, buckets: Sequence[tuple] = DEFAULT_BUCKETS,
                 clock: Optional[Clock] = None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 device="cuda", aot_cache: Optional[AOTCache] = None,
                 mesh=None, rules: Optional[dict] = None):
        self.device = resolve_device(device)
        self.mesh = mesh
        if rules is None and mesh is not None:
            rules = PT.gnn_rules(mesh)
        self.rules = rules
        self.aot = aot_cache
        self._env_fp: Optional[dict] = None  # lazy: reads the device
        self._aot_seen = 0  # lookups of ``aot.log`` already reported
        if aot_cache is not None:
            _build.use_cache(aot_cache, self._fingerprint())
        self.buckets = sorted(buckets)
        # the one place real time is measured; a test injects a stepping clock
        self.clock = clock if clock is not None else RealClock()
        self.tenants: Dict[str, Tenant] = {}
        self._compiled: Dict[tuple, _CompiledBucket] = {}
        self._eigvec_lru: collections.OrderedDict = collections.OrderedDict()
        # telemetry sinks, dark by default
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        self._mi = ServingInstruments(metrics) if metrics is not None else None

    def attach_telemetry(self, tracer: Optional[Tracer] = None,
                         metrics: Optional[MetricsRegistry] = None) -> None:
        """Adopt telemetry sinks after construction; sinks this executor
        already carries are kept (the first attachment wins)."""
        if tracer is not None and not self.tracer.enabled:
            self.tracer = tracer
        if metrics is not None and self.metrics is None:
            self.metrics = metrics
            self._mi = ServingInstruments(metrics)

    # ---------------------------------------------------------- tenants

    def register(self, name: str, cfg: M.GNNConfig, params: dict,
                 precision: str = "fp32",
                 calib_graphs: Optional[Sequence[tuple]] = None,
                 fused: bool = False, share_layout: bool = True) -> Tenant:
        """Admit a model.  ``precision`` selects the serving arithmetic:
        "fp32", "int8" (dynamic per-node activation scales), "int8-static"
        (calibrated on ``calib_graphs``, raw COO tuples) or "fixed"
        (ap_fixed emulation), each with ``quant.apply.precision_qconfig``'s
        recipe.  Quantization runs once here, on ``params`` where the
        caller keeps them (calibration and transform see the same tree);
        then the params move to the executor's device.  ``share_layout``
        (default on) threads one ``GraphLayout`` plan through every layer;
        off, the tenant serves the per-call-sort path."""
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} already registered")
        quant_report = None
        if precision != "fp32":
            from repro_torch.quant import apply as QA

            qcfg = QA.precision_qconfig(precision)
            if (qcfg.scheme == "int8" and qcfg.act_mode == "static"
                    and not calib_graphs):
                raise ValueError(
                    "static-activation int8 needs calib_graphs (raw COO "
                    "tuples) to calibrate activation ranges"
                )
            params, quant_report = QA.quantize_model(
                params, cfg, calib_graphs or (), qcfg
            )
        params = _params_to(params, self.device)
        tenant = Tenant(name=name, cfg=cfg, params=params, precision=precision,
                        share_layout=share_layout, fused=fused,
                        quant_report=quant_report,
                        params_sig=params_signature(params))
        self.tenants[name] = tenant
        return tenant

    def tenant(self, model: Optional[str] = None) -> Tenant:
        """Resolve a tenant by name; ``None`` means the sole tenant."""
        if model is not None:
            if model not in self.tenants:
                raise KeyError(f"no tenant {model!r}; registered: {sorted(self.tenants)}")
            return self.tenants[model]
        if len(self.tenants) == 1:
            return next(iter(self.tenants.values()))
        raise KeyError(
            f"model name required: {len(self.tenants)} tenants registered "
            f"({sorted(self.tenants)})"
        )

    # --------------------------------------------------------- plumbing

    @property
    def compile_seconds(self) -> float:
        """Total CUDA-graph capture time across programs (0 on the CPU);
        excluded from every reported latency."""
        return sum(cb.compile_s for cb in self._compiled.values())

    @property
    def warm_seconds(self) -> float:
        """Total untimed warm time across programs: the eager forward (the
        kernels' build included) and the first replay."""
        return sum(cb.warm_s for cb in self._compiled.values())

    @property
    def untimed_seconds(self) -> float:
        """compile + warm: everything excluded from reported latencies."""
        return self.compile_seconds + self.warm_seconds

    @property
    def lowered_count(self) -> int:
        """CUDA-graph captures across programs (the counterpart of JAX's
        trace + lower + compiles; 0 on the CPU).  Unlike JAX's, not 0 in a
        process restarted on a warm cache: graphs are not serialized, so
        every process captures its own."""
        return sum(cb.lowered_count for cb in self._compiled.values())

    @property
    def ranks(self) -> int:
        """The ranks each forward is spread over (1 without a mesh)."""
        return 1 if self.mesh is None else self.mesh.size

    @property
    def captured(self) -> bool:
        """Whether forwards run as CUDA graphs (:func:`captures`)."""
        return captures(self.device.type, self.ranks,
                        "none" if self.mesh is None else self.mesh.backend)

    def _slowest(self, seconds: float) -> float:
        """The largest of every rank's ``seconds`` (itself on one rank)."""
        if self.ranks == 1:
            return seconds
        import torch.distributed as dist

        t = torch.tensor([seconds], dtype=torch.float64,
                         device=self.device if self.mesh.backend == "nccl" else "cpu")
        for axis in self.mesh.axis_names:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.group(axis))
        return float(t.item())

    # ------------------------------------------------------------- mesh

    def _mesh_scope(self):
        """Context under which forwards run: the executor's mesh and rules
        installed (``runtime.use_mesh`` / ``active_rules``); a null context
        without a mesh."""
        return _mesh_scope(self.mesh, self.rules)

    @staticmethod
    def _constrain_graph(g: G.Graph, eigvec, layout, share_layout: bool):
        """-> this rank's (graph, eigvec, layout) under the active mesh, or
        the inputs as they are when the bucket's node rows stay whole.
        JAX constrains the graph's rows and the plan's in two methods; here
        the plan's window of owned edges decides both, so one method gives
        the three (``core.message_passing.shard_inputs``)."""
        shard = PT.row_shard(g.num_nodes)
        if shard is None:
            return g, eigvec, layout
        if layout is None and share_layout:
            layout = LY.build_layout(g)
        return MP.shard_inputs(g, eigvec, layout, shard)

    def _sharded(self, fn: Callable, share_layout: bool) -> Callable:
        """``fn`` run on this rank's part of each batch, under the mesh.  The
        closure holds the mesh and rules, not the executor: an executor
        held by its own program records would outlive its last reference
        until the cycle collector ran, and its CUDA graphs with it, at a
        different moment on each rank, past ``destroy_process_group``."""
        mesh, rules = self.mesh, self.rules

        def run(params, g, eigvec, layout):
            with _mesh_scope(mesh, rules):
                return fn(params, *Executor._constrain_graph(g, eigvec, layout,
                                                             share_layout))

        return run

    # ------------------------------------------------------ AOT plumbing

    def _fingerprint(self) -> dict:
        """The environment fingerprint the kernel-library cache checks
        (``serve.aot.environment_fingerprint``), computed once."""
        if self._env_fp is None:
            self._env_fp = environment_fingerprint()
        return dict(self._env_fp)

    def aot_stats(self) -> Dict[str, int]:
        """Kernel-library cache outcomes (zeros when no cache is set)."""
        return (dict(self.aot.stats) if self.aot is not None
                else {"hit": 0, "miss": 0, "stale": 0})

    def _report_aot(self, tenant: Tenant, bucket_key: tuple) -> None:
        """Mirror the cache lookups made since the last report (a warm's
        first loads of the kernel libraries) into the sinks."""
        if self.aot is None:
            return
        new = self.aot.log[self._aot_seen:]
        self._aot_seen += len(new)
        for key, result in new:
            if self._mi is not None:
                self._mi.aot_cache.inc(result=result)
            if self.tracer.enabled:
                self.tracer.event("aot_load", track="executor",
                                  tenant=tenant.name, bucket=str(bucket_key),
                                  library=key[0], result=result)

    def bucket_for(self, n: int, e: int) -> tuple:
        """Smallest configured (N_pad, E_pad) bucket holding (n, e)."""
        for nb, eb in self.buckets:
            if n <= nb and e <= eb:
                return nb, eb
        raise ValueError(f"graph ({n},{e}) exceeds largest bucket {self.buckets[-1]}")

    def _program(self, tenant: Tenant, bucket_key: tuple,
                 num_graphs: Optional[int]) -> _CompiledBucket:
        """The program record for (tenant architecture, bucket, slots);
        ``num_graphs`` is part of the key."""
        key = (tenant.program_key, bucket_key, num_graphs)
        cb = self._compiled.get(key)
        if cb is None:
            fn = M.forward_program(tenant.cfg, num_graphs=num_graphs,
                                   share_layout=tenant.share_layout,
                                   fused=tenant.fused)
            if self.mesh is not None:
                fn = self._sharded(fn, tenant.share_layout)
            cb = self._compiled[key] = _CompiledBucket(fn=fn, num_graphs=num_graphs)
            if self._mi is not None:
                self._mi.programs_built.inc()
            if self.tracer.enabled:
                self.tracer.event("program_build", track="executor",
                                  tenant=tenant.name, bucket=str(bucket_key),
                                  num_graphs=num_graphs)
        return cb

    def _capture(self, cb: _CompiledBucket, tenant: Tenant, p: PreparedBatch,
                 t0: float, census) -> Tuple[_Captured, float, float]:
        """Eager warm forward, capture and first replay of one signature on
        the card; -> (captured graph, capture seconds, warm seconds).  The
        static buffers are copies of the batch's tensors on the executor's
        device; the eager forward is kept out of the dispatch census, the
        capture is counted under ``census`` (a context manager)."""
        static = _map_tensors(lambda t: t.to(self.device, copy=True), p.inputs)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            with ops.census_muted():
                cb.fn(tenant.params, *static)
            side.synchronize()
            t1 = self.clock.now()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                with census:
                    out = cb.fn(tenant.params, *static)
            finally:
                graph.capture_end()
        t2 = self.clock.now()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph.replay()
        torch.cuda.synchronize(self.device)
        t3 = self.clock.now()
        cap = _Captured(graph=graph, inputs=tuple(_tensor_leaves(static)),
                        output=out)
        return cap, t2 - t1, (t1 - t0) + (t3 - t2)

    def _warm(self, cb: _CompiledBucket, sig: tuple, tenant: Tenant,
              p: PreparedBatch) -> float:
        """Make ``sig`` servable untimed: capture its graph
        (:meth:`_capture`) where the executor captures, else run it once.
        Returns the seconds spent (0.0 when already warm)."""
        if sig in cb.warm:
            return 0.0
        # the dispatch census counts this warm's forward once per JAX warm
        # key: a second tenant of the same key counts nothing
        jax_sig = sig[1:]
        census = (ops.census_muted() if jax_sig in cb.counted
                  else contextlib.nullcontext())
        t0 = self.clock.now()
        if self.captured:
            cap, compile_dt, warm_dt = self._capture(cb, tenant, p, t0, census)
            cb.lowered_count += 1
        else:
            with census:
                cb.fn(tenant.params, *self._inputs(p))
            cap, compile_dt, warm_dt = None, 0.0, self.clock.now() - t0
        cb.counted.add(jax_sig)  # only once the counted forward has returned
        self._report_aot(tenant, p.bucket_key)
        cb.executables[sig] = cap
        cb.warm.add(sig)
        cb.compile_s += compile_dt
        cb.warm_s += warm_dt
        if self._mi is not None:
            self._mi.warms.inc()
            self._mi.compile_seconds.inc(compile_dt)
            self._mi.warm_seconds.inc(warm_dt)
        if self.tracer.enabled:
            self.tracer.event("warm", track="executor",
                              bucket=str(p.bucket_key), dur_s=warm_dt,
                              compile_s=compile_dt)
        return compile_dt + warm_dt

    def _inputs(self, p: PreparedBatch) -> tuple:
        """The batch's forward arguments on the executor's device, for an
        eager forward (a host-built batch, pinned by :func:`staged`, is
        copied without blocking; a captured forward copies into its
        static buffers instead)."""
        return _map_tensors(lambda t: t.to(self.device, non_blocking=True),
                            p.inputs)

    @staticmethod
    def _signature(tenant: Tenant, p: PreparedBatch) -> tuple:
        """The warm key: a graph is captured with the tenant's params'
        addresses, so the tenant's name leads the JAX key."""
        return (tenant.name, tenant.params_sig) + p.signature

    # ---------------------------------------------------------- prepare

    def prepare_stream(self, raw: tuple, with_eigvec: bool = False,
                       host: bool = False) -> PreparedBatch:
        """One raw COO graph padded into the smallest bucket; no layout
        plan (the forward builds it on the device: one sort).  ``host``
        keeps the batch on the CPU (:func:`staged` moves it)."""
        s, r, nf, ef = raw[:4]
        nb, eb = self.bucket_for(nf.shape[0], len(s))
        device = "cpu" if host else self.device
        g = G.from_numpy(s, r, nf, ef, n_pad=nb, e_pad=eb, device=device)
        eig = None
        if with_eigvec:
            eig = torch.as_tensor(self._eigvec(s, r, nf.shape[0], nb),
                                  device=device)
        return prepared(g, eig, None, ("stream", nb, eb), 1)

    def prepare_batched(self, chunk: Sequence[tuple], batch_size: int,
                        n_pad: int, e_pad: int, with_eigvec: bool = False,
                        host: bool = False) -> PreparedBatch:
        """One fixed-size padded batch of the chunk's raw graphs, with the
        per-graph eigenvectors at the batch's node offsets when asked;
        ``host`` as for :meth:`prepare_stream`."""
        device = "cpu" if host else self.device
        gs = [(g[0], g[1], g[2], g[3]) for g in chunk]
        g = G.batch_graphs(gs, n_pad=n_pad, e_pad=e_pad, device=device)
        eig = None
        if with_eigvec:
            vec = np.zeros((n_pad,), np.float32)
            off = 0
            for s, r, nf, _ in gs:
                n = nf.shape[0]
                vec[off : off + n] = self._eigvec(s, r, n, n)
                off += n
            eig = torch.as_tensor(vec, device=device)
        return prepared(g, eig, None, ("batched", n_pad, e_pad, batch_size),
                        batch_size)

    def prepare_packed(self, packed: G.Graph, budget, eigvec=None,
                       layout=None, model: Optional[str] = None) -> PreparedBatch:
        """One already-packed batch (``core.batching``), with its packed
        eigenvector (``core.batching.pack_eigvecs``) for DGN.  Without a
        plan the host plan is built here when tenant ``model`` shares
        layouts; a per-call tenant's batch carries none."""
        if packed.device != self.device:
            raise ValueError(
                f"packed graph is on {packed.device}, executor on {self.device}"
            )
        if eigvec is not None:
            eigvec = torch.as_tensor(eigvec, dtype=torch.float32,
                                     device=self.device)
        if layout is None and self.tenant(model).share_layout:
            layout = B.pack_layout(packed)
        return prepared(packed, eigvec, layout,
                        ("packed", budget.n_pad, budget.e_pad, budget.g_pad),
                        budget.g_pad)

    def has_program(self, bucket_key: tuple, num_graphs: int,
                    model: Optional[str] = None) -> bool:
        """Whether this tenant has warmed a signature of the program record
        at (bucket, slots): the scheduler's eager-prewarm skip check.  The
        record is shared by same-architecture tenants, a captured graph is
        not (JAX's shared executable is), so the check is per tenant."""
        tenant = self.tenant(model)
        cb = self._compiled.get((tenant.program_key, bucket_key, num_graphs))
        return cb is not None and any(sig[0] == tenant.name for sig in cb.warm)

    # --------------------------------------------------------- warm/run

    def _harvest(self, out: torch.Tensor, done, tenant: Tenant,
                 p: PreparedBatch, t0: float) -> Tuple[np.ndarray, float]:
        """Complete one dispatched execution: wait for its event, close the
        timed region (under a mesh: the slowest rank's), then copy the output to the host under the
        ``unpack_d2h`` accounting.  The extra clock reads happen only with
        a live sink."""
        if done is not None:
            done.synchronize()
        dt = self._slowest(self.clock.now() - t0)
        accounted = self._mi is not None or self.tracer.enabled
        if accounted:
            t2 = self.clock.now()
        host = out.cpu().numpy()
        if accounted:
            d2h = self.clock.now() - t2
            if self._mi is not None:
                self._mi.device_seconds.inc(dt)
                self._mi.d2h_seconds.inc(d2h)
            if self.tracer.enabled:
                self.tracer.event("executor_run", track="executor",
                                  tenant=tenant.name, bucket=str(p.bucket_key),
                                  dur_s=dt)
                self.tracer.event("unpack_d2h", track="executor",
                                  tenant=tenant.name, bucket=str(p.bucket_key),
                                  dur_s=d2h)
        return host, dt

    def run_async(self, p: PreparedBatch,
                  model: Optional[str] = None) -> "PendingRun":
        """Dispatch one execution without waiting for it: warm the
        signature (untimed), open the timed region, copy the batch into the
        graph's static buffers, replay, clone the output, and return a
        :class:`PendingRun` at once; a batch in pinned host memory is
        copied without blocking, and the pending run holds it until the
        harvest.  Where the executor does not capture (the CPU, a gloo mesh
        of several ranks) the forward runs eagerly here, outside the
        dispatch census (its warm counted it).  The in-flight window is
        the caller's to bound."""
        tenant = self.tenant(model)
        cb = self._program(tenant, p.bucket_key, p.num_graphs)
        sig = self._signature(tenant, p)
        with torch.inference_mode():
            self._warm(cb, sig, tenant, p)
            cap = cb.executables[sig]
            t0 = self.clock.now()
            if cap is None:
                with ops.census_muted():
                    out = cb.fn(tenant.params, *self._inputs(p))
                done = None
                if self.device.type == "cuda":  # eager on the card
                    done = torch.cuda.Event()
                    done.record()
                return PendingRun(self, out, done, tenant, p, t0)
            for dst, src in zip(cap.inputs, _tensor_leaves(p.inputs)):
                dst.copy_(src, non_blocking=True)
            cap.graph.replay()
            out = cap.output.clone()
            done = torch.cuda.Event()
            done.record()
        return PendingRun(self, out, done, tenant, p, t0)

    def run(self, p: PreparedBatch,
            model: Optional[str] = None) -> Tuple[np.ndarray, float]:
        """The one timed execution: ``(outputs on the host, seconds)``,
        dispatch and an immediate harvest."""
        return self.run_async(p, model=model).result()

    def warm(self, p: PreparedBatch, model: Optional[str] = None) -> float:
        """Warm this batch's signature without a timed execution; returns
        the seconds spent (0.0 when already warm)."""
        tenant = self.tenant(model)
        cb = self._program(tenant, p.bucket_key, p.num_graphs)
        with torch.inference_mode():
            return self._warm(cb, self._signature(tenant, p), tenant, p)

    # ------------------------------------------------------------- misc

    _EIGVEC_LRU_SIZE = 128

    def _eigvec(self, s, r, n: int, n_pad: int) -> np.ndarray:
        """DGN's eigenvector input (``data.pipeline.laplacian_eigvec``),
        memoised in a small LRU keyed by (edge lists, n, n_pad): a stream
        revisits graph shapes, and the host eigensolve is the costliest
        prepare stage.  Lookups land in ``serve_eigvec_cache_total``."""
        s_arr, r_arr = np.ascontiguousarray(s), np.ascontiguousarray(r)
        key = (s_arr.tobytes(), r_arr.tobytes(), int(n), int(n_pad))
        vec = self._eigvec_lru.get(key)
        if vec is not None:
            self._eigvec_lru.move_to_end(key)
            if self._mi is not None:
                self._mi.eigvec_cache.inc(result="hit")
            return vec
        vec = laplacian_eigvec(s_arr, r_arr, n, n_pad)
        self._eigvec_lru[key] = vec
        if len(self._eigvec_lru) > self._EIGVEC_LRU_SIZE:
            self._eigvec_lru.popitem(last=False)
        if self._mi is not None:
            self._mi.eigvec_cache.inc(result="miss")
        return vec


def _mesh_scope(mesh, rules):
    """The context of a forward on ``mesh`` under ``rules``
    (``runtime.use_mesh`` and ``active_rules``); a null context without a
    mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(RC.use_mesh(mesh))
    stack.enter_context(PT.active_rules(rules))
    return stack


def captures(device_type: str, ranks: int, backend: str) -> bool:
    """Whether an executor on ``device_type`` whose forwards span ``ranks``
    ranks over ``backend`` runs them as CUDA graphs: on the card, on one
    rank or on an NCCL mesh; a gloo mesh of several ranks runs eagerly (a
    gloo collective cannot be captured)."""
    return device_type == "cuda" and (ranks == 1 or backend == "nccl")


class PendingRun:
    """One dispatched, unharvested execution, as :meth:`Executor.run_async`
    returns it.

    ``result()`` waits for the run's event, closes the timed region
    (dispatch to harvest on the executor's clock), copies the output to the
    host under the ``unpack_d2h`` accounting, and caches: a second call
    returns the same ``(outputs, seconds)``.  The device output is dropped
    once harvested; ``done`` flips then."""

    __slots__ = ("_executor", "_out", "_done", "_tenant", "_prepared", "_t0",
                 "_result")

    def __init__(self, executor: Executor, out: torch.Tensor, done,
                 tenant: Tenant, prepared: PreparedBatch, t0: float):
        self._executor = executor
        self._out = out
        self._done = done
        self._tenant = tenant
        self._prepared = prepared
        self._t0 = t0
        self._result: Optional[Tuple[np.ndarray, float]] = None

    @property
    def done(self) -> bool:
        return self._result is not None

    def result(self) -> Tuple[np.ndarray, float]:
        if self._result is None:
            self._result = self._executor._harvest(
                self._out, self._done, self._tenant, self._prepared, self._t0
            )
            self._out = self._done = None
        return self._result

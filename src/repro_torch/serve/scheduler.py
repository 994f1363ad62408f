"""Streaming multi-graph scheduler: SLO-aware admission + micro-batcher
(port of ``repro.serve.scheduler``).

The paper's real-time mode serves one graph per program dispatch; under
heavy traffic the dispatch overhead dominates for molecule-sized graphs.
FlowGNN's multi-queue insight applies directly: keep *multiple open
buckets* — one per (tenant, QoS class, compiled-shape signature) — and
greedily pack arriving graphs into the open bucket for their key until
the bucket's ``BucketBudget`` is exhausted or a flush deadline expires,
then flush the packed batch through the executor.  Every flush of a
signature reuses the same compiled program, so after one warm flush per
signature the stream runs with zero recompiles.

**Time.** Nothing here reads a wall clock.  All ``arrival_s`` /
``deadline_s`` / flush timing flows through an injectable
``serve.clock.Clock`` that the event loop advances deterministically —
the default is a fresh ``VirtualClock`` per ``run``, so a scripted
arrival trace reproduces every flush timestamp and shed decision
bitwise (``tests/test_torch_scheduler.py`` asserts exact float equality,
and equality with the JAX scheduler's on the same trace).  The only
real-time measurement in the serving stack is the executor's timed region
(``tests/test_torch_engine_singlepath.py`` holds ``time`` to
``serve/executor.py`` + ``serve/clock.py``).

**Admission (SLO-aware).**  A request maps to the smallest single-graph
bucket that fits it (``Executor.bucket_for``) and carries a QoS class
(``Request.priority``, lower = more urgent) and an SLO budget
(``slo_s``, resolved per (tenant, class)).  At its arrival instant the
scheduler projects the queueing delay the request would suffer —
``max(0, device_free - now)``, plus one observed service-time estimate
per already-open bucket (admitted work the device has not seen yet),
plus the flush this request would ride — and **sheds** the request with
a typed :class:`Shed` result when the projection exceeds
``admit_margin * slo`` (the guard band absorbs flushes that insert
ahead after admission; see the ``admit_margin`` docstring)
(no executor work, no queue growth) when the projection already exceeds
the SLO; an optional ``admit_limit`` bounds the total admitted-but-
unflushed queue the same way (reason ``"queue_full"``).  Under overload
the queue therefore stays bounded and the p99 of *admitted* requests
holds near the SLO while the shed rate absorbs the excess — goodput
degrades gracefully instead of latency collapsing.

**Flush ordering (QoS).**  A bucket's flush deadline is the earliest of
``opened_at + max_wait_s`` and each member's SLO deadline minus the
service estimate.  When several buckets are ready at the same effective
instant (the common case under backlog, where every expired bucket waits
on ``device_free``), the highest-priority class flushes first; ties
break by bucket age — a deterministic total order.

**Budget ladder.**  Each signature owns rungs at 1x, 2x, 3x, 4x, 6x,
8x, ..., ``capacity``x of the base bucket (powers of two plus their 1.5x
midpoints, bounding padding slack at a flush to ~33%): admission always
targets the top rung, but a flush executes on the smallest rung that
fits what actually accumulated.  With ``adapt_ladder=True`` the rung
geometry *re-fits itself* to the observed flush-size histogram every
``refit_every`` flushes per signature: rungs traffic never hits are
closed, rungs the histogram needs are opened (and warm lazily, riding
the ``prewarm="lazy"`` machinery), while the top rung is always kept at
``capacity`` so everything admissible before a refit stays admissible
after it.  Ladder *geometry* is shared across tenants; warm state is per
tenant program, governed by ``prewarm``:

  * ``"eager"`` (single-tenant default, the historical behaviour): every
    rung warms (on the card: captures its CUDA graph) untimed the first
    time its signature appears for a tenant, so a live stream never
    captures after warmup no matter how load fluctuates.  The skip check
    is per tenant (``Executor.has_program``): a captured graph holds one
    tenant's params.
  * ``"lazy"`` (multi-tenant default): a rung warms — still strictly
    outside the timed region, tracked in ``compile_seconds`` +
    ``warm_seconds`` — on its first flush.

Every flush carries its pack-time payload: ``_execute`` calls
``core.batching.pack_prepared``, which builds the padded graph, the packed
eigenvectors, and the ``GraphLayout`` plan on the host as one
``PreparedBatch`` in pinned memory, which the replay copies into the
rung's CUDA graph without blocking — the flushed program (one replay)
performs zero on-device sorts.

``StreamScheduler.run`` is an event-driven simulation of a live stream on
a single serial executor: arrivals are offered at a configurable rate
(QPS) or as an explicit timestamp trace, flushes execute real engine
compute (the executor's timed region on its real clock), and the virtual clock
folds the two together — so reported per-request latency includes
queueing delay, which is what a latency-vs-throughput sweep needs.

**Telemetry.**  Pass ``tracer=obs.Tracer(clock)`` / ``metrics=obs.
MetricsRegistry()`` to record the full request lifecycle (admit/shed ->
queue -> pack -> flush -> device -> unpack -> respond as spans on the
run's clock timeline) and the serving counter catalog (sheds by reason,
flushes by reason, latency histograms, queue depth, per-signature
service EWMA — ``obs.metrics.CATALOG``).  Both default off; the no-op
sink is provably free — identical flush log, zero extra compile keys,
zero clock reads (``tests/test_torch_scheduler.py``).  ``StreamReport``'s
aggregates are views over the same flush/shed event records the
registry is fed from, so the two surfaces agree by construction.
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter, deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.batching import (
    BucketBudget,
    graph_sizes,
    pack_prepared,
    unpack_outputs,
)
from repro_torch.obs.metrics import MetricsRegistry, ServingInstruments
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serve.clock import Clock, VirtualClock
from repro_torch.serve.executor import Executor
from repro_torch.serve.pipeline import PipelineConfig, as_pipeline


def _tenant_label(model: Optional[str]) -> str:
    """Metric/trace label for a tenant: ``None`` (the sole tenant on a
    bare executor) renders as ``"default"`` so label values are never
    the string ``"None"``."""
    return model if model is not None else "default"


@dataclasses.dataclass
class Request:
    """One in-flight graph: raw COO payload + arrival timestamp + routing.

    ``model`` names the tenant (``None`` = the sole registered model);
    ``priority`` is the QoS class (lower = more urgent, 0 = default);
    ``slo_s`` is the end-to-end latency budget from arrival (``inf`` =
    best-effort, never shed, never deadline-tightened)."""

    rid: int
    graph: tuple  # (senders, receivers, node_feat[, edge_feat])
    arrival_s: float
    model: Optional[str] = None
    priority: int = 0
    slo_s: float = math.inf
    n: int = 0
    e: int = 0

    def __post_init__(self):
        if len(self.graph) == 3:  # edge-feature-less RawGraph form
            self.graph = (*self.graph, None)
        self.n, self.e = graph_sizes(self.graph)

    @property
    def deadline_s(self) -> float:
        """The SLO deadline: completion after this is a deadline miss."""
        return self.arrival_s + self.slo_s


@dataclasses.dataclass(frozen=True)
class Shed:
    """A typed admission rejection — the backpressure signal a caller can
    retry, downgrade, or route elsewhere on.  ``projected_delay_s`` is
    the queueing-delay estimate that triggered the decision."""

    rid: int
    model: Optional[str]
    priority: int
    reason: str  # "backlog" | "queue_full"
    at_s: float  # virtual admission instant
    projected_delay_s: float
    slo_s: float


@dataclasses.dataclass(frozen=True)
class FlushRecord:
    """One flush event, fully timestamped on the virtual clock — the
    deterministic audit trail the simulation tests assert against, and
    the *primary record* every stream-level tally is a view over
    (``StreamReport.batch_sizes`` / ``flush_reasons`` / ``compute_s`` /
    ``deadline_misses`` are all derived from the flush log, never
    counted in parallel)."""

    model: Optional[str]
    priority: int
    sig: tuple  # base-bucket signature (N_pad, E_pad)
    rids: Tuple[int, ...]
    reason: str  # budget | deadline | drain
    at_s: float  # flush decision instant
    start_s: float  # when the device actually started (>= at_s)
    done_s: float  # start_s + compute
    compute_s: float
    rung_multiple: int  # executed rung, in base-bucket multiples
    misses: int = 0  # members whose done_s exceeded their SLO deadline


@dataclasses.dataclass
class StreamReport:
    """Per-request latencies plus stream-level accounting.

    ``outputs`` / ``latencies_s`` are rid-ordered over every *offered*
    request; shed requests hold ``None`` / ``nan`` there and appear as
    typed :class:`Shed` entries in ``shed``.  Conservation always holds:
    ``num_served + num_shed == num_requests``.

    The report stores only the primary event records — the flush log and
    the shed list.  Every aggregate (``batch_sizes``, ``flush_reasons``,
    ``compute_s``, ``deadline_misses``, the served/shed counts) is a
    *view* derived from those records, never a parallel tally; when a
    metrics registry is attached to the scheduler, the registry's
    counters are fed from the same events, so the two surfaces agree by
    construction."""

    latencies_s: np.ndarray  # (n_offered,) completion - arrival; nan if shed
    outputs: List[Optional[np.ndarray]]  # rid order; None for shed requests
    makespan_s: float  # virtual time from first arrival to last completion
    compile_s: float  # untimed compile + first-run warm (excluded from latencies)
    shed: List[Shed] = dataclasses.field(default_factory=list)
    flush_log: List[FlushRecord] = dataclasses.field(default_factory=list)

    @property
    def batch_sizes(self) -> List[int]:
        """Real graphs per flush, flush order (view over the flush log)."""
        return [len(f.rids) for f in self.flush_log]

    @property
    def flush_reasons(self) -> Counter:
        """budget | deadline | drain counts (view over the flush log)."""
        return Counter(f.reason for f in self.flush_log)

    @property
    def compute_s(self) -> float:
        """Total engine compute across flushes (view over the flush log)."""
        return sum((f.compute_s for f in self.flush_log), 0.0)

    @property
    def deadline_misses(self) -> int:
        """Admitted requests that finished past their SLO (view over the
        flush log's per-flush miss counts)."""
        return sum(f.misses for f in self.flush_log)

    @property
    def num_requests(self) -> int:
        """Offered requests (served + shed)."""
        return len(self.outputs)

    @property
    def num_shed(self) -> int:
        return len(self.shed)

    @property
    def num_served(self) -> int:
        return self.num_requests - self.num_shed

    @property
    def shed_rate(self) -> float:
        return self.num_shed / max(self.num_requests, 1)

    @property
    def graphs_per_s(self) -> float:
        """Goodput: *served* graphs per second of makespan."""
        return self.num_served / max(self.makespan_s, 1e-12)

    def percentile_ms(self, q: float) -> float:
        """Latency percentile over the requests that were actually served.

        ``nan`` when nothing was served (empty stream, or everything
        shed) — an empty report must be representable, not a crash."""
        served = self.latencies_s[np.isfinite(self.latencies_s)]
        if served.size == 0:
            return float("nan")
        return float(np.percentile(served, q) * 1e3)


class _OpenBucket:
    """One (tenant, QoS class, signature)'s accumulating micro-batch.

    Admission is checked against the *top* rung of the signature's ladder;
    ``rung()`` picks the smallest rung the accumulated batch fits, which
    is the program a flush actually executes.  The flush deadline starts
    at ``opened_at + max_wait_s`` and tightens as SLO-carrying members
    join (their deadline minus the service estimate, clamped at their
    arrival), so a bucket never idles a member into a deadline miss the
    scheduler could have avoided.
    """

    __slots__ = ("model", "priority", "seq", "ladder", "budget", "requests",
                 "n_used", "e_used", "deadline_s")

    def __init__(self, ladder: Sequence[BucketBudget], opened_at_s: float,
                 max_wait_s: float, model: Optional[str] = None,
                 priority: int = 0, seq: int = 0):
        self.model = model
        self.priority = priority
        self.seq = seq  # open order: the deterministic final tie-break
        self.ladder = ladder
        self.budget = ladder[-1]
        self.requests: List[Request] = []
        self.n_used = 0
        self.e_used = 0
        self.deadline_s = opened_at_s + max_wait_s

    def rung(self) -> BucketBudget:
        for b in self.ladder:
            if (self.n_used <= b.n_pad and self.e_used <= b.e_pad
                    and len(self.requests) <= b.g_pad):
                return b
        return self.budget

    def admits(self, req: Request) -> bool:
        return self.budget.admits(self.n_used, self.e_used, len(self.requests),
                                  req.n, req.e)

    def add(self, req: Request, service_est_s: float = 0.0) -> None:
        self.requests.append(req)
        self.n_used += req.n
        self.e_used += req.e
        if math.isfinite(req.slo_s):
            self.deadline_s = min(
                self.deadline_s,
                max(req.arrival_s, req.deadline_s - service_est_s),
            )

    @property
    def full(self) -> bool:
        """No further graph could ever be admitted (slot count exhausted)."""
        return len(self.requests) >= self.budget.g_pad


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-unharvested flush in the pipelined in-flight
    window.  Every field is fixed at dispatch (the device is serial, so
    the modeled completion instant is known then); the harvest step only
    finalizes — response order, flush-log append, trace/metric emission —
    strictly FIFO off the window front."""

    key: tuple  # (model, priority, sig)
    bucket: _OpenBucket
    rung: BucketBudget
    outs: List[np.ndarray]
    reason: str
    at_s: float  # flush decision instant
    start_s: float  # dispatch instant (host pack done, run_async issued)
    begin_s: float  # device actually starts (>= start_s under backlog)
    done_s: float  # begin_s + compute: the completion/harvest instant
    compute_s: float


class StreamScheduler:
    """SLO-aware micro-batching front-end for the serving executor.

    engine:       a single-tenant ``GNNEngine`` facade **or** a
                  multi-tenant ``Executor`` — all compute and warm
                  bookkeeping goes through the executor either way.
    capacity:     packed budgets are ``capacity`` multiples of the base
                  single-graph bucket (with ``2*capacity`` graph slots).
    max_wait_s:   the batching latency ceiling: a bucket flushes at latest
                  this long after it opened (SLO deadlines can tighten
                  an individual bucket further, never loosen it).
    with_eigvec:  compute DGN's Laplacian-eigenvector input per request;
                  ``"auto"`` resolves per tenant (eigvec iff DGN).
    budgets:      explicit per-signature ladders (overrides derivation).
    prewarm:      ``"eager"`` / ``"lazy"`` ladder warm policy (see module
                  docstring); default eager for a single engine, lazy for
                  a multi-tenant executor.
    slo_s:        default SLO budget (seconds from arrival) for every
                  request; ``None`` = best-effort (no shedding, no
                  deadline accounting) — the historical behaviour.
    slo_by_class: ``{(model|None, priority): slo_s}`` overrides — the
                  per-(tenant, QoS class) SLO table; ``None`` model keys
                  apply to every tenant.
    admit_limit:  bound on admitted-but-unflushed requests; arrivals
                  beyond it shed with reason ``"queue_full"``.
    admit_margin: fraction of the SLO the admission projection may use
                  (0 < margin <= 1, default 1.0).  Under sustained
                  overload, flushes of buckets *filled after* a request
                  was admitted legitimately run before its own
                  deadline-flush, so projecting against the full SLO
                  leaves the tail no headroom; a guard band (e.g. 0.7)
                  sheds at ``projected > margin * slo`` and keeps the
                  p99 of served requests inside the advertised SLO.
                  Deadline accounting still uses the full SLO.
    adapt_ladder: re-fit each signature's rung geometry to the observed
                  flush-size histogram every ``refit_every`` flushes
                  (top rung pinned at ``capacity``; at most ``max_rungs``
                  rungs survive a refit).
    service_s:    initial per-signature service-time estimate used by
                  admission / deadline tightening before the first flush
                  is observed (then an EWMA of measured flush compute).
    svc_alpha:    EWMA coefficient of the per-signature service-time
                  estimate: ``ewma = (1 - svc_alpha) * ewma + svc_alpha
                  * observed`` per flush.  Default 0.5 (the historical
                  half-life-of-one-flush behaviour); smaller = smoother
                  admission projections under noisy compute, larger =
                  faster tracking after a workload shift.  The live
                  per-signature EWMA is exported as the
                  ``serve_service_ewma_seconds{sig=...}`` gauge when a
                  registry is attached.
    tracer:       an ``obs.trace.Tracer`` recording the request
                  lifecycle (admit/shed -> queue -> pack -> flush ->
                  device -> unpack -> respond).
                  Default ``None`` = the shared no-op ``NULL_TRACER``
                  (provably free: identical flush log, zero clock
                  reads).  ``run`` rebinds the tracer's clock to the
                  run's clock so span timestamps share the timeline.
    metrics:      an ``obs.metrics.MetricsRegistry`` receiving the
                  serving counters/gauges/histograms (the catalog in
                  ``obs.metrics.CATALOG``).  Default ``None`` = off.
                  Both sinks are also attached to the executor (if it
                  has none yet) so compile/warm/device accounting lands
                  in the same trace and registry.
    clock:        the time authority; ``None`` = a fresh deterministic
                  ``VirtualClock`` per ``run``.  Inject a shared clock to
                  chain runs on one timeline, or a ``RealClock`` to stamp
                  live arrivals.
    pipeline:     pipelined (dispatch-ahead) execution mode.  ``None`` /
                  ``False`` = the serial event loop (historical
                  behaviour, bitwise-unchanged); ``True`` = defaults
                  (in-flight depth 2); an int = that depth; a
                  ``serve.pipeline.PipelineConfig`` = full control,
                  including the modeled per-flush host-pack cost.  In
                  pipelined mode a bucket dispatches at its deadline
                  whenever the bounded in-flight window has room — the
                  device need not be free — and completions are
                  harvested strictly FIFO, so per-request response order
                  is preserved while host pack for flush k+1 overlaps
                  device compute for flush k on the (virtual) timeline.
                  ``FlushRecord.start_s`` is then the *dispatch* instant
                  (host pack done, ``run_async`` issued), not the device
                  start; ``done_s`` stays the completion instant.
                  Admission projection adds a per-signature host-pack
                  EWMA on top of the serial device-backlog model (with
                  the default free host cost it reduces exactly to the
                  serial projection).  Deterministic under
                  ``VirtualClock``: the loop stays single-threaded and
                  models the overlap; live threading lives only in
                  ``serve.pipeline.PipelinedStream``.
    """

    def __init__(
        self,
        engine: Union[Executor, object],
        capacity: int = 4,
        max_wait_s: float = 0.002,
        with_eigvec: Union[bool, str] = False,
        budgets: Optional[Dict[tuple, Sequence[BucketBudget]]] = None,
        prewarm: Optional[str] = None,
        slo_s: Optional[float] = None,
        slo_by_class: Optional[Dict[Tuple[Optional[str], int], float]] = None,
        admit_limit: Optional[int] = None,
        admit_margin: float = 1.0,
        adapt_ladder: bool = False,
        refit_every: int = 64,
        max_rungs: int = 8,
        service_s: float = 0.0,
        svc_alpha: float = 0.5,
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
        clock: Optional[Clock] = None,
        pipeline: Union[None, bool, int, PipelineConfig] = None,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if isinstance(engine, Executor):
            self.engine = None
            self.executor = engine
            self._default_model = None
        else:  # a GNNEngine facade
            self.engine = engine
            self.executor = engine.executor
            self._default_model = engine.name
        if prewarm is None:
            prewarm = "eager" if self.engine is not None else "lazy"
        if prewarm not in ("eager", "lazy"):
            raise ValueError(f"prewarm must be 'eager' or 'lazy', got {prewarm!r}")
        if admit_limit is not None and admit_limit < 1:
            raise ValueError("admit_limit must be >= 1 (or None for unbounded)")
        if not 0.0 < admit_margin <= 1.0:
            raise ValueError("admit_margin must be in (0, 1]")
        if refit_every < 1:
            raise ValueError("refit_every must be >= 1")
        if max_rungs < 2:
            raise ValueError("max_rungs must be >= 2 (base + top)")
        if not 0.0 < svc_alpha <= 1.0:
            raise ValueError("svc_alpha must be in (0, 1]")
        self.prewarm = prewarm
        self.capacity = capacity
        self.max_wait_s = max_wait_s
        self.with_eigvec = with_eigvec
        self.slo_s = slo_s
        self.slo_by_class = dict(slo_by_class or {})
        self.admit_limit = admit_limit
        self.admit_margin = admit_margin
        self.adapt_ladder = adapt_ladder
        self.refit_every = refit_every
        self.max_rungs = max_rungs
        self.service_s = service_s
        self.svc_alpha = svc_alpha
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        self._mi = ServingInstruments(metrics) if metrics is not None else None
        if (tracer is not None or metrics is not None):
            # compile/warm/device accounting lands in the same sinks; an
            # executor that already carries its own telemetry keeps it
            self.executor.attach_telemetry(tracer=tracer, metrics=metrics)
        self.clock = clock
        # signature key -> ascending budget ladder (custom or derived);
        # geometry is shared across tenants
        self._ladders: Dict[tuple, List[BucketBudget]] = {
            k: sorted(v) for k, v in (budgets or {}).items()
        }
        self._pipeline = as_pipeline(pipeline)
        # per-signature service-time EWMA (measured flush compute) and the
        # observed ideal-rung-multiple window the adaptive refit consumes
        self._svc_s: Dict[tuple, float] = {}
        self._obs_multiples: Dict[tuple, List[int]] = {}
        # per-signature host-pack EWMA (pipelined admission projection)
        self._pack_s: Dict[tuple, float] = {}

    # ------------------------------------------------------------ admission

    def _needs_eigvec(self, model: Optional[str]) -> bool:
        if self.with_eigvec == "auto":
            return self.executor.tenant(model).cfg.model == "dgn"
        return bool(self.with_eigvec)

    def resolve_slo_s(self, model: Optional[str], priority: int) -> float:
        """The SLO budget for one (tenant, QoS class): the class table
        first (tenant-specific beats wildcard), then the default."""
        for key in ((model, priority), (None, priority)):
            if key in self.slo_by_class:
                return float(self.slo_by_class[key])
        return float(self.slo_s) if self.slo_s is not None else math.inf

    def service_estimate_s(self, sig: tuple) -> float:
        """The signature's observed service-time EWMA (initially
        ``service_s``) — the deterministic input to shed decisions and
        deadline tightening."""
        return self._svc_s.get(sig, self.service_s)

    def pack_estimate_s(self, sig: tuple) -> float:
        """The signature's host-pack EWMA (pipelined mode only; 0.0
        before the first flush, and identically 0.0 under the default
        free modeled host cost — which is what makes the pipelined
        admission projection reduce to the serial one)."""
        return self._pack_s.get(sig, 0.0)

    def _observe_pack(self, sig: tuple, pack_s: float) -> None:
        """Fold one flush's host-pack seconds (modeled or measured) into
        the signature's pack EWMA — same ``svc_alpha`` coefficient as
        the service estimate."""
        prev = self._pack_s.get(sig)
        a = self.svc_alpha
        self._pack_s[sig] = (pack_s if prev is None
                             else (1.0 - a) * prev + a * pack_s)
        if self._mi is not None:
            self._mi.pack_ewma.set(self._pack_s[sig], sig=f"{sig[0]}x{sig[1]}")

    def ladder_multiples(self, sig: tuple) -> List[int]:
        """Current rung geometry of one signature, in base-bucket
        multiples (bench/test introspection)."""
        nb, _ = sig
        return [b.n_pad // nb for b in self._ladders.get(sig, [])]

    def ladder_for(self, req: Request) -> Tuple[tuple, List[BucketBudget]]:
        """Map a request to its signature key and budget ladder.

        Under eager prewarm, the first time a (tenant, signature) pair
        appears every rung is warmed untimed (the executor tracks the cost
        in ``compile_seconds``), so no rung ever captures inside the
        measured stream; under lazy prewarm, rungs warm on first flush
        instead (still untimed).
        """
        nb, eb = self.executor.bucket_for(req.n, req.e)
        key = (nb, eb)
        ladder = self._ladders.get(key)
        if ladder is None:
            ks, k = set(), 1
            while k < self.capacity:
                ks.add(k)
                if k + k // 2 < self.capacity:
                    ks.add(k + k // 2)  # 1.5x midpoint: 3, 6, 12, ...
                k *= 2
            ks.add(self.capacity)
            ladder = self._ladders[key] = [
                BucketBudget(n_pad=k * nb, e_pad=k * eb, g_pad=2 * k)
                for k in sorted(ks)
            ]
        if self.prewarm == "eager":
            self._warm_ladder(ladder, req)
        return key, ladder

    def _refit_ladder(self, sig: tuple) -> None:
        """Re-fit one signature's rung geometry to its observed flush-size
        histogram: keep the rung multiples traffic actually needed, open
        ones it asked for between old rungs, close the rest.  Invariants
        (property-tested): the top rung stays exactly ``capacity`` (so
        admission capacity never shrinks), geometry stays sorted, every
        multiple stays in ``[1, capacity]``, and at most ``max_rungs``
        survive.  Open buckets keep their captured ladder object, so a
        refit never strands an in-flight batch."""
        obs = self._obs_multiples.get(sig)
        if not obs:
            return
        nb, eb = sig
        ks = sorted({min(max(int(k), 1), self.capacity) for k in obs})
        if self.capacity not in ks:
            ks.append(self.capacity)
        if len(ks) > self.max_rungs:
            # evenly-spaced quantiles of the observed set, endpoints pinned
            idx = np.linspace(0, len(ks) - 1, self.max_rungs).round().astype(int)
            ks = sorted({ks[i] for i in idx})
        self._ladders[sig] = [
            BucketBudget(n_pad=k * nb, e_pad=k * eb, g_pad=2 * k) for k in ks
        ]
        self._obs_multiples[sig] = []
        if self._mi is not None:
            self._mi.ladder_refits.inc(sig=f"{nb}x{eb}")

    def _observe_flush(self, sig: tuple, bucket: _OpenBucket, dt: float) -> None:
        """Fold one flush into the signature's service-time EWMA (the
        ``svc_alpha`` knob) and (when adaptive) its rung-demand
        histogram, refitting on a full window."""
        prev = self._svc_s.get(sig)
        a = self.svc_alpha
        self._svc_s[sig] = dt if prev is None else (1.0 - a) * prev + a * dt
        if self._mi is not None:
            self._mi.service_ewma.set(self._svc_s[sig],
                                      sig=f"{sig[0]}x{sig[1]}")
        if not self.adapt_ladder:
            return
        nb, eb = sig
        ideal = max(
            -(-bucket.n_used // nb),  # ceil div
            -(-bucket.e_used // eb),
            -(-len(bucket.requests) // 2),
            1,
        )
        window = self._obs_multiples.setdefault(sig, [])
        window.append(min(ideal, self.capacity))
        if len(window) >= self.refit_every:
            self._refit_ladder(sig)

    def _warm_ladder(self, ladder: Sequence[BucketBudget], req: Request) -> None:
        """Warm every rung of a ladder for this request's tenant before it
        can appear in a timed flush.  A minimal dummy graph (1 node, 1
        self-edge, the stream's feature dims) produces the exact padded
        trace signature.  Skipped when the tenant itself has warmed every
        rung (``Executor.has_program`` is per tenant: a captured graph holds
        one tenant's params, where JAX's executable is shared)."""
        model = req.model if req.model is not None else self._default_model
        if all(
            self.executor.has_program(
                ("packed", b.n_pad, b.e_pad, b.g_pad), b.g_pad, model=model
            )
            for b in ladder
        ):
            return
        feat = req.graph[2].shape[1]
        edge = req.graph[3].shape[1] if req.graph[3] is not None else 1
        zero = np.zeros(1, np.int32)
        dummy = (zero, zero, np.zeros((1, feat), np.float32),
                 np.zeros((1, edge), np.float32))
        need_eig = self._needs_eigvec(model)
        tenant = self.executor.tenant(model)
        for budget in ladder:
            prep, _ = pack_prepared(
                [dummy], budget,
                eigvecs=[np.zeros(1, np.float32)] if need_eig else None,
                with_layout=tenant.share_layout, device=self.executor.device,
            )
            self.executor.warm(prep, model=model)

    def prewarm_ladders(self, graphs: Sequence[tuple],
                        models: Optional[Sequence[Optional[str]]] = None) -> int:
        """Warm the full bucket ladder for each representative graph,
        regardless of the prewarm mode — the restart-fast entry point.

        One call per tenant with a typical graph warms (captures) the
        whole ladder before the stream starts.  Idempotent: already-warm
        rungs are skipped.  Returns the number of (tenant, signature)
        ladders touched."""
        if models is None:
            models = [None] * len(graphs)
        seen = set()
        for g, model in zip(graphs, models):
            req = Request(rid=-1, graph=tuple(g)[:4], arrival_s=0.0,
                          model=model)
            key, ladder = self.ladder_for(req)
            if key in seen:
                continue
            seen.add(key)
            if self.prewarm != "eager":  # ladder_for already warmed eager
                self._warm_ladder(ladder, req)
        return len(seen)

    # -------------------------------------------------------------- serving

    def run(self, graphs: Sequence[tuple], qps: float = 0.0,
            models: Optional[Sequence[Optional[str]]] = None,
            priorities: Optional[Sequence[int]] = None,
            arrivals: Optional[Sequence[float]] = None) -> StreamReport:
        """Serve a stream of raw COO graphs and account per-request latency.

        ``qps`` > 0 offers request i at virtual time i/qps after the
        clock's start; ``qps`` <= 0 means the whole stream is already
        queued at the start (offline / saturation mode); ``arrivals``
        scripts explicit non-decreasing arrival timestamps instead (the
        deterministic-simulation input).  ``models`` tags request i with
        a tenant name; ``priorities`` assigns its QoS class (default 0).
        Compute time is the executor's measured timed region; capture and
        warm time is excluded (tracked in the report).
        """
        if models is not None and len(models) != len(graphs):
            raise ValueError(
                f"models ({len(models)}) must tag every graph ({len(graphs)})"
            )
        if priorities is not None and len(priorities) != len(graphs):
            raise ValueError(
                f"priorities ({len(priorities)}) must tag every graph "
                f"({len(graphs)})"
            )
        if (self._default_model is None and len(self.executor.tenants) > 1
                and (models is None or any(m is None for m in models))):
            raise ValueError(
                "untagged requests are ambiguous on a multi-tenant executor: "
                "pass models=[...] naming a registered tenant per graph "
                f"(registered: {sorted(self.executor.tenants)})"
            )
        clock = self.clock if self.clock is not None else VirtualClock()
        t0 = clock.now()
        if arrivals is not None:
            if len(arrivals) != len(graphs):
                raise ValueError(
                    f"arrivals ({len(arrivals)}) must stamp every graph "
                    f"({len(graphs)})"
                )
            arr = [float(a) for a in arrivals]
            if any(b < a for a, b in zip(arr, arr[1:])):
                raise ValueError("arrivals must be non-decreasing")
            if arr and arr[0] < t0:
                raise ValueError(
                    f"first arrival {arr[0]!r} predates the clock ({t0!r})"
                )
        else:
            arr = [t0 + (i / qps if qps > 0 else 0.0) for i in range(len(graphs))]
        requests = []
        for i, g in enumerate(graphs):
            model = models[i] if models is not None else self._default_model
            priority = int(priorities[i]) if priorities is not None else 0
            requests.append(Request(
                rid=i, graph=g[:4], arrival_s=arr[i], model=model,
                priority=priority,
                slo_s=self.resolve_slo_s(model, priority),
            ))
        compile_before = self.executor.untimed_seconds
        tr = self.tracer
        if tr.enabled:
            # span timestamps must share the run's timeline (the tracer
            # may have been built before this run's clock existed)
            tr.clock = clock
        mi = self._mi
        if self._pipeline is not None:
            return self._run_pipelined(requests, clock, t0, compile_before)

        open_buckets: Dict[tuple, _OpenBucket] = {}
        outputs: List[Optional[np.ndarray]] = [None] * len(requests)
        latencies = np.full(len(requests), np.nan)
        shed_list: List[Shed] = []
        flush_log: List[FlushRecord] = []
        device_free_s = t0
        last_done_s = t0
        queued = 0  # admitted-but-unflushed requests, across open buckets
        bucket_seq = 0

        def flush(key: tuple, at_s: float, reason: str) -> None:
            nonlocal device_free_s, last_done_s, queued
            if at_s > clock.now():
                clock.advance_to(at_s)
            bucket = open_buckets.pop(key)
            queued -= len(bucket.requests)
            rung = bucket.rung()
            outs, dt = self._execute(bucket, rung)
            start_s = max(at_s, device_free_s)
            done_s = start_s + dt
            device_free_s = done_s
            last_done_s = max(last_done_s, done_s)
            misses = 0
            for req, out in zip(bucket.requests, outs):
                outputs[req.rid] = out
                latencies[req.rid] = done_s - req.arrival_s
                if done_s > req.deadline_s:
                    misses += 1
            model, priority, sig = key
            flush_log.append(FlushRecord(
                model=model, priority=priority, sig=sig,
                rids=tuple(r.rid for r in bucket.requests), reason=reason,
                at_s=at_s, start_s=start_s, done_s=done_s, compute_s=dt,
                rung_multiple=rung.g_pad // 2, misses=misses,
            ))
            self._observe_flush(sig, bucket, dt)
            if tr.enabled:
                tenant = _tenant_label(model)
                for req in bucket.requests:
                    tr.record("queue", req.arrival_s, at_s, track="scheduler",
                              rid=req.rid, tenant=tenant, priority=priority)
                tr.record("flush", at_s, done_s, track="scheduler",
                          tenant=tenant, priority=priority, reason=reason,
                          graphs=len(bucket.requests), sig=str(sig),
                          rung=rung.g_pad // 2)
                tr.record("device", start_s, done_s, track="device",
                          tenant=tenant, graphs=len(bucket.requests),
                          compute_s=dt)
                for req in bucket.requests:
                    tr.event("respond", t_s=done_s, track="scheduler",
                             rid=req.rid, latency_s=done_s - req.arrival_s,
                             miss=bool(done_s > req.deadline_s))
            if mi is not None:
                tenant = _tenant_label(model)
                pr = str(priority)
                mi.flushes.inc(reason=reason)
                mi.flush_graphs.observe(len(bucket.requests))
                mi.served.inc(len(bucket.requests), tenant=tenant, priority=pr)
                if misses:
                    mi.deadline_misses.inc(misses, tenant=tenant, priority=pr)
                for req in bucket.requests:
                    mi.latency.observe(done_s - req.arrival_s,
                                       tenant=tenant, priority=pr)
                mi.queue_depth.set(queued)
                mi.open_buckets.set(len(open_buckets))

        idx = 0
        while idx < len(requests) or open_buckets:
            next_arrival_s = requests[idx].arrival_s if idx < len(requests) else math.inf
            # a deadline only matters once the device could actually start
            # the batch: while the executor is backlogged, extra waiting is
            # free, so the bucket stays open and late arrivals pack in.
            # Among buckets ready at the same effective instant, the
            # highest-priority class wins the device (then bucket age) —
            # a deterministic total order.
            best_key, best_eff, best_rank = None, math.inf, None
            for k, b in open_buckets.items():
                eff = max(b.deadline_s, device_free_s)
                rank = (eff, b.priority, b.seq)
                if best_rank is None or rank < best_rank:
                    best_key, best_eff, best_rank = k, eff, rank
            if best_key is not None and best_eff <= next_arrival_s:
                # "deadline" while arrivals remain — including one landing
                # at exactly this instant (the expiry wins the tie and the
                # arrival opens a fresh bucket) — "drain" once the offered
                # stream is exhausted.
                flush(best_key, best_eff,
                      "deadline" if idx < len(requests) else "drain")
                continue
            req = requests[idx]
            idx += 1
            clock.advance_to(req.arrival_s)
            now = req.arrival_s
            # ---- SLO-aware admission: shed rather than queue hopelessly.
            # Projected delay = device backlog, plus one service estimate
            # per already-open bucket (admitted work not in device_free_s
            # yet, but each open bucket is one future flush that will
            # occupy the device first), plus the flush this request would
            # ride — already counted when its own bucket is open.
            sig = self.executor.bucket_for(req.n, req.e)
            svc_est = self.service_estimate_s(sig)
            pending = sum(self.service_estimate_s(k[2]) for k in open_buckets)
            own_open = (req.model, req.priority, sig) in open_buckets
            projected = (max(0.0, device_free_s - now) + pending
                         + (0.0 if own_open else svc_est))
            if mi is not None:
                mi.requests.inc(tenant=_tenant_label(req.model),
                                priority=str(req.priority))
            shed_reason = None
            if (math.isfinite(req.slo_s)
                    and projected > req.slo_s * self.admit_margin):
                shed_reason = "backlog"
            elif self.admit_limit is not None and queued >= self.admit_limit:
                shed_reason = "queue_full"
            if shed_reason is not None:
                shed_list.append(Shed(
                    rid=req.rid, model=req.model, priority=req.priority,
                    reason=shed_reason, at_s=now,
                    projected_delay_s=projected, slo_s=req.slo_s,
                ))
                if tr.enabled:
                    tr.event("shed", t_s=now, track="scheduler", rid=req.rid,
                             tenant=_tenant_label(req.model),
                             priority=req.priority, reason=shed_reason,
                             projected_delay_s=projected)
                if mi is not None:
                    mi.shed.inc(tenant=_tenant_label(req.model),
                                priority=str(req.priority),
                                reason=shed_reason)
                continue
            sig, ladder = self.ladder_for(req)
            key = (req.model, req.priority, sig)
            bucket = open_buckets.get(key)
            if bucket is not None and not bucket.admits(req):
                flush(key, now, "budget")
                bucket = None
            if bucket is None:
                bucket = _OpenBucket(ladder, now, self.max_wait_s,
                                     model=req.model, priority=req.priority,
                                     seq=bucket_seq)
                bucket_seq += 1
                open_buckets[key] = bucket
            bucket.add(req, service_est_s=svc_est)
            queued += 1
            if tr.enabled:
                tr.event("admit", t_s=now, track="scheduler", rid=req.rid,
                         tenant=_tenant_label(req.model),
                         priority=req.priority, bucket=str(sig),
                         projected_delay_s=projected)
            if mi is not None:
                mi.admitted.inc(tenant=_tenant_label(req.model),
                                priority=str(req.priority))
                mi.queue_depth.set(queued)
                mi.open_buckets.set(len(open_buckets))
            if bucket.full:
                flush(key, now, "budget")

        if last_done_s > clock.now():
            clock.advance_to(last_done_s)
        if mi is not None:
            mi.queue_depth.set(0)
            mi.open_buckets.set(0)
        return StreamReport(
            latencies_s=latencies,
            outputs=outputs,
            makespan_s=max(last_done_s - (requests[0].arrival_s if requests else t0),
                           1e-12),
            compile_s=self.executor.untimed_seconds - compile_before,
            shed=shed_list,
            flush_log=flush_log,
        )

    # ------------------------------------------------------------- internal

    def _execute(self, bucket: _OpenBucket,
                 rung: Optional[BucketBudget] = None) -> Tuple[List[np.ndarray], float]:
        """Pack one open bucket on its smallest fitting rung and run it
        through the executor for the bucket's tenant.  The pack-time
        payload (padded graph, packed eigenvectors, host-built layout
        plan) is one ``PreparedBatch`` — zero on-device sorts in the
        flushed program."""
        model = bucket.model
        tenant = self.executor.tenant(model)
        raws = [r.graph for r in bucket.requests]
        if rung is None:
            rung = bucket.rung()
        vecs = None
        if self._needs_eigvec(model):
            vecs = [
                np.asarray(self.executor._eigvec(s, r, nf.shape[0], nf.shape[0]))
                for s, r, nf, _ in (g[:4] for g in raws)
            ]
        tr = self.tracer
        with tr.span("pack", track="host", tenant=_tenant_label(model),
                     graphs=len(raws), rung=rung.g_pad // 2):
            prep, meta = pack_prepared(raws, rung, eigvecs=vecs,
                                       with_layout=tenant.share_layout,
                                       device=self.executor.device)
        out, dt = self.executor.run(prep, model=model)
        level = "graph" if tenant.cfg.task == "graph" else "node"
        with tr.span("unpack", track="host", tenant=_tenant_label(model),
                     graphs=len(raws)):
            outs = unpack_outputs(out, meta, level=level)
        return outs, dt

    def _execute_pipelined(self, bucket: _OpenBucket, rung: BucketBudget,
                           measure_host: bool) -> Tuple[List[np.ndarray], float, float]:
        """Pack + run + unpack one bucket for the pipelined loop.

        Unlike the serial ``_execute``, pack/unpack are *not* wrapped in
        live tracer spans: the pipelined loop records them with modeled
        timeline intervals instead (the pack span genuinely overlaps the
        device span there).  With ``measure_host`` the real host-side
        pack seconds (eigvec + ``pack_prepared``, its pinning included)
        are measured through
        the executor's clock — the only real-time source the serving
        stack may read — and returned for timeline folding; otherwise
        the returned pack seconds are 0.0 and the caller's modeled
        ``host_cost`` governs."""
        model = bucket.model
        tenant = self.executor.tenant(model)
        raws = [r.graph for r in bucket.requests]
        t_pack0 = self.executor.clock.now() if measure_host else 0.0
        vecs = None
        if self._needs_eigvec(model):
            vecs = [
                np.asarray(self.executor._eigvec(s, r, nf.shape[0], nf.shape[0]))
                for s, r, nf, _ in (g[:4] for g in raws)
            ]
        prep, meta = pack_prepared(raws, rung, eigvecs=vecs,
                                   with_layout=tenant.share_layout,
                                   device=self.executor.device)
        pack_wall_s = (self.executor.clock.now() - t_pack0
                       if measure_host else 0.0)
        out, dt = self.executor.run(prep, model=model)
        level = "graph" if tenant.cfg.task == "graph" else "node"
        outs = unpack_outputs(out, meta, level=level)
        return outs, dt, pack_wall_s

    def _run_pipelined(self, requests: List[Request], clock: Clock,
                       t0: float, compile_before: float) -> StreamReport:
        """Dispatch-ahead event loop (``pipeline=`` mode).

        Differences from the serial loop, and nothing else:

        * the flush gate replaces ``device_free_s`` with the in-flight
          window: ``eff = max(deadline, slot_free)`` where ``slot_free``
          is the front completion when the window is full and ``-inf``
          while it has room — so a bucket dispatches at its deadline even
          while the device is busy (that is the overlap);
        * each dispatch threads three modeled resources: the single host
          prepare worker (``host_free_s`` — packs serialize), the serial
          device (``device_free_s``), and the window slot.  ``start_s``
          is the dispatch instant (pack done), ``done_s`` the device
          completion;
        * completions are harvested strictly FIFO off the window front —
          the device executes dispatches in order, so front-first harvest
          preserves per-request response order by construction.  Harvest
          finalizes outputs/records/telemetry and never advances the
          clock;
        * admission projects host-pack EWMAs on top of the serial
          device-backlog model (free host cost → bitwise the serial
          projection).

        Single-threaded and deterministic under ``VirtualClock``: the
        engine compute runs synchronously at dispatch (clean per-flush
        ``compute_s``), only its *placement* on the timeline models the
        pipeline.  Live threaded overlap is ``serve.pipeline``'s job.
        """
        cfg = self._pipeline
        inflight = cfg.inflight
        cost_fn = cfg.host_cost_fn()  # None => measure real pack seconds
        tr = self.tracer
        mi = self._mi

        open_buckets: Dict[tuple, _OpenBucket] = {}
        outputs: List[Optional[np.ndarray]] = [None] * len(requests)
        latencies = np.full(len(requests), np.nan)
        shed_list: List[Shed] = []
        flush_log: List[FlushRecord] = []
        window: "deque[_InFlight]" = deque()  # dispatch == completion order
        device_free_s = t0
        host_free_s = t0
        last_done_s = t0
        queued = 0
        bucket_seq = 0
        flush_idx = 0

        def harvest_one() -> None:
            f = window.popleft()
            bucket = f.bucket
            misses = 0
            for req, out in zip(bucket.requests, f.outs):
                outputs[req.rid] = out
                latencies[req.rid] = f.done_s - req.arrival_s
                if f.done_s > req.deadline_s:
                    misses += 1
            model, priority, sig = f.key
            flush_log.append(FlushRecord(
                model=model, priority=priority, sig=sig,
                rids=tuple(r.rid for r in bucket.requests), reason=f.reason,
                at_s=f.at_s, start_s=f.start_s, done_s=f.done_s,
                compute_s=f.compute_s, rung_multiple=f.rung.g_pad // 2,
                misses=misses,
            ))
            if tr.enabled:
                tenant = _tenant_label(model)
                for req in bucket.requests:
                    tr.record("queue", req.arrival_s, f.at_s, track="scheduler",
                              rid=req.rid, tenant=tenant, priority=priority)
                tr.record("flush", f.at_s, f.done_s, track="scheduler",
                          tenant=tenant, priority=priority, reason=f.reason,
                          graphs=len(bucket.requests), sig=str(sig),
                          rung=f.rung.g_pad // 2)
                tr.record("unpack", f.done_s, f.done_s, track="host",
                          tenant=tenant, graphs=len(bucket.requests))
                for req in bucket.requests:
                    tr.event("respond", t_s=f.done_s, track="scheduler",
                             rid=req.rid, latency_s=f.done_s - req.arrival_s,
                             miss=bool(f.done_s > req.deadline_s))
            if mi is not None:
                tenant = _tenant_label(model)
                pr = str(priority)
                mi.flushes.inc(reason=f.reason)
                mi.flush_graphs.observe(len(bucket.requests))
                mi.served.inc(len(bucket.requests), tenant=tenant, priority=pr)
                if misses:
                    mi.deadline_misses.inc(misses, tenant=tenant, priority=pr)
                for req in bucket.requests:
                    mi.latency.observe(f.done_s - req.arrival_s,
                                       tenant=tenant, priority=pr)
                mi.inflight_depth.set(len(window))

        def harvest_due(now_s: float) -> None:
            # completions whose modeled finish predates the instant being
            # processed; harvesting never advances the clock
            while window and window[0].done_s <= now_s:
                harvest_one()

        def dispatch(key: tuple, at_s: float, reason: str) -> None:
            nonlocal device_free_s, host_free_s, last_done_s, queued, flush_idx
            if at_s > clock.now():
                clock.advance_to(at_s)
            harvest_due(at_s)
            bucket = open_buckets.pop(key)
            queued -= len(bucket.requests)
            rung = bucket.rung()
            outs, dt, pack_wall = self._execute_pipelined(
                bucket, rung, measure_host=cost_fn is None)
            # on a mesh every rank folds the slowest rank's pack seconds (one
            # all-reduce a flush), as it does a run's: the ranks' admission,
            # flushes and with them their collectives stay in step
            pack_s = self.executor._slowest(
                pack_wall if cost_fn is None else cost_fn(flush_idx))
            flush_idx += 1
            # one prepare worker: packs serialize behind host_free_s;
            # without overlap the pack also waits for the device to go
            # idle (the serial loop's inline-blocking host, the modeled
            # baseline for speedup claims)
            pack_begin = max(at_s, host_free_s)
            if not cfg.overlap:
                pack_begin = max(pack_begin, device_free_s)
            start_s = pack_begin + pack_s  # dispatch instant
            host_free_s = start_s
            if len(window) >= inflight:
                # a budget flush can land on a full window: the dispatch
                # stalls until the front completion frees its slot
                start_s = max(start_s, window[0].done_s)
                harvest_one()
            begin_s = max(start_s, device_free_s)  # the device is serial
            done_s = begin_s + dt
            device_free_s = done_s
            last_done_s = max(last_done_s, done_s)
            model, priority, sig = key
            self._observe_flush(sig, bucket, dt)
            self._observe_pack(sig, pack_s)
            window.append(_InFlight(
                key=key, bucket=bucket, rung=rung, outs=outs, reason=reason,
                at_s=at_s, start_s=start_s, begin_s=begin_s, done_s=done_s,
                compute_s=dt,
            ))
            if tr.enabled:
                tenant = _tenant_label(model)
                tr.event("dispatch", t_s=start_s, track="scheduler",
                         tenant=tenant, priority=priority, reason=reason,
                         graphs=len(bucket.requests), sig=str(sig),
                         inflight=len(window))
                tr.record("pack", pack_begin, start_s, track="host",
                          tenant=tenant, graphs=len(bucket.requests),
                          rung=rung.g_pad // 2)
                tr.record("device", begin_s, done_s, track="device",
                          tenant=tenant, graphs=len(bucket.requests),
                          compute_s=dt)
            if mi is not None:
                mi.queue_depth.set(queued)
                mi.open_buckets.set(len(open_buckets))
                mi.inflight_depth.set(len(window))

        idx = 0
        while idx < len(requests) or open_buckets:
            next_arrival_s = (requests[idx].arrival_s if idx < len(requests)
                              else math.inf)
            # the dispatch gate: with window room a bucket's deadline
            # alone governs (dispatch-ahead — the device need not be
            # free); a full window makes the front completion the
            # earliest instant a new flush could enter it.  Priority then
            # bucket age break effective-instant ties, same total order
            # as the serial loop.
            slot_free_s = (window[0].done_s if len(window) >= inflight
                           else -math.inf)
            best_key, best_eff, best_rank = None, math.inf, None
            for k, b in open_buckets.items():
                eff = max(b.deadline_s, slot_free_s)
                rank = (eff, b.priority, b.seq)
                if best_rank is None or rank < best_rank:
                    best_key, best_eff, best_rank = k, eff, rank
            if best_key is not None and best_eff <= next_arrival_s:
                dispatch(best_key, best_eff,
                         "deadline" if idx < len(requests) else "drain")
                continue
            req = requests[idx]
            idx += 1
            clock.advance_to(req.arrival_s)
            now = req.arrival_s
            harvest_due(now)
            # ---- admission: the serial projection plus host-pack EWMAs
            # (each open bucket's future flush passes through the single
            # prepare worker before it can occupy the device).  With the
            # default free modeled host cost every pack estimate is 0.0
            # and this is bitwise the serial projection; device_free_s
            # already carries dispatched-ahead flushes.
            sig = self.executor.bucket_for(req.n, req.e)
            svc_est = self.service_estimate_s(sig)
            pending = sum(
                self.service_estimate_s(k[2]) + self.pack_estimate_s(k[2])
                for k in open_buckets)
            own_open = (req.model, req.priority, sig) in open_buckets
            projected = (max(0.0, device_free_s - now) + pending
                         + (0.0 if own_open
                            else svc_est + self.pack_estimate_s(sig)))
            if mi is not None:
                mi.requests.inc(tenant=_tenant_label(req.model),
                                priority=str(req.priority))
            shed_reason = None
            if (math.isfinite(req.slo_s)
                    and projected > req.slo_s * self.admit_margin):
                shed_reason = "backlog"
            elif self.admit_limit is not None and queued >= self.admit_limit:
                shed_reason = "queue_full"
            if shed_reason is not None:
                shed_list.append(Shed(
                    rid=req.rid, model=req.model, priority=req.priority,
                    reason=shed_reason, at_s=now,
                    projected_delay_s=projected, slo_s=req.slo_s,
                ))
                if tr.enabled:
                    tr.event("shed", t_s=now, track="scheduler", rid=req.rid,
                             tenant=_tenant_label(req.model),
                             priority=req.priority, reason=shed_reason,
                             projected_delay_s=projected)
                if mi is not None:
                    mi.shed.inc(tenant=_tenant_label(req.model),
                                priority=str(req.priority),
                                reason=shed_reason)
                continue
            sig, ladder = self.ladder_for(req)
            key = (req.model, req.priority, sig)
            bucket = open_buckets.get(key)
            if bucket is not None and not bucket.admits(req):
                dispatch(key, now, "budget")
                bucket = None
            if bucket is None:
                bucket = _OpenBucket(ladder, now, self.max_wait_s,
                                     model=req.model, priority=req.priority,
                                     seq=bucket_seq)
                bucket_seq += 1
                open_buckets[key] = bucket
            bucket.add(req, service_est_s=svc_est)
            queued += 1
            if tr.enabled:
                tr.event("admit", t_s=now, track="scheduler", rid=req.rid,
                         tenant=_tenant_label(req.model),
                         priority=req.priority, bucket=str(sig),
                         projected_delay_s=projected)
            if mi is not None:
                mi.admitted.inc(tenant=_tenant_label(req.model),
                                priority=str(req.priority))
                mi.queue_depth.set(queued)
                mi.open_buckets.set(len(open_buckets))
            if bucket.full:
                dispatch(key, now, "budget")

        while window:
            harvest_one()
        if last_done_s > clock.now():
            clock.advance_to(last_done_s)
        if mi is not None:
            mi.queue_depth.set(0)
            mi.open_buckets.set(0)
            mi.inflight_depth.set(0)
        return StreamReport(
            latencies_s=latencies,
            outputs=outputs,
            makespan_s=max(last_done_s - (requests[0].arrival_s if requests else t0),
                           1e-12),
            compile_s=self.executor.untimed_seconds - compile_before,
            shed=shed_list,
            flush_log=flush_log,
        )

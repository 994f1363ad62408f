"""The serving executor (reduced port of ``repro.serve.executor``).

    prepare  ->  warm  ->  run

* **prepare** — ``prepare_stream`` / ``prepare_batched`` /
  ``prepare_packed`` pad raw input into a ``PreparedBatch`` on the
  executor's device: padded graph, DGN's eigenvector input when asked
  for (host eigensolve, memoised), optional layout plan (packed batches
  carry their host-built plan), bucket key and warm signature.
* **warm** — every (tenant, program, signature) executes once untimed
  before it may be timed.  On the card that first run builds the CUDA
  kernels (at first use) and sets up the libraries, so neither leaks into
  a reported latency.
* **run** — the one timed region: the forward, ended by
  ``torch.cuda.synchronize()``, then the copy of the result to the host
  (outside the timed region).

Programs are cached by ``(program_key, bucket_key, num_graphs)`` with
``program_key = (cfg, precision, fused)``, so tenants of one
architecture share them.  ``register(precision=...)`` quantizes once
(``quant.apply.quantize_model``, calibrating first for int8-static) on the
parameters as the caller gave them, then moves the quantized tree to the
executor's device; every mode serves the transformed tree.  PyTorch runs eagerly: a program is the
``gnn.models.forward_program`` closure, and there is no compile step.
``torch.compile``, CUDA graphs, the AOT cache, the mesh and telemetry
arrive with later slices.  The executor runs on ``device="cuda"`` unless
the caller asks for the CPU, and raises if CUDA is missing.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core import batching as B
from repro_torch.core import graph as G
from repro_torch.core import layout as LY
from repro_torch.data.pipeline import laplacian_eigvec
from repro_torch.device import resolve_device
from repro_torch.gnn import models as M
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
    stay int8); ``QuantizedLinear`` nodes are rebuilt around moved
    fields."""
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if dataclasses.is_dataclass(params):
        return dataclasses.replace(params, **{
            f.name: _params_to(getattr(params, f.name), device)
            for f in dataclasses.fields(params)})
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_params_to(v, device) for v in params)
    return params


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


def prepared(graph: G.Graph, eigvec, layout, bucket_key: tuple,
             num_graphs: int) -> PreparedBatch:
    return PreparedBatch(graph=graph, eigvec=eigvec, layout=layout,
                         bucket_key=bucket_key, num_graphs=num_graphs,
                         signature=trace_signature(graph, eigvec, layout))


@dataclasses.dataclass
class _Program:
    """Program-cache record: the forward closure plus warm bookkeeping."""

    fn: Callable
    num_graphs: Optional[int]
    warm: Set[tuple] = dataclasses.field(default_factory=set)
    warm_s: float = 0.0


@dataclasses.dataclass
class Tenant:
    """One registered model: config, params (on the executor's device,
    quantized for precisions other than fp32), the quantization report,
    and the derived program key / params signature."""

    name: str
    cfg: M.GNNConfig
    params: dict
    precision: str = "fp32"
    fused: bool = False
    quant_report: object = None
    params_sig: tuple = ()

    @property
    def program_key(self) -> tuple:
        return (self.cfg, self.precision, self.fused)


class Executor:
    """The single program-cache / warm / timing path of the port."""

    def __init__(self, buckets: Sequence[tuple] = DEFAULT_BUCKETS,
                 clock: Optional[Clock] = None, device="cuda"):
        self.device = resolve_device(device)
        self.buckets = sorted(buckets)
        self.clock = clock if clock is not None else RealClock()
        self.tenants: Dict[str, Tenant] = {}
        self._programs: Dict[tuple, _Program] = {}
        self._eigvec_lru: collections.OrderedDict = collections.OrderedDict()

    # ---------------------------------------------------------- tenants

    def register(self, name: str, cfg: M.GNNConfig, params: dict,
                 precision: str = "fp32",
                 calib_graphs: Optional[Sequence[tuple]] = None,
                 fused: bool = False) -> Tenant:
        """Admit a model.  ``precision`` selects the serving arithmetic:
        "fp32", "int8" (dynamic per-node activation scales), "int8-static"
        (calibrated on ``calib_graphs``, raw COO tuples) or "fixed"
        (ap_fixed emulation), each with ``quant.apply.precision_qconfig``'s
        recipe.  Quantization runs once here, on ``params`` where the
        caller keeps them (calibration and transform see the same tree);
        then the params move to the executor's device."""
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
                        fused=fused, quant_report=quant_report,
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
        raise KeyError(f"model name required: tenants {sorted(self.tenants)}")

    @property
    def warm_seconds(self) -> float:
        """Total untimed first-run time across programs (kernel build and
        library set-up included); excluded from every reported latency."""
        return sum(p.warm_s for p in self._programs.values())

    def bucket_for(self, n: int, e: int) -> tuple:
        """Smallest configured (N_pad, E_pad) bucket holding (n, e)."""
        for nb, eb in self.buckets:
            if n <= nb and e <= eb:
                return nb, eb
        raise ValueError(f"graph ({n},{e}) exceeds largest bucket {self.buckets[-1]}")

    def _program(self, tenant: Tenant, bucket_key: tuple,
                 num_graphs: Optional[int]) -> _Program:
        key = (tenant.program_key, bucket_key, num_graphs)
        prog = self._programs.get(key)
        if prog is None:
            fn = M.forward_program(tenant.cfg, num_graphs=num_graphs,
                                   fused=tenant.fused)
            prog = self._programs[key] = _Program(fn=fn, num_graphs=num_graphs)
        return prog

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warm(self, prog: _Program, sig: tuple, tenant: Tenant,
              p: PreparedBatch) -> float:
        """Run ``sig`` once untimed (0.0 when already warm)."""
        if sig in prog.warm:
            return 0.0
        t0 = self.clock.now()
        prog.fn(tenant.params, p.graph, p.eigvec, p.layout)
        self._synchronize()
        dt = self.clock.now() - t0
        prog.warm.add(sig)
        prog.warm_s += dt
        return dt

    # ---------------------------------------------------------- prepare

    def prepare_stream(self, raw: tuple, with_eigvec: bool = False) -> PreparedBatch:
        """One raw COO graph padded into the smallest bucket; no layout
        plan (the forward builds it on the device: one sort)."""
        s, r, nf, ef = raw[:4]
        nb, eb = self.bucket_for(nf.shape[0], len(s))
        g = G.from_numpy(s, r, nf, ef, n_pad=nb, e_pad=eb, device=self.device)
        eig = None
        if with_eigvec:
            eig = torch.as_tensor(self._eigvec(s, r, nf.shape[0], nb),
                                  device=self.device)
        return prepared(g, eig, None, ("stream", nb, eb), 1)

    def prepare_batched(self, chunk: Sequence[tuple], batch_size: int,
                        n_pad: int, e_pad: int,
                        with_eigvec: bool = False) -> PreparedBatch:
        """One fixed-size padded batch of the chunk's raw graphs, with the
        per-graph eigenvectors at the batch's node offsets when asked."""
        gs = [(g[0], g[1], g[2], g[3]) for g in chunk]
        g = G.batch_graphs(gs, n_pad=n_pad, e_pad=e_pad, device=self.device)
        eig = None
        if with_eigvec:
            vec = np.zeros((n_pad,), np.float32)
            off = 0
            for s, r, nf, _ in gs:
                n = nf.shape[0]
                vec[off : off + n] = self._eigvec(s, r, n, n)
                off += n
            eig = torch.as_tensor(vec, device=self.device)
        return prepared(g, eig, None, ("batched", n_pad, e_pad, batch_size),
                        batch_size)

    def prepare_packed(self, packed: G.Graph, budget, eigvec=None,
                       layout=None) -> PreparedBatch:
        """One already-packed batch (``core.batching``), with its packed
        eigenvector (``core.batching.pack_eigvecs``) for DGN; without a
        plan the host plan is built here."""
        if packed.device != self.device:
            raise ValueError(
                f"packed graph is on {packed.device}, executor on {self.device}"
            )
        if eigvec is not None:
            eigvec = torch.as_tensor(eigvec, dtype=torch.float32,
                                     device=self.device)
        if layout is None:
            layout = B.pack_layout(packed)
        return prepared(packed, eigvec, layout,
                        ("packed", budget.n_pad, budget.e_pad, budget.g_pad),
                        budget.g_pad)

    # --------------------------------------------------------- warm/run

    def run(self, p: PreparedBatch,
            model: Optional[str] = None) -> Tuple[np.ndarray, float]:
        """The one timed execution: warm (untimed) first, then time one
        forward that ends at a device synchronise; returns the outputs on
        the host and the seconds."""
        tenant = self.tenant(model)
        prog = self._program(tenant, p.bucket_key, p.num_graphs)
        with torch.inference_mode():
            self._warm(prog, (tenant.params_sig,) + p.signature, tenant, p)
            t0 = self.clock.now()
            out = prog.fn(tenant.params, p.graph, p.eigvec, p.layout)
            self._synchronize()
            dt = self.clock.now() - t0
        return out.cpu().numpy(), dt

    # ------------------------------------------------------------- misc

    _EIGVEC_LRU_SIZE = 128

    def _eigvec(self, s, r, n: int, n_pad: int) -> np.ndarray:
        """DGN's eigenvector input (``data.pipeline.laplacian_eigvec``),
        memoised in a small LRU keyed by (edge lists, n, n_pad): a stream
        revisits graph shapes, and the host eigensolve is the costliest
        prepare stage."""
        s_arr, r_arr = np.ascontiguousarray(s), np.ascontiguousarray(r)
        key = (s_arr.tobytes(), r_arr.tobytes(), int(n), int(n_pad))
        vec = self._eigvec_lru.get(key)
        if vec is not None:
            self._eigvec_lru.move_to_end(key)
            return vec
        vec = laplacian_eigvec(s_arr, r_arr, n, n_pad)
        self._eigvec_lru[key] = vec
        if len(self._eigvec_lru) > self._EIGVEC_LRU_SIZE:
            self._eigvec_lru.popitem(last=False)
        return vec

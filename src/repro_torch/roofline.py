"""Three-term roofline model of the NVIDIA H100 SXM 80GB (port of
``repro.roofline``), from what one rank's step does:

  compute term    = per-device FLOPs / peak FLOP/s of the card
  memory term     = per-device bytes / HBM bandwidth
  collective term = per-device wire bytes (ring-cost model) / link bandwidth

JAX reads FLOPs and bytes from XLA's per-device ``cost_analysis`` and its
collectives from compiled HLO text.  The port runs the step once, on each
rank's local tensors, under three ``TorchDispatchMode`` counters that step
aside for DTensor (so they see the ops a rank runs, never DTensor's
sharding propagation at global shapes):

  * :class:`FlopCounter`: ``torch.utils.flop_counter.flop_registry`` on
    each local op (matmuls, attention, convolutions), and every local op's
    input and output bytes (unfused: an upper bound, as XLA's count on an
    unfused backend);
  * :class:`CollectiveRecorder`: the collectives the rank issues, one
    record each ``(op, result_bytes, group_size, wire_bytes, dtype)`` in
    JAX's form, ``group_size`` the size of the process group the call
    names, with the ring-cost multipliers

      all-gather          bytes x (g-1)/g      (result = gathered size)
      all-reduce          2 x bytes x (g-1)/g  (reduce-scatter + all-gather)
      reduce-scatter      bytes x (g-1)        (result = shard size)
      all-to-all          bytes x (g-1)/g
      collective-permute  bytes   (JAX's; a broadcast is costed so too)

  * :class:`StorageTracker`: the peak of live storage the step allocated.

Hardware model: the H100 SXM 80GB data sheet (dense figures; NVIDIA),
which ``chip_smoke.py`` imports too.  The "model" / "data" axes run within
a node over NVLink 4; the "pod" axis (a multi-pod mesh) runs across nodes
over 400 Gb/s InfiniBand NDR, one NIC a GPU.
"""
from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional

import torch

# H100 SXM 80GB, NVIDIA data sheet, dense (no sparsity)
PEAK_BF16_FLOP_S = 989e12  # bf16 / fp16 on the tensor cores
PEAK_FP32_FLOP_S = 67e12  # fp32 on the CUDA cores
PEAK_INT8_OPS = 1979e12  # int8 on the tensor cores
PEAK_HBM_BYTES_S = 3.35e12  # HBM3
NVLINK_BYTES_S = 450e9  # NVLink 4, one direction (900 GB/s both)
IB_BYTES_S = 50e9  # 400 Gb/s InfiniBand NDR, one NIC a GPU
HBM_CAPACITY_BYTES = 80e9

# JAX's names for the same terms: the bf16 peak, HBM, the link within a
# pod (here a node: NVLink) and across pods (here InfiniBand)
PEAK_FLOPS = PEAK_BF16_FLOP_S
HBM_BW = PEAK_HBM_BYTES_S
ICI_BW = NVLINK_BYTES_S
DCI_BW = IB_BYTES_S

# torch dtypes by their HLO names (the records' ``dtype``, as JAX's)
_HLO_DTYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.float16: "f16", torch.bfloat16: "bf16", torch.int32: "s32",
    torch.float32: "f32", torch.int64: "s64", torch.float64: "f64",
    torch.complex64: "c64", torch.complex128: "c128",
}

# (record op, kind of ``counts``, substrings of the dispatched op's name)
_COLLECTIVES = (
    ("all-reduce", "all_reduce", ("all_reduce", "allreduce")),
    ("all-gather", "all_gather", ("all_gather", "allgather")),
    ("reduce-scatter", "reduce_scatter", ("reduce_scatter",)),
    ("all-to-all", "all_to_all", ("all_to_all", "alltoall")),
    ("broadcast", "broadcast", ("broadcast",)),
)


def wire_bytes(op: str, result_bytes: float, group_size: int) -> float:
    """Per-device bytes on the wire of one collective, by the ring model."""
    g = group_size
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if op == "all-gather":
        return result_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return float(result_bytes) * (g - 1)
    if op == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)  # collective-permute, broadcast


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the stack: it runs an op
    once more at global shapes to learn its output's metadata, which is no
    work of any rank."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class _LocalOps:
    """Base of the counters: a ``TorchDispatchMode`` that lets a DTensor
    op desugar first and observes the local ops it becomes (and every op
    on plain tensors); used as a context manager."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor

                kwargs = kwargs or {}
                if any(t is DTensor or issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                outer.observe(func, args, kwargs, out)
                return out

        self.mode = Mode()

    def observe(self, func, args, kwargs, out) -> None:  # pragma: no cover
        raise NotImplementedError

    def reset(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def __enter__(self):
        self.reset()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _group_size(args) -> int:
    """The size of the process group a collective names (a group name or a
    ``ProcessGroup`` among its arguments; a functional all-gather also
    passes its size)."""
    from torch.distributed import distributed_c10d as c10d

    for a in args:
        if isinstance(a, str):
            try:
                return c10d._resolve_process_group(a).size()
            except Exception:  # noqa: BLE001 - a reduce op's name ("sum"), no group
                continue
        if isinstance(a, torch.ScriptObject):  # a c10d op's boxed ProcessGroup
            from torch.distributed import ProcessGroup

            try:
                return int(ProcessGroup.unbox(a).size())
            except Exception:  # noqa: BLE001 - another script object
                continue
    return 1


class CollectiveRecorder(_LocalOps):
    """Records the collectives a rank issues on its local tensors while
    active (DTensor's redistributions, the optimizer's all-reduces, the
    sharded GNN layer's all-gathers): ``records`` in JAX's form, ``counts``
    {kind: [count, bytes]} with bytes the larger of a call's input and
    output buffers (an all-gather's whole result, a reduce-scatter's whole
    input), as ``CommDebugMode`` counts them.  A record also keeps its
    result's ``shape`` (which tensor was moved: JAX's records have none)."""

    def reset(self) -> None:
        self.records: List[dict] = []
        self.counts: Dict[str, list] = {}

    def observe(self, func, args, kwargs, out) -> None:
        name = str(getattr(func, "_overloadpacket", func))
        if "_autograd" in name or not name.startswith(
                ("_c10d_functional", "c10d", "_dtensor")):
            return
        hit = next(((op, kind) for op, kind, keys in _COLLECTIVES
                    if any(w in name for w in keys)), None)
        if hit is None:
            return
        op, kind = hit
        ins = _tensors(list(args) + list(kwargs.values()))
        # a c10d op that returns only its Work wrote its first argument
        outs = _tensors(out) or _tensors(args[:1])
        result = _nbytes(outs)
        g = _group_size(list(args) + list(kwargs.values()))
        self.records.append({
            "op": op, "result_bytes": result, "group_size": g,
            "wire_bytes": wire_bytes(op, result, g),
            "dtype": _HLO_DTYPE.get(outs[0].dtype, "?") if outs else "?",
            "shape": list(outs[0].shape) if outs else [],
        })
        c = self.counts.setdefault(kind, [0, 0])
        c[0] += 1
        c[1] += max(_nbytes(ins), result)


class FlopCounter(_LocalOps):
    """Per-device FLOPs (``flop_registry`` on each local op) and bytes
    accessed (every local op's inputs and outputs, views excluded), never
    DTensor's propagation pass at global shapes."""

    def reset(self) -> None:
        self.flops = 0
        self.bytes_accessed = 0

    def observe(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        if _in_sharding_propagation():
            return
        packet = getattr(func, "_overloadpacket", None)
        if not getattr(func, "is_view", False):
            self.bytes_accessed += _nbytes(_tensors(list(args) + list(kwargs.values())))
            self.bytes_accessed += _nbytes(_tensors(out))
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))


class StorageTracker(_LocalOps):
    """The peak of live storage bytes the step allocated (each new storage
    once, when an op's output does not share an input's; freed when its
    last tensor goes), on local tensors, real or fake."""

    def reset(self) -> None:
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}

    def _drop(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def observe(self, func, args, kwargs, out) -> None:
        import weakref

        if _in_sharding_propagation():
            return
        # a view or an in-place op hands back an input's storage: no bytes
        ins = {t.untyped_storage()._cdata
               for t in _tensors(list(args) + list(kwargs.values()))}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen or key in ins:
                continue
            n = st.nbytes()
            self._seen[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._drop, key)

    def alive_bytes(self, tensors) -> int:
        """The bytes of those of ``tensors``' storages that this step
        allocated and that are alive now."""
        keys = {t.untyped_storage()._cdata for t in tensors}
        return sum(n for k, n in self._seen.items() if k in keys)


def bf16_normalization_correction(colls: List[dict], model_dtype_bf16: bool) -> List[dict]:
    """JAX halves large f32 collectives of a bf16 model: XLA's CPU backend
    legalizes bf16 by computing, and communicating, in f32, which a TPU
    build does not.  The port's dry-run runs torch's own ops on fake
    tensors, which keep bf16, so it has no such artifact to undo and does
    not call this: its records carry ``collectives_corrected`` equal to
    ``collectives``.  Kept for records made elsewhere (same rule: f32
    payloads over 64 MB halved, marked ``bf16_corrected``)."""
    if not model_dtype_bf16:
        return colls
    corrected = []
    for c in colls:
        c2 = dict(c)
        if c["dtype"] == "f32" and c["result_bytes"] > 64e6:
            c2["wire_bytes"] = c["wire_bytes"] / 2
            c2["bf16_corrected"] = True
        corrected.append(c2)
    return corrected


def summarize_collectives(colls: List[dict]) -> dict:
    summary: Dict[str, dict] = {}
    for c in colls:
        s = summary.setdefault(c["op"], {"count": 0, "wire_bytes": 0.0})
        s["count"] += 1
        s["wire_bytes"] += c["wire_bytes"]
    return summary


def collective_seconds(colls: List[dict], pod_group_size: Optional[int] = None) -> float:
    """Ring-cost seconds; groups of ``pod_group_size`` (the pod axis, across
    nodes) are costed at InfiniBand bandwidth, the rest at NVLink's."""
    t = 0.0
    for c in colls:
        bw = DCI_BW if (pod_group_size and c["group_size"] == pod_group_size) else ICI_BW
        t += c["wire_bytes"] / bw
    return t


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS (6·N·D dense / 6·N_active·D MoE)
# ---------------------------------------------------------------------------


def _visit(params, axes, fn) -> None:
    """``fn(leaf, axes)`` over a parameter tree and its axes tree
    (``models.lm.param_axes``), a None axes subtree for leaves without."""
    if isinstance(params, dict):
        for k in params:
            _visit(params[k], None if axes is None else axes.get(k), fn)
    elif isinstance(params, (list, tuple)) and not isinstance(axes, tuple):
        for i, v in enumerate(params):
            _visit(v, None if axes is None else axes[i], fn)
    else:
        fn(params, tuple(axes or ()))


def active_param_count(params_tree, axes_tree) -> float:
    """Non-embedding parameter count (JAX's: every leaf whose axes name no
    "vocab"), from the leaves' global shapes."""
    total = 0.0

    def visit(leaf, axes):
        nonlocal total
        if "vocab" not in axes:
            total += float(math.prod(leaf.shape))

    _visit(params_tree, axes_tree, visit)
    return total


def model_flops(cfg, params_tree, tokens: float, kind: str, axes_tree=None) -> float:
    """6·N·D for training, 2·N·D for inference, with MoE expert parameters
    scaled to the active fraction (top_k / num_experts); ``axes_tree``
    defaults to ``models.lm.param_axes(cfg)``."""
    if axes_tree is None:
        from repro_torch.models import lm

        axes_tree = lm.param_axes(cfg)
    total = 0.0
    frac = cfg.experts_per_token / cfg.num_experts if cfg.num_experts else 1.0

    def visit(leaf, axes):
        nonlocal total
        if "vocab" in axes:
            return
        size = float(math.prod(leaf.shape))
        if "experts" in axes:
            size *= frac
        total += size

    _visit(params_tree, axes_tree, visit)
    mult = 6.0 if kind == "train" else 2.0
    return mult * total * tokens


# ---------------------------------------------------------------------------
# cell-level roofline
# ---------------------------------------------------------------------------


def cell_roofline(record: dict) -> dict:
    """record: one dry-run JSON record.  Returns the three terms + verdict.

    Two memory estimates, as JAX's:
      * ``memory_s_hlo``: ``bytes_per_device`` (every local op's inputs and
        outputs, unfused) / HBM bandwidth, a loose upper bound;
      * ``memory_s`` (the verdict's): (arguments + outputs + 2 x temps) /
        HBM bandwidth: every argument read once, each output written once,
        each live temporary written and read.
    """
    flops = record["flops_per_device"]
    bytes_hlo = record["bytes_per_device"]
    mem = record.get("memory", {})
    bytes_fused = (
        mem.get("argument_bytes", 0)
        + mem.get("output_bytes", 0)
        + 2 * mem.get("temp_bytes", 0)
    )
    colls = record.get("collectives_corrected") or record["collectives"]
    pod_gs = 2 if record.get("multi_pod") else None
    t_c = flops / PEAK_FLOPS
    t_m_hlo = bytes_hlo / HBM_BW
    t_m = (bytes_fused / HBM_BW) if bytes_fused else t_m_hlo
    t_n = collective_seconds(colls, pod_group_size=pod_gs)
    dominant = max((("compute", t_c), ("memory", t_m), ("collective", t_n)),
                   key=lambda kv: kv[1])
    step_t = max(t_c, t_m, t_n)  # perfectly-overlapped lower bound
    out = {
        "compute_s": t_c,
        "memory_s": t_m,
        "memory_s_hlo": t_m_hlo,
        "collective_s": t_n,
        "bound": dominant[0],
        "step_lower_bound_s": step_t,
        "roofline_fraction": (t_c / step_t) if step_t > 0 else 0.0,
    }
    if record.get("model_flops_per_device"):
        out["useful_flops_ratio"] = record["model_flops_per_device"] / max(flops, 1.0)
    return out

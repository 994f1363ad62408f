"""Where a ``fused_mp`` launch spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.fused_mp_phases [--times] [--fma]

By default builds ``csrc/fused_mp.cu`` with ``-DFUSED_MP_PHASES``: thread 0
of each block records ``%globaltimer`` at the block's phase boundaries.
Launches that library itself (``fused_mp.launch_args`` / ``launch``; the
served wrapper keeps its own library and counts nothing here) for GIN (F
100, H 200) and PNA (F 80, K1 960) in fp32 and int8 at the packed plan's
shapes (128 MolHIV-like graphs in one (4096, 12288) bucket, random operands
from a seeded generator), 20 launches each, and prints for the last launch
the median over its live blocks of each phase (the dead-tile check, the CSR
walk, the tower, the int8 tile, gamma's first product of two, the last
product) and the time from the first block's start to the last block's
end, in microseconds.

``--times`` prints instead the device time (``torch.profiler``, median of
50 calls) of ``ops.fused_mp(..., mode="kernel")`` at the same shapes for
GCN (F 100), GIN and PNA in both precisions.  It uses only the package's
entry points, so it also times another tree's package when run as a file:
``PYTHONPATH=<tree>/src python src/repro_torch/kernels/fused_mp_phases.py
--times``.

``--fma`` runs ``csrc/fma_probe.cu``: the FMAs per clock per SM of the
products' 4 x 4 register tiles (one and two column groups), operands read
from shared memory as ``gemm_f32`` reads them or held in registers, at one
and two blocks of 256 threads per SM, and the SM clock over the launch
(its cycles over its CUDA-event time).

Needs one NVIDIA GPU; exits 1 without one.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import sys

import numpy as np
import torch

from repro_torch.core import batching as B
from repro_torch.core import message_passing as mp
from repro_torch.data.pipeline import MOLHIV, MoleculeStream
from repro_torch.kernels import _build
from repro_torch.kernels import fused_mp as FM
from repro_torch.kernels import ops as kops

DEFINES = ("FUSED_MP_PHASES",)
MARK_BLOCKS = 1024  # csrc/fused_mp.cu
PHASES = ("check", "walk", "tower", "int8_tile", "first_product", "last_product")
SHAPES = (("gin", 100, "fp32"), ("gin", 100, "int8"), ("pna", 80, "fp32"),
          ("pna", 80, "int8"))
TIMED_SHAPES = (("gcn", 100, "fp32"),) + SHAPES
FMA_REPS = 2000  # passes over a 32-deep slice per block


def operands(gen, gamma: str, f: int, precision: str, n: int, e: int, device):
    """(MPSpec, operands) of one layer: glorot-scaled fp32 weights, or int8
    w1 with per-column scales."""
    rnd = lambda *s: torch.randn(s, generator=gen)
    kw = dict(msrc=rnd(n, f), x_res=rnd(n, f))
    if gamma == "gcn":
        spec = mp.MPSpec("copy", ("sum",), "gcn", precision)
        kw["nop"] = rnd(n, 1).abs() + 0.1
        return spec, {k: v.to(device) for k, v in kw.items()}
    h1 = 2 * f if gamma == "gin" else f
    k1 = f if gamma == "gin" else 12 * f
    kw["b1"] = 0.1 * rnd(h1)
    if precision == "int8":
        kw.update(w1=torch.randint(-127, 128, (k1, h1), generator=gen, dtype=torch.int8),
                  w1_scale=torch.rand((h1,), generator=gen) * 9e-3 + 1e-3)
    else:
        kw["w1"] = rnd(k1, h1) * (2.0 / (k1 + h1)) ** 0.5
    if gamma == "gin":
        spec = mp.MPSpec("add_relu", ("sum",), "gin", precision)
        kw.update(eop=rnd(e, f), w2=rnd(h1, f) * (2.0 / (h1 + f)) ** 0.5,
                  b2=0.1 * rnd(f))
    else:
        spec = mp.MPSpec("copy", ("sum", "sqsum", "max", "min"), "pna", precision)
        kw["nop"] = rnd(n, 3).abs() + 0.5
    return spec, {k: v.to(device) for k, v in kw.items()}


def phase_us(marks: np.ndarray) -> dict:
    """Medians over the live blocks (those that reached the end) of each
    phase, and first start to last end, in microseconds."""
    t = marks.astype(np.int64)
    live = t[:, 6] > 0
    t = t[live]
    d = np.diff(t[:, :7], axis=1) / 1e3
    out = {name: float(np.median(d[:, i])) for i, name in enumerate(PHASES)}
    out["live_blocks"] = int(live.sum())
    out["first_start_to_last_end"] = float((t[:, 6].max() - t[:, 0].min()) / 1e3)
    return out


def device_us(fn, reps: int = 50) -> float:
    """Median device time of one call of ``fn`` in microseconds, from the
    CUDA records of ``torch.profiler`` over ``reps`` calls; when the
    profiler drops records (it can drop one of a session's), the mean per
    call over those it kept."""
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
        raise RuntimeError("the profiler recorded no device activity")
    per_call = max(1, round(len(durs) / reps))
    if len(durs) != per_call * reps:
        return sum(durs) * per_call / len(durs)
    return statistics.median(sum(durs[i * per_call:(i + 1) * per_call])
                             for i in range(reps))


def phases(packed, lay, gen, device) -> None:
    n, e = packed.num_nodes, packed.num_edges
    signatures = dict(FM._SIGNATURES, fused_mp_read_marks=(ctypes.c_int, (ctypes.c_void_p,)))
    lib = _build.load("fused_mp", signatures, DEFINES)
    marks = np.zeros((MARK_BLOCKS, 8), np.uint64)
    for gamma, f, precision in SHAPES:
        spec, kw = operands(gen, gamma, f, precision, n, e, device)
        out, _, args = FM.launch_args(spec, lay.offsets, lay.src_sorted, lay.in_degree,
                                      packed.node_mask, **kw)
        for _ in range(20):
            FM.launch(lib, out, args)
        torch.cuda.synchronize()
        marks[:] = 0
        if lib.fused_mp_read_marks(marks.ctypes.data) != 0:
            raise RuntimeError("fused_mp_read_marks failed")
        rows = FM.rows_for(f, len(spec.ops), f if gamma == "gin" else 12 * f,
                           2 * f if gamma == "gin" else 0, precision == "int8")
        tiles = -(-n // rows)
        res = dict(gamma=gamma, f=f, precision=precision, rows=rows,
                   **phase_us(marks[:min(tiles, MARK_BLOCKS)]))
        print(json.dumps({k: round(v, 3) if isinstance(v, float) else v
                          for k, v in res.items()}))


def times(packed, lay, gen, device) -> None:
    n, e = packed.num_nodes, packed.num_edges
    for gamma, f, precision in TIMED_SHAPES:
        spec, kw = operands(gen, gamma, f, precision, n, e, device)
        args = (spec, lay.ids_sorted, lay.offsets, lay.src_sorted, lay.in_degree,
                packed.node_mask)
        us = device_us(lambda: kops.fused_mp(*args, mode="kernel", **kw))
        print(json.dumps(dict(gamma=gamma, f=f, precision=precision, us=round(us, 3))))


def fma(device) -> None:
    lib = _build.load("fma_probe", {"fma_probe_launch": (
        ctypes.c_int, (ctypes.c_int,) * 4 + (ctypes.c_void_p,) * 2)})
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for g in (1, 2):
        for per_sm in (1, 2):
            for smem in (1, 0):
                blocks = sms * per_sm
                out = torch.empty(blocks * 256, device=device)
                cycles = torch.zeros(blocks, dtype=torch.int64, device=device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                for _ in range(2):  # the first launch warms up
                    start.record()
                    err = lib.fma_probe_launch(g, smem, blocks, FMA_REPS, out.data_ptr(),
                                               cycles.data_ptr())
                    end.record()
                    if err != 0:
                        raise RuntimeError(f"fma_probe launch failed: cudaError_t {err}")
                torch.cuda.synchronize()
                fmas = per_sm * 256 * FMA_REPS * 32 * 16 * g  # per SM
                clk = float(cycles.max())
                print(json.dumps(dict(columns=128 * g, warps_per_sm=8 * per_sm,
                                      operands="shared" if smem else "registers",
                                      fma_per_clk_per_sm=round(fmas / clk, 2),
                                      sm_ghz=round(clk / (start.elapsed_time(end) * 1e6), 3))))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("fused_mp_phases: CUDA is not available; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    if "--fma" in argv:
        fma(device)
        return 0
    graphs = [g[:4] for g in MoleculeStream(MOLHIV, seed=0).take(128)]
    packed, _ = B.pack_graphs(graphs, B.BucketBudget(4096, 12288, 128), device=device)
    lay = B.pack_layout(packed)
    gen = torch.Generator().manual_seed(5)
    (times if "--times" in argv else phases)(packed, lay, gen, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where a ``quant_node_mlp`` launch spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.quant_mlp_phases

Builds ``csrc/quant_mlp.cu`` with ``-DQUANT_MLP_PHASES``: thread 0 of each
block records ``%globaltimer`` at the block's phase boundaries.  Launches
that library itself (the served wrapper keeps its own library and counts
nothing here) for both entries at the packed GIN int8 path's shapes,
(4096, 9 -> 100) and (4096, 100 -> 200, relu), on random operands from a
seeded generator, 20 launches each, and prints for the last launch the
median over its blocks of each phase (issuing the block's copies, waiting
for x, putting x in the tile, waiting for w, the products, the tail and
its stores) and the time from the first block's start to the last block's
end, in microseconds; beside them the served kernel's device time
(``torch.profiler``, median of 50 calls).

Needs one NVIDIA GPU; exits 1 without one.
"""
from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quant_mlp as QM
from repro_torch.kernels.fused_mp_phases import device_us
from repro_torch.kernels.node_mlp import ACTIVATION_CODES

DEFINES = ("QUANT_MLP_PHASES",)
MARK_BLOCKS = 4096  # csrc/quant_mlp.cu
PHASES = ("issue", "x_in_tile", "operands_landed", "products", "tail_and_stores")
SHAPES = ((4096, 9, 100, "none"), (4096, 100, 200, "relu"))


def phase_us(marks: np.ndarray) -> dict:
    """Medians over the blocks of each phase (marks 0 .. 5 of
    ``csrc/quant_mlp.cu``), and first start to last end, in
    microseconds."""
    t = marks[:, :6].astype(np.int64)
    d = np.diff(t, axis=1) / 1e3
    out = {name: float(np.median(d[:, i])) for i, name in enumerate(PHASES)}
    out["first_start_to_last_end"] = float((t[:, 5].max() - t[:, 0].min()) / 1e3)
    return out


def operands(gen, m: int, k: int, n: int, device):
    """x (fp32, rows at ranges 1e-3 .. 1e2), x_q, w_q, per-column scales,
    per-row scales and a bias."""
    x = torch.randn((m, k), generator=gen) * 10.0 ** (5 * torch.rand((m, 1), generator=gen) - 3)
    x_q = torch.randint(-128, 128, (m, k), generator=gen, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    scale = torch.rand((n,), generator=gen) * 9e-3 + 1e-3
    rs = torch.rand((m, 1), generator=gen) * 0.1 + 1e-3
    b = 0.1 * torch.randn((n,), generator=gen)
    return [t.to(device) for t in (x, x_q, w_q, scale, rs, b)]


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("quant_mlp_phases: CUDA is not available; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    signatures = dict(QM._SIGNATURES,
                      quant_mlp_read_marks=(ctypes.c_int, (ctypes.c_void_p,)))
    lib = _build.load("quant_mlp", signatures, DEFINES)
    marks = np.zeros((MARK_BLOCKS, 8), np.uint64)
    gen = torch.Generator().manual_seed(19)
    stream = torch.cuda.current_stream(device).cuda_stream
    for m, k, n, act in SHAPES:
        x, x_q, w_q, scale, rs, b = operands(gen, m, k, n, device)
        y = torch.empty((m, n), device=device)
        code = ACTIVATION_CODES[act]
        entries = {
            "static": (lambda: lib.quant_mlp_i8(
                x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(), rs.data_ptr(),
                b.data_ptr(), y.data_ptr(), m, k, n, code, stream),
                lambda: kops.quant_node_mlp(x_q, w_q, scale, b, act, row_scale=rs,
                                            mode="kernel")),
            "dynamic": (lambda: lib.quant_mlp_dyn_f32(
                x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), b.data_ptr(),
                y.data_ptr(), m, k, n, code, stream),
                lambda: kops.quant_node_mlp_dynamic(x, w_q, scale, b, act, mode="kernel")),
        }
        for entry, (marked, served) in entries.items():
            for _ in range(20):
                if marked() != 0:
                    raise RuntimeError(f"quant_mlp ({entry} entry) launch failed")
            torch.cuda.synchronize()
            marks[:] = 0
            if lib.quant_mlp_read_marks(marks.ctypes.data) != 0:
                raise RuntimeError("quant_mlp_read_marks failed")
            res = dict(entry=entry, shape=[m, k, n, act], blocks=QM.blocks(m, n),
                       **phase_us(marks[:min(QM.blocks(m, n), MARK_BLOCKS)]),
                       served_us=device_us(served))
            print(json.dumps({k: round(v, 3) if isinstance(v, float) else v
                              for k, v in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

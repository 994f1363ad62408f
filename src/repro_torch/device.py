"""Device resolution shared by every entry point.

Entry points default to ``device="cuda"``.  Nothing quietly runs on the
CPU: without a card they raise, unless the caller passed ``device="cpu"``.
"""
from __future__ import annotations

import sys

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` (a bare ``"cuda"`` gets the
    current device's index, as tensors placed there report it); raises if
    it names CUDA and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_or_exit(device, prog: str) -> torch.device:
    """:func:`resolve_device` for a script's ``--device`` flag: without a
    card and without ``--device cpu`` the script exits 1 with a message
    (no silent fallback to the CPU)."""
    try:
        return resolve_device(device)
    except RuntimeError:
        print(f"{prog}: CUDA is not available; this needs an NVIDIA GPU, or "
              "--device cpu for the plain PyTorch path", file=sys.stderr)
        raise SystemExit(1) from None

"""Device resolution shared by every entry point.

Entry points default to ``device="cuda"``.  Nothing quietly runs on the
CPU: without a card they raise, unless the caller passed ``device="cpu"``.
"""
from __future__ import annotations

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

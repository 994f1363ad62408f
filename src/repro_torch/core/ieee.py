"""Correctly rounded fp32 operations on every device.

The int8 recipe rounds ``t / rs`` to an integer, so one ulp in ``rs`` or in
the tensor ``t`` it is computed from can move a value across a rounding
boundary.  The CUDA kernels, XLA and numpy compute these operations as
IEEE-754 says; two PyTorch paths do not, and the plain versions use the
helpers here instead:

  * on CUDA, a division by a Python scalar is computed as a multiplication
    by the scalar's reciprocal (which may be one ulp off);
  * on the CPU, the vectorised ``torch.sqrt`` of float32 may be one ulp off.
"""
from __future__ import annotations

import torch

# 0-d divisors by (device, dtype, value): made once, so a division adds no
# fill or host-to-device copy per call
_DIVISORS: dict = {}


def div_rn(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE division: the divisor is a 0-d tensor on ``x``'s
    device, which PyTorch divides by as such (only a Python or CPU scalar
    divisor of a CUDA tensor becomes a reciprocal multiply)."""
    key = (x.device, x.dtype, float(d))
    divisor = _DIVISORS.get(key)
    if divisor is None:
        divisor = _DIVISORS[key] = torch.tensor(float(d), dtype=x.dtype,
                                                device=x.device)
    return x / divisor


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of float32 ``x``: the root of the exact
    double, rounded once to float."""
    return torch.sqrt(x.double()).float()

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
    double, rounded once to float.  Where a gradient is needed it is
    ``g * (0.5 / root)`` (JAX's rule) where the root is positive and 0 at a
    root of 0 (:class:`_SqrtRN`), where ``jnp.sqrt`` gives an infinite
    derivative: a standard deviation over equal values (PNA's ``std`` of a
    node of degree 0 or 1) then passes no NaN back."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SqrtRN.apply(x)
    return torch.sqrt(x.double()).float()


class _SqrtRN(torch.autograd.Function):
    """:func:`sqrt_rn` with a gradient that is 0 at a root of 0."""

    @staticmethod
    def forward(ctx, x):
        root = torch.sqrt(x.double()).float()
        ctx.save_for_backward(root)
        return root

    @staticmethod
    def backward(ctx, g):
        (root,) = ctx.saved_tensors
        return torch.where(root > 0, g * (0.5 / root), torch.zeros_like(g))

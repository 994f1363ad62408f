"""Gradient compression: int8 quantization with error feedback (port of
``repro.optim.compression``).

  * ``quantize`` / ``dequantize``: per-tensor symmetric int8 with an fp32
    scale, the payload JAX's bit for bit (``torch.round`` rounds half to
    even, as ``jnp.round`` does; the divisions are IEEE ones on the card
    too, ``core.ieee.div_rn``);
  * ``ef_compress``: the error-feedback wrapper, which carries each
    tensor's quantization residual to the next step;
  * ``compressed_psum``: the int8 all-reduce over the ranks of a process
    group (JAX's, over a mesh axis inside ``shard_map``): one MAX
    all-reduce of the scale, the int8 payload requantized against it,
    one int32 SUM all-reduce, one dequantize.  The training loop does not
    call it yet: its mesh branch is ROADMAP queue 1, item 11, part 2.
"""
from __future__ import annotations

import torch

from repro_torch.core.ieee import div_rn
from repro_torch.optim.adamw import tree_map


def quantize(x: torch.Tensor) -> tuple:
    """x (fp32 / bf16) -> (int8 payload, fp32 0-d scale)."""
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    scale = div_rn(torch.clamp(amax, min=1e-12), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(grads, error_buf):
    """Error-feedback int8 compression of a gradient tree.  Returns (the
    grads compressed then decompressed, in their dtypes; the new error
    buffer, fp32)."""

    residuals = []

    def one(g, e):
        corrected = g.float() + e
        deq = dequantize(*quantize(corrected))
        residuals.append(corrected - deq)
        return deq.to(g.dtype)

    out = tree_map(one, grads, error_buf)
    it = iter(residuals)  # tree_map visits the leaves in one order
    return out, tree_map(lambda _: next(it), grads)


def init_error_buf(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-compressed sum of ``x`` over the ranks of ``group`` (the
    default group when None).  Every rank quantizes against the largest
    rank's scale, so the int32 sum (no overflow below 2^23 ranks) is
    coherent and dequantizes once."""
    import torch.distributed as dist

    from repro_torch.runtime import partitioning as PT

    p = PT._resolve_num_shards(None, group)
    _, scale = quantize(x)
    scale_max = PT.all_reduce(scale, group, p, op=dist.ReduceOp.MAX)
    q = torch.clamp(torch.round(x.float() / scale_max), -127, 127).to(torch.int8)
    total = PT.all_reduce(q.to(torch.int32), group, p)
    return total.float() * scale_max

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
    one int32 SUM all-reduce, one dequantize.  The training step does not
    call it, as JAX's does not: a mesh's step compresses with
    ``ef_compress`` on the sharded gradients.
"""
from __future__ import annotations

import torch

from repro_torch.core.ieee import div_rn
from repro_torch.optim.adamw import is_dtensor, leaves, tree_map


def quantize(x: torch.Tensor, amax: torch.Tensor | None = None) -> tuple:
    """x (fp32 / bf16) -> (int8 payload, fp32 0-d scale); ``amax`` (a block
    of a larger tensor: that tensor's max |x|) defaults to x's own."""
    xf = x.float()
    if amax is None:
        amax = torch.max(torch.abs(xf))
    scale = div_rn(torch.clamp(amax, min=1e-12), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(grads, error_buf):
    """Error-feedback int8 compression of a gradient tree.  Returns (the
    grads compressed then decompressed, in their dtypes; the new error
    buffer, fp32).

    DTensor gradients (a mesh's step; the error buffer has their
    placements) are compressed on each rank's own block against the
    global ``amax`` of each tensor, as JAX's ``jnp.max`` over a global
    array: the blocks' maxima of every leaf go through one MAX all-reduce
    of the whole tree."""
    if any(is_dtensor(g) for g in leaves(grads)):
        return _ef_compress_sharded(grads, error_buf)
    residuals = []

    def one(g, e):
        corrected = g.float() + e
        deq = dequantize(*quantize(corrected))
        residuals.append(corrected - deq)
        return deq.to(g.dtype)

    out = tree_map(one, grads, error_buf)
    it = iter(residuals)  # tree_map visits the leaves in one order
    return out, tree_map(lambda _: next(it), grads)


def _ef_compress_sharded(grads, error_buf):
    from torch.distributed.tensor import DTensor

    from repro_torch.runtime.partitioning import reduce_over_world

    gs, es = leaves(grads), leaves(error_buf)
    local = lambda t: t.to_local() if is_dtensor(t) else t
    corrected = [local(g).float() + local(e) for g, e in zip(gs, es)]
    amax = reduce_over_world(torch.stack([torch.max(torch.abs(c)) for c in corrected]),
                             "max")
    outs, res = [], []
    for g, c, a in zip(gs, corrected, amax.unbind(0)):
        deq = dequantize(*quantize(c, amax=a))
        wrap = ((lambda t, g=g: DTensor.from_local(t, g.device_mesh, g.placements,
                                                  run_check=False, shape=g.shape,
                                                  stride=g.stride()))
                if is_dtensor(g) else (lambda t: t))
        outs.append(wrap(deq.to(g.dtype)))
        res.append(wrap(c - deq))
    it_o, it_r = iter(outs), iter(res)
    return tree_map(lambda _: next(it_o), grads), tree_map(lambda _: next(it_r), grads)


def init_error_buf(grads):
    """Zero fp32 buffers of the leaves' shapes (a DTensor leaf's: with its
    placements)."""
    return tree_map(lambda g: (torch.zeros_like(g, dtype=torch.float32) if is_dtensor(g)
                               else torch.zeros(g.shape, dtype=torch.float32,
                                                device=g.device)), grads)


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

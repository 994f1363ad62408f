"""Parameter initialisers of the LM substrate (port of ``repro.params``).

Plain tensors: the JAX package's logical-axes ``Param`` wrapper carries
its axes on each leaf; the port keeps them in a tree beside the
parameters (``models.lm.param_axes``), which ``runtime.partitioning``'s
``tree_specs`` / ``tree_shardings`` and the checkpoint manager's elastic
restore resolve on a mesh; ``runtime.place_tree`` places a tree by them
for the train loop's mesh branch (JAX serves no LM on a mesh, and neither
does the port).  Random values
come from an explicit ``torch.Generator`` and land on its device.
``init_normal`` keeps JAX's scale rule, ``(1 / shape[0]) ** 0.5`` of the
per-layer shape; ``stack`` prepends a group axis (``(G, *shape)``, the
layout of ``models.transformer.stack_init``) without changing that scale.

Inside ``casting(dtype)`` every leaf the three helpers make with two or
more dimensions (stack included) is cast to ``dtype`` as soon as it is
made: a model's init then holds at most one fp32 leaf at a time
(InternVL2-26B's stacked SwiGLU ``wi``, 38.7 GB in fp32, beside the bf16
leaves drawn before it), and on the card each fp32 draw's memory goes
back to the device once it is cast.  The cast rounds the fp32 draw, so
the values are those of drawing everything in fp32 and casting
afterwards.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_CAST: contextvars.ContextVar = contextvars.ContextVar("repro_torch_param_cast",
                                                       default=None)


@contextlib.contextmanager
def casting(dtype: torch.dtype):
    """Within the block, cast each new leaf of two or more dimensions to
    ``dtype`` (JAX's rule: norms and other vectors stay fp32)."""
    token = _CAST.set(dtype)
    try:
        yield
    finally:
        _CAST.reset(token)


def cast_leaf(t: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``t`` in ``dtype`` (default: the enclosing ``casting``'s) if it has two
    or more dimensions, else ``t``."""
    dtype = dtype if dtype is not None else _CAST.get()
    return t.to(dtype) if dtype is not None and t.dim() >= 2 else t


def init_normal(gen: torch.Generator, shape, scale=None, stack=(),
                dtype=torch.float32) -> torch.Tensor:
    scale = scale if scale is not None else (1.0 / max(shape[0], 1)) ** 0.5
    t = torch.randn(tuple(stack) + tuple(shape), generator=gen, device=gen.device,
                    dtype=dtype)
    out = cast_leaf(t.mul_(scale))
    if out is not t and t.is_cuda:
        # give the draw's memory back to the card: kept in the allocator's
        # cache, its segment would hold the next leaves' casts, and the
        # free rest of it (InternVL2-26B: ~29 GB of the 38.7 GB fp32 wi's)
        # could not be released or used by another stream
        del t
        torch.cuda.empty_cache()
    return out


def init_ones(shape, stack=(), dtype=torch.float32, device="cpu") -> torch.Tensor:
    return cast_leaf(torch.ones(tuple(stack) + tuple(shape), dtype=dtype, device=device))


def init_zeros(shape, stack=(), dtype=torch.float32, device="cpu") -> torch.Tensor:
    return cast_leaf(torch.zeros(tuple(stack) + tuple(shape), dtype=dtype, device=device))

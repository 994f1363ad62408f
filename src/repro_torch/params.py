"""Parameter initialisers of the LM substrate (port of ``repro.params``).

Plain tensors: the JAX package's logical-axes ``Param`` wrapper serves the
mesh's sharding rules, which the port does not have yet.  Random values
come from an explicit ``torch.Generator`` and land on its device.
``init_normal`` keeps JAX's scale rule, ``(1 / shape[0]) ** 0.5`` of the
per-layer shape; ``stack`` prepends a group axis (``(G, *shape)``, the
layout of ``models.transformer.stack_init``) without changing that scale.
"""
from __future__ import annotations

import torch


def init_normal(gen: torch.Generator, shape, scale=None, stack=(),
                dtype=torch.float32) -> torch.Tensor:
    scale = scale if scale is not None else (1.0 / max(shape[0], 1)) ** 0.5
    return torch.randn(tuple(stack) + tuple(shape), generator=gen,
                       device=gen.device, dtype=dtype) * scale


def init_ones(shape, stack=(), dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.ones(tuple(stack) + tuple(shape), dtype=dtype, device=device)


def init_zeros(shape, stack=(), dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.zeros(tuple(stack) + tuple(shape), dtype=dtype, device=device)

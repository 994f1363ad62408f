"""AdamW with global-norm clipping and a warmup-cosine schedule (port of
``repro.optim.adamw``).

JAX's own AdamW on the port's value tree (nested dicts / lists of
tensors): the state is {"m", "v", "step"}, m and v fp32 trees of the
parameters' shapes and ``step`` a 0-d int32 tensor.  The update runs in
fp32 and is cast to each parameter's dtype; weight decay is decoupled and
applies only to leaves of two or more dimensions.  ``torch.optim.AdamW``
is not used: it decays every parameter, and keeps bf16 moments for bf16
parameters.

Every number stays on the parameters' device (the step, the schedule,
the norm), so an update reads nothing back to the host; a division by a
number is an IEEE division on the card too (``core.ieee.div_rn``).  ``update``
writes the new parameters and moments into the given tensors (JAX donates
them to its jitted step) and works through a large leaf a slice at a
time, so its fp32 temporaries stay within ``CHUNK`` elements each; the
arithmetic per element is JAX's, in its order.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.ieee import div_rn

CHUNK = 1 << 26  # elements of a leaf updated at a time


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def leaves(tree) -> list:
    """The tensors of a tree of dicts / lists, in JAX's order (sorted dict
    keys)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``),
    keeping the structure; the leaves are visited in :func:`leaves`' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine decay to ``min_lr_ratio * lr``
    at ``total_steps``; fp32, on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(div_rn(step, max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp(div_rn(step - cfg.warmup_steps,
                              max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(params) -> dict:
    """Zero fp32 moments of the parameters' shapes; a DTensor parameter's
    moments are DTensors with its placements (JAX's ``init`` on sharded
    values)."""
    zeros = lambda p: (torch.zeros_like(p, dtype=torch.float32) if is_dtensor(p) else
                       torch.zeros(p.shape, dtype=torch.float32, device=p.device))
    first = leaves(params)
    device = first[0].device if first else "cpu"
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares, the
    leaves added in JAX's order.  DTensor leaves (Shard / Replicate) give
    the norm over every shard: each block's sum of squares is counted once
    (by the ranks at coordinate 0 of the mesh dims that replicate it), the
    blocks summed by one all-reduce for the whole tree; the result is a
    plain 0-d tensor."""
    xs = leaves(tree)
    if not any(is_dtensor(x) for x in xs):
        total = 0
        for x in xs:
            total = total + torch.sum(torch.square(x.float()))
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
    from repro_torch.runtime.partitioning import reduce_over_world

    parts = []
    for x in xs:
        local = x.to_local() if is_dtensor(x) else x
        sq = torch.sum(torch.square(local.float()))
        if is_dtensor(x) and not _first_replica(x):
            sq = torch.zeros_like(sq)
        parts.append(sq)
    parts = reduce_over_world(torch.stack(parts)).unbind(0)
    total = 0
    for sq in parts:
        total = total + sq
    return torch.sqrt(total)


def _first_replica(x) -> bool:
    """Whether this rank holds the first copy of its block of DTensor ``x``:
    coordinate 0 on every mesh dim that does not cut it."""
    mesh = x.device_mesh
    return all(pl.is_shard() or mesh.get_local_rank(i) == 0
               for i, pl in enumerate(x.placements))


def like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` (a gradient) with the placements of the DTensor ``ref`` (its
    parameter): a partial sum is reduced, a whole value cut; ``t`` itself
    when ``ref`` is a plain tensor."""
    if not is_dtensor(ref) or tuple(t.placements) == tuple(ref.placements):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: dict, params):
    """Returns (new_params, new_state, {"grad_norm", "lr"}).  The new
    parameters and moments are ``params``' and ``state``'s own tensors,
    written in place; ``step`` is a new tensor.  DTensor parameters take
    each gradient at their own placements (:func:`like`) and are updated
    on each rank's own block, with the global norm over every shard."""
    grads = tree_map(like, grads, params)
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.full((), cfg.grad_clip, dtype=torch.float32, device=gnorm.device)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        decay = p.dim() >= 2
        if is_dtensor(p):  # the same placements: each rank its own block
            p, g, m, v = (t.to_local() for t in (p, g, m, v))
        pf, mf, vf = (t.view(-1) for t in (p, m, v))
        gf = g.reshape(-1)
        for a in range(0, pf.numel(), CHUNK):
            sl = slice(a, a + CHUNK)
            gc = gf[sl].float() * scale
            mc = mf[sl].mul_(b1).add_((1 - b1) * gc)
            vc = vf[sl].mul_(b2).add_((1 - b2) * gc * gc)
            delta = (mc / bc1) / (torch.sqrt(vc / bc2) + cfg.eps)
            if decay:  # decoupled weight decay on matrices only
                delta = delta + cfg.weight_decay * pf[sl].float()
            pf[sl] = (pf[sl].float() - lr * delta).to(p.dtype)
    return params, {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr}

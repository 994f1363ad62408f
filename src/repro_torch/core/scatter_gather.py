"""Sort-based segment scatter-gather, PyTorch port of
``repro.core.scatter_gather``.

JAX segment ops silently drop ids outside ``[0, num_segments)``;
``index_add_`` / ``scatter_reduce_`` raise on them.  Every reduction here
therefore routes such ids to a sink row ``num_segments`` and slices it off,
which reproduces the JAX semantics (padding edges and padded nodes carry
out-of-range ids by design).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.ieee import sqrt_rn

REDUCTIONS = ("sum", "mean", "max", "min", "var", "std", "sqsum")


def _sink_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 ids with every out-of-range id sent to the sink row."""
    ids = segment_ids.long()
    valid = (ids >= 0) & (ids < num_segments)
    return torch.where(valid, ids, torch.full_like(ids, num_segments))


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: (E, ...) -> (num_segments, ...)."""
    ids = _sink_ids(segment_ids, num_segments)
    out = values.new_zeros((num_segments + 1,) + tuple(values.shape[1:]))
    return out.index_add_(0, ids, values)[:-1]


def _segment_extremum(values: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int, op: str) -> torch.Tensor:
    """``jax.ops.segment_max`` / ``segment_min``: empty rows hold -inf / +inf."""
    ids = _sink_ids(segment_ids, num_segments)
    fill = float("-inf") if op == "max" else float("inf")
    out = values.new_full((num_segments + 1,) + tuple(values.shape[1:]), fill)
    index = ids.view(-1, *([1] * (values.dim() - 1))).expand_as(values)
    reduce = "amax" if op == "max" else "amin"
    return out.scatter_reduce_(0, index, values, reduce, include_self=True)[:-1]


def segment_reduce(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    op: str = "sum",
) -> torch.Tensor:
    """Permutation-invariant segment reduction (the A(.) of §3.3).

    values: (E, F); segment_ids: (E,) int, sorted or not; returns
    (num_segments, F).  Empty segments yield 0 for every op.
    """
    if op not in REDUCTIONS:
        raise ValueError(f"unknown reduction {op!r}; expected one of {REDUCTIONS}")
    if op == "sum":
        return segment_sum(values, segment_ids, num_segments)
    if op == "sqsum":
        return segment_sum(values * values, segment_ids, num_segments)
    count = segment_sum(torch.ones_like(values[..., :1]), segment_ids, num_segments)
    if op == "mean":
        total = segment_sum(values, segment_ids, num_segments)
        return total / torch.clamp(count, min=1.0)
    if op in ("var", "std"):
        total = segment_sum(values, segment_ids, num_segments)
        sq = segment_sum(values * values, segment_ids, num_segments)
        c = torch.clamp(count, min=1.0)
        mean = total / c
        var = torch.clamp(sq / c - mean * mean, min=0.0)
        return sqrt_rn(var) if op == "std" else var
    red = _segment_extremum(values, segment_ids, num_segments, op)
    red = torch.where(torch.isfinite(red), red, torch.zeros_like(red))
    return torch.where(count > 0, red, torch.zeros_like(red))


def sort_by_segment(
    segment_ids: torch.Tensor, num_segments: int,
    valid: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable sort establishing segment locality.

    Returns int32 ``(perm, ids_sorted, offsets)``; offsets is
    (num_segments + 1,).  Invalid entries sort to the end with id
    ``num_segments``.
    """
    ids = segment_ids.to(torch.int32)
    if valid is not None:
        ids = torch.where(valid, ids, torch.full_like(ids, num_segments))
    ids_sorted, perm = torch.sort(ids, stable=True)
    probe = torch.arange(num_segments + 1, dtype=torch.int32, device=ids.device)
    offsets = torch.searchsorted(ids_sorted, probe, side="left")
    return perm.to(torch.int32), ids_sorted, offsets.to(torch.int32)


def sorted_segment_reduce(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    op: str = "sum",
) -> torch.Tensor:
    """:func:`segment_reduce` after a private sort (the layout-less path)."""
    perm, ids_sorted, _ = sort_by_segment(segment_ids, num_segments)
    vals_sorted = values[perm.long()]
    return segment_reduce(vals_sorted, ids_sorted, num_segments, op)

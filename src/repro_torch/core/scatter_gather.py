"""Sort-based segment scatter-gather, PyTorch port of
``repro.core.scatter_gather``.

JAX segment ops silently drop ids outside ``[0, num_segments)``;
``index_add_`` / ``scatter_reduce_`` raise on them.  Every reduction here
therefore routes such ids to a sink row ``num_segments`` and slices it off,
which reproduces the JAX semantics (padding edges and padded nodes carry
out-of-range ids by design).

The slot helpers (``rank_within_segment``, ``dispatch_to_slots``,
``combine_from_slots``) are the MoE routing's merged scatter-gather:
one stable sort, a rank within each segment, a bounded slot buffer.  They
read nothing back to the host, so a CUDA graph can capture them, and they
write no index twice: the slots are gathered from the sorted order, not
scattered into (JAX scatters, and only its discarded sink row sees
duplicate writes).
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


def _rank(ids: torch.Tensor, num_segments: int):
    """(perm, offsets, rank) of int32 ``ids`` in [0, num_segments]: the
    stable sort and each element's position within its segment."""
    perm, _, offsets = sort_by_segment(ids, num_segments)
    # index within the sorted run = sorted position - segment start
    seg_start = offsets[ids.clamp(0, num_segments)[perm.long()].long()]
    rank_sorted = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device) - seg_start
    # back to input order (perm is a permutation: no index written twice)
    rank = torch.empty_like(rank_sorted).index_copy_(0, perm.long(), rank_sorted)
    return perm, offsets, rank


def rank_within_segment(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Position of each element within its segment (0-based, int32), in
    input order: the stable sort makes the first element of a segment
    rank 0.  The capacity-slot assignment of :func:`dispatch_to_slots`."""
    return _rank(segment_ids.to(torch.int32), num_segments)[2]


def dispatch_to_slots(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    capacity: int,
    valid: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather ``values`` (E, F) into a dense (num_segments, capacity, F)
    slot array: element -> segment with bounded fan-in.  The first
    ``capacity`` elements of a segment, in input order, are kept; the rest
    and those with ``valid`` False are dropped (the GShard / Switch
    semantics, a bounded FPGA FIFO).  Ids lie in [0, num_segments).

    Returns (slots, slot_index, kept): slot_index (E,) int32 is
    ``capacity * segment + rank`` for a kept element and the sink
    ``num_segments * capacity`` for a dropped one; kept (E,) bool.  Slot
    (s, j) holds the element at sorted position offsets[s] + j, when that
    lies inside segment s, else zeros: the same array as JAX's scatter.
    """
    e, f = values.shape
    ids = segment_ids.to(torch.int32)
    if valid is not None:
        ids = torch.where(valid, ids, torch.full_like(ids, num_segments))
    perm, offsets, rank = _rank(ids, num_segments)
    kept = (rank < capacity) & (ids < num_segments)
    slot = torch.where(kept, ids * capacity + rank,
                       torch.full_like(ids, num_segments * capacity))
    pos = offsets[:-1, None] + torch.arange(capacity, dtype=torch.int32,
                                            device=ids.device)
    filled = pos < offsets[1:, None]  # (num_segments, capacity)
    if e == 0:
        return (values.new_zeros((num_segments, capacity, f)), slot, kept)
    src = perm[pos.clamp(max=e - 1).reshape(-1).long()]
    slots = values.index_select(0, src.long()).reshape(num_segments, capacity, f)
    return slots.masked_fill_(~filled[..., None], 0), slot, kept


def combine_from_slots(slots: torch.Tensor, slot_index: torch.Tensor,
                       kept: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dispatch_to_slots`: each element's slot row,
    zeros for a dropped element (the identity of a sum-combine)."""
    num_segments, capacity, f = slots.shape
    flat = slots.reshape(num_segments * capacity, f)
    safe = slot_index.clamp(max=num_segments * capacity - 1).long()
    return flat.index_select(0, safe).masked_fill_(~kept[:, None], 0)


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

"""Mixture-of-Experts FFN routed through GenGNN's scatter-gather core (port
of ``repro.models.moe``).

Token -> expert routing is message passing on a bipartite graph: tokens
are messages, experts destination nodes, and the capacity-sliced dispatch
and combine are the paper's merged scatter-gather with a bounded slot
buffer.  ``core.scatter_gather.dispatch_to_slots`` (one stable sort, the
rank within each segment, a dense slot gather) does the routing, so the
expert GEMMs run over ~ capacity_factor x the active tokens.

Two implementations, selected by ``cfg.moe_impl``:
  * "dispatch": the scatter-gather path above (the default);
  * "dense":    every token through every expert, a masked combine: JAX's
    comparison baseline, and the dispatch path's parity oracle at ample
    capacity.

Dispatch is grouped by batch row (GShard's group = sequence): capacity
``max(int(cf * S * k / E), 1)`` rounded up to a multiple of 8, JAX's rule
exactly (the rounding was for the TPU's sublanes; it decides which tokens
drop, so it stays).  JAX vmaps the dispatch over rows; the port sorts
once over every row, on the segment ``expert * B + row``: a segment holds
the same elements in the same order as JAX's per-row segment ``expert``,
so ranks and drops are JAX's, and the slots come out expert-major, (E,
B * C, D), the layout of the expert GEMMs (``torch.bmm`` with E as the
batch axis, as JAX computes them outside any Pallas kernel).

JAX's three ``logical_constraint`` calls pin rows and experts to mesh
axes (no-ops without a mesh).  JAX's slots are (B, E, C, D) under
("moe_batch", "experts", None, None); the port's are expert-major (E,
B * C, D), so ``_lc_slots`` resolves JAX's axes on JAX's shape, in JAX's
order, and places "experts" on dim 0 and "moe_batch" on dim 1 (rows
major within it: a rank's block of rows is a contiguous block of B * C).
The combined token copies take ("batch", None, None) as (B, S * k, D).
On a mesh (DTensor activations) the per-row sort, the slot gathers and
the combine have no DTensor strategy and run under ``local_map`` on each
rank's rows (``partitioning.local_blocks``: the dispatch's segment is
expert * B_rank + row, so each rank's slots are its block of the global
ones); the routing and the expert GEMMs are DTensor ops, the GEMMs
sharded over experts.
Nothing here reads a value back to the host (no ``.item()``,
``nonzero``, boolean-mask indexing or ``one_hot``, whose range check
synchronises on CUDA), so a CUDA graph captures it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn

from repro_torch import params as P
from repro_torch.core import scatter_gather as sg
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import compat
from repro_torch.runtime import partitioning as PT
from repro_torch.runtime.partitioning import logical_constraint as _lc


def moe_init(gen: torch.Generator, cfg: ModelConfig, stack=()) -> dict:
    """JAX's leaves and shapes: router (D, E) at scale 0.02, wi (E, D, 2,
    F), wo (E, F, D), each behind ``stack``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": P.init_normal(gen, (d, e), scale=0.02, stack=stack),
            "wi": P.init_normal(gen, (e, d, 2, f), stack=stack),
            "wo": P.init_normal(gen, (e, f, d), stack=stack)}


MOE_AXES = {"router": ("embed", "experts"), "wi": ("experts", "embed", None, "mlp"),
            "wo": ("experts", "mlp", "embed")}  # JAX's logical axes, per layer


def _route(p: dict, x2d: torch.Tensor, cfg: ModelConfig, with_aux: bool):
    """Top-k routing in fp32.  x2d: (T, D) -> weights (T, k), experts (T,
    k) and the Switch load-balance loss (None unless ``with_aux``)."""
    logits = torch.matmul(x2d.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.experts_per_token, dim=-1)
    if cfg.norm_topk:  # qwen3: renormalize over the selected experts
        top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    if not with_aux:
        return top_p, top_e, None
    e = cfg.num_experts
    me = torch.mean(probs, dim=0)  # mean router prob per expert
    # the share of tokens whose top-1 is each expert (one_hot's indicator)
    top1 = top_e[:, :1] == torch.arange(e, device=x2d.device)
    ce = torch.mean(top1.float(), dim=0)
    return top_p, top_e, e * torch.sum(me * ce)


def _expert_ffn(slots: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """slots: (E, N, D) -> (E, N, D) through each expert's own gated MLP
    (``jax.nn.gelu`` is the tanh form)."""
    e, d = slots.shape[0], slots.shape[-1]
    wi = p["wi"]  # (E, D, 2, F)
    if L._late_cut(wi, 2) is None:
        h = torch.bmm(slots, wi.reshape(e, d, -1)).reshape(e, -1, 2, wi.shape[-1])
    else:
        # cut on F (a mesh whose "model" axis the experts do not divide:
        # Mixtral's 8 on 16): F goes first before (F, 2) is flattened, as
        # ``layers._linear`` does, so the flat weight stays cut on its columns
        h = torch.bmm(slots, wi.movedim(3, 2).reshape(e, d, -1))
        h = h.reshape(e, -1, wi.shape[-1], 2).movedim(3, 2)
    gate, up = h[..., 0, :], h[..., 1, :]
    act = Fn.silu(gate) if cfg.mlp_type != "geglu" else Fn.gelu(gate, approximate="tanh")
    return torch.bmm(act.mul_(up), p["wo"])  # in place: one (E, N, F) buffer less


def capacity(cfg: ModelConfig, s: int) -> int:
    """Slots per (row, expert) for rows of ``s`` tokens: JAX's rule."""
    c = max(int(cfg.capacity_factor * s * cfg.experts_per_token / cfg.num_experts), 1)
    return -(-c // 8) * 8


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, with_aux: bool = True):
    """x: (B, S, D) -> (out (B, S, D), aux): aux the fp32 load-balance loss,
    or None when not ``with_aux`` (JAX's compiled prefill and decode
    discard it; eagerly it would cost a few launches a layer)."""
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    top_p, top_e, aux = _route(p, x2d, cfg, with_aux)
    k, e = cfg.experts_per_token, cfg.num_experts

    if cfg.moe_impl == "dense":
        # baseline: all tokens through all experts, weighted combine
        y_all = _expert_ffn(x2d.expand(e, t, d), p, cfg)  # (E, T, D)
        w = torch.zeros((t, e), dtype=x.dtype, device=x.device)
        w.scatter_(1, top_e, top_p.to(x.dtype))
        out = torch.einsum("te,etd->td", w, y_all)
        return out.reshape(b, s, d), aux

    # --- grouped dispatch (the paper's merged scatter-gather, per row) ---
    c = capacity(cfg, s)
    if _is_dtensor(x):  # a mesh's step: the sort and the gathers on each rank's rows
        slots, slot_idx, kept = PT.local_blocks(
            _dispatch, x, (0,), (x, top_e, e, k, c), ((0,), (0,), None, None, None),
            ((1,), (0,), (0,)))
    else:
        slots, slot_idx, kept = _dispatch(x, top_e, e, k, c)
    slots = _lc_slots(slots, b, c)  # (rows -> data, experts -> model), JAX's
    y = _lc_slots(_expert_ffn(slots, p, cfg), b, c)  # (E, B*C, D)
    if _is_dtensor(y):
        back = PT.local_blocks(_combine, x, (0,), (y, slot_idx, kept, c),
                               ((1,), (0,), (0,), None), ((0,),))
    else:
        back = _combine(y, slot_idx, kept, c)
    back = _lc(back.reshape(b, s * k, d), ("batch", None, None))
    out = torch.sum(back.reshape(b, s, k, d) * top_p.reshape(b, s, k, 1).to(back.dtype),
                    dim=2)
    return out.to(x.dtype), aux


def _dispatch(x: torch.Tensor, top_e: torch.Tensor, e: int, k: int, c: int):
    """Rows (B, S, D) and their experts (B*S, k) -> expert-major slots (E,
    B*C, D), each token copy's slot index and whether it was kept: one
    stable sort over every row on the segment expert * B + row."""
    b, s, d = x.shape
    rows = torch.arange(b, device=x.device)[:, None]
    seg = (top_e.reshape(b, s * k) * b + rows).reshape(-1)  # expert * B + row
    xk = x[:, :, None, :].expand(b, s, k, d).reshape(b * s * k, d)
    slots, slot_idx, kept = sg.dispatch_to_slots(xk, seg, e * b, c)
    return slots.reshape(e, b * c, d), slot_idx, kept


def _combine(y: torch.Tensor, slot_idx: torch.Tensor, kept: torch.Tensor, c: int):
    """Each token copy's expert output (B*S*k, D) from the slots (E, B*C, D)."""
    e, bc, d = y.shape
    return sg.combine_from_slots(y.reshape(e * (bc // c), c, d), slot_idx, kept)


def _lc_slots(t: torch.Tensor, b: int, c: int) -> torch.Tensor:
    """JAX's constraint of its (B, E, C, D) slots, ("moe_batch", "experts",
    None, None), resolved on JAX's shape and in JAX's order, applied to
    the port's expert-major (E, B*C, D) slots: "experts" cuts dim 0 and
    "moe_batch" dim 1 (rows major within it)."""
    mesh = compat.get_active_mesh()
    if mesh is None or mesh.size == 1:
        return t
    e, _, d = t.shape
    mb, ex, _, _ = PT.resolve_spec(("moe_batch", "experts", None, None), (b, e, c, d),
                                   mesh, PT.current_rules())
    return PT.constrain(t.reshape(e, b, c, d), PT.PartitionSpec(ex, mb, None, None),
                        mesh).reshape(e, b * c, d)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)

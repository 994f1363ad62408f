"""Decoder stack of the dense and MoE families (port of
``repro.models.transformer``).

Layers are grouped into super-blocks of ``cfg.group_size`` (the pattern
period: Gemma-3's 5:1 local:global = 6, dense and every-layer MoE models
= 1).  Parameters of position ``pos`` in the group are stacked over the
``num_groups`` axis, ``(G, ...)``, as in JAX, so a converted JAX tree maps
leaf for leaf; the stack runs the groups as a Python loop (JAX's
``stack_mode="unroll"``).

The attention mixer is ported with both FFNs, the dense MLP and the MoE
(``models.moe``); the MLA, Mamba, RWKV, VLM and audio branches raise
``NotImplementedError`` naming their ROADMAP item.  ``stack_apply``
returns JAX's third element, the MoE load-balance loss summed over layers,
in train mode (``forward_hidden``); JAX's compiled prefill and decode
discard it, and the port's do not compute it (None).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig

_LATER = "is not ported yet (ROADMAP queue 1, item 12: {})"


def _check_supported(cfg: ModelConfig, pos: int) -> None:
    if cfg.family == "audio":
        raise NotImplementedError("the audio encoder-decoder " + _LATER.format("Whisper"))
    if cfg.family == "vlm":
        raise NotImplementedError("the VLM family " + _LATER.format("InternVL2"))
    if cfg.mixer_kind(pos) != "attn":
        raise NotImplementedError(f"the {cfg.mixer_kind(pos)} mixer "
                                  + _LATER.format("hybrid and SSM"))
    if cfg.attention == "mla":
        raise NotImplementedError("MLA " + _LATER.format("MiniCPM3"))


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------


def block_init(gen: torch.Generator, cfg: ModelConfig, pos: int, stack=()) -> dict:
    _check_supported(cfg, pos)
    return {"ln1": L.rms_norm_init(cfg.d_model, stack, gen.device),
            "ln2": L.rms_norm_init(cfg.d_model, stack, gen.device),
            "mixer": L.gqa_init(gen, cfg, stack),
            "ffn": (MOE.moe_init(gen, cfg, stack) if cfg.ffn_kind(pos) == "moe"
                    else L.mlp_init(gen, cfg, stack))}


def block_cache_init(cfg: ModelConfig, pos: int, batch: int, seq: int, dtype,
                     stack=(), device="cpu") -> dict:
    """Zero decode cache of one block position: k, v of shape
    (*stack, B, S, Hkv_eff, hd)."""
    shp = tuple(stack) + (batch, seq, cfg.kv_heads_effective, cfg.head_dim_)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, pos: int,
                mode: str = "train", cache: Optional[dict] = None,
                t=None, positions: Optional[torch.Tensor] = None,
                kernel_mode: str = "auto"):
    """Returns (x, cache_out, aux): aux the MoE layer's load-balance loss in
    train mode, else None.

    mode="train":   cache_out = {}.
    mode="prefill": cache_out holds the prompt's K/V (B, S, ...).
    mode="decode":  cache is this block's cache, updated in place at the
                    position ``t`` (an int or a device tensor) and
                    returned as cache_out.
    ``kernel_mode`` goes to the attention's kernel dispatch.
    """
    _check_supported(cfg, pos)
    decode = mode == "decode"
    cache_out: dict = {}
    h = L.rms_norm(x, p["ln1"])
    kv_cache = (cache["k"], cache["v"]) if decode else None
    out, kvc = L.gqa_apply(p["mixer"], h, cfg, cfg.window_for_layer(pos),
                           positions=positions, kv_cache=kv_cache, t=t,
                           mode=kernel_mode)
    if decode or mode == "prefill":
        cache_out["k"], cache_out["v"] = kvc
    x = x + out
    h2 = L.rms_norm(x, p["ln2"])
    aux = None
    if cfg.ffn_kind(pos) == "moe":
        out2, aux = MOE.moe_apply(p["ffn"], h2, cfg, with_aux=mode == "train")
    else:
        out2 = L.mlp_apply(p["ffn"], h2, cfg)
    return x + out2, cache_out, aux


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------


def stack_init(gen: torch.Generator, cfg: ModelConfig, cast=None) -> list:
    """list[pos] of parameter dicts with leaves stacked over num_groups;
    ``cast`` (leaf -> leaf) is applied to each position's leaves as soon as
    they are drawn."""
    cast = cast or (lambda t: t)
    return [{k: ({n: cast(w) for n, w in v.items()} if isinstance(v, dict) else cast(v))
             for k, v in block_init(gen, cfg, pos, stack=(cfg.num_groups,)).items()}
            for pos in range(cfg.group_size)]


def stack_cache_init(cfg: ModelConfig, batch: int, seq: int, dtype,
                     device="cpu") -> list:
    """list[pos] of cache dicts stacked over num_groups."""
    return [block_cache_init(cfg, pos, batch, seq, dtype, stack=(cfg.num_groups,),
                             device=device)
            for pos in range(cfg.group_size)]


def stack_apply(groups: list, x: torch.Tensor, cfg: ModelConfig, mode: str = "train",
                cache: Optional[list] = None, t=None,
                positions: Optional[torch.Tensor] = None, kernel_mode: str = "auto"):
    """Run all layers.  Returns (x, cache_out, aux).

    mode="prefill": cache_out is list[pos] of dicts of per-group lists of
    the K/V each layer produced (``lm.prefill`` writes them into its cache).
    mode="decode": ``cache`` (list[pos] of (G, ...) stacked dicts) is
    updated in place at ``t`` (an int or a device tensor, passed down to
    every layer) and returned.  mode="train": cache_out is None and aux the
    fp32 sum of the layers' load-balance losses, in JAX's order (0 without
    an MoE layer); in the other modes aux is None.
    """
    gs = cfg.group_size
    captured = [dict() for _ in range(gs)] if mode == "prefill" else None
    aux = (torch.zeros((), dtype=torch.float32, device=x.device) if mode == "train"
           else None)
    for g in range(cfg.num_groups):
        for pos in range(gs):
            gp = {name: (leaf[g] if not isinstance(leaf, dict)
                         else {k: w[g] for k, w in leaf.items()})
                  for name, leaf in groups[pos].items()}
            c = ({k: w[g] for k, w in cache[pos].items()} if cache is not None
                 else None)
            x, nc, a = block_apply(gp, x, cfg, pos, mode=mode, cache=c, t=t,
                                   positions=positions, kernel_mode=kernel_mode)
            if a is not None:
                aux = aux + a
            if captured is not None:
                for k, val in nc.items():
                    captured[pos].setdefault(k, []).append(val)
    return x, (cache if mode == "decode" else captured), aux

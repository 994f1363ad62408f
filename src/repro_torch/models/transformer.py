"""Decoder stack of every LM family (port of ``repro.models.transformer``).

Layers are grouped into super-blocks of ``cfg.group_size`` (the pattern
period: Jamba's 1:7 attention:Mamba = 8, Gemma-3's 5:1 local:global = 6,
dense and every-layer MoE models = 1).  Parameters of position ``pos`` in
the group are stacked over the ``num_groups`` axis, ``(G, ...)``, as in
JAX, so a converted JAX tree maps leaf for leaf; the stack runs the groups
as a Python loop (JAX's ``stack_mode="unroll"``).

Every mixer is ported (GQA and MLA attention, Mamba, RWKV-6 time mix) with
every FFN (the dense MLP, the MoE of ``models.moe``, RWKV's channel mix).
An audio decoder's block (``cross_attention=True``) adds ``ln_cross`` and
a cross-attention over the encoder's K/V after its mixer: at prefill from
``enc_kv``, in decode from the cache's ``cross_k`` / ``cross_v``.  A
block's cache holds sequence entries (GQA's k / v, MLA's ckv / krope:
``SEQ_CACHE_KEYS``), recurrent states (Mamba's conv / ssm, RWKV's shift /
wkv and the channel mix's cm_shift) and an audio decoder's cross K/V
(written whole at prefill, read as they are by every decode step); a
decode step writes the first two into the cache in place.
``stack_apply`` returns JAX's third element, the MoE load-balance loss
summed over layers, in train mode (``forward_hidden``, the Whisper
encoder); JAX's compiled prefill and decode discard it, and the port's do
not compute it (None).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.partitioning import in_this_scope
from repro_torch.runtime.partitioning import logical_constraint as _lc

SEQ_CACHE_KEYS = ("k", "v", "ckv", "krope")  # cache entries indexed by position


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------


def block_init(gen: torch.Generator, cfg: ModelConfig, pos: int, stack=(),
               cross_attention: bool = False) -> dict:
    """One block position's parameters, drawn in JAX's order: the mixer,
    the cross-attention (an audio decoder's), the FFN."""
    kind = cfg.mixer_kind(pos)
    if kind == "attn":
        mixer = (L.mla_init(gen, cfg, stack) if cfg.attention == "mla"
                 else L.gqa_init(gen, cfg, stack))
    elif kind == "mamba":
        mixer = SSM.mamba_init(gen, cfg, stack)
    else:
        mixer = SSM.rwkv6_init(gen, cfg, stack)
    p = {"ln1": L.rms_norm_init(cfg.d_model, stack, gen.device),
         "ln2": L.rms_norm_init(cfg.d_model, stack, gen.device),
         "mixer": mixer}
    if cross_attention:
        p["ln_cross"] = L.rms_norm_init(cfg.d_model, stack, gen.device)
        p["cross"] = L.gqa_init(gen, cfg, stack)
    p["ffn"] = (MOE.moe_init(gen, cfg, stack) if cfg.ffn_kind(pos) == "moe"
                else L.mlp_init(gen, cfg, stack))
    return p


def block_axes(cfg: ModelConfig, pos: int, cross_attention: bool = False) -> dict:
    """JAX's logical axes of ``block_init``'s leaves, per layer (the
    checkpoint manifest's ``axes``; ``stack_axes`` prepends "layers")."""
    kind = cfg.mixer_kind(pos)
    if kind == "attn":
        mixer = L.MLA_AXES if cfg.attention == "mla" else L.gqa_axes(cfg)
    else:
        mixer = SSM.MAMBA_AXES if kind == "mamba" else SSM.RWKV6_AXES
    p = {"ln1": L.NORM_AXES, "ln2": L.NORM_AXES, "mixer": dict(mixer)}
    if cross_attention:
        p["ln_cross"] = L.NORM_AXES
        p["cross"] = L.gqa_axes(cfg)
    p["ffn"] = dict(MOE.MOE_AXES if cfg.ffn_kind(pos) == "moe" else L.mlp_axes(cfg))
    return p


def block_cache_init(cfg: ModelConfig, pos: int, batch: int, seq: int, dtype,
                     stack=(), device="cpu") -> dict:
    """Zero decode cache of one block position, JAX's entries, shapes and
    dtypes behind ``stack``: GQA's k, v (B, S, Hkv_eff, hd) or MLA's ckv (B,
    S, kvr) and krope (B, S, dr) in ``dtype``; Mamba's conv (B, dc-1, di)
    in ``dtype`` and ssm (B, di, ds) in fp32; RWKV's shift (B, 1, D) in
    ``dtype`` and wkv (B, H, hd, hd) in fp32; the channel mix's cm_shift
    (B, 1, D) in ``dtype``; an audio decoder's cross_k, cross_v (B,
    encoder_seq, Hkv, hd) in ``dtype``."""
    st = tuple(stack)
    zeros = lambda *shape, dt=dtype: torch.zeros(st + shape, dtype=dt, device=device)
    kind = cfg.mixer_kind(pos)
    c: dict = {}
    if cfg.family == "audio":  # filled at prefill
        c["cross_k"] = zeros(batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim_)
        c["cross_v"] = zeros(batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim_)
    if kind == "attn" and cfg.attention == "mla":
        c["ckv"] = zeros(batch, seq, cfg.kv_lora_rank)
        c["krope"] = zeros(batch, seq, cfg.qk_rope_dim)
    elif kind == "attn":
        c["k"] = zeros(batch, seq, cfg.kv_heads_effective, cfg.head_dim_)
        c["v"] = zeros(batch, seq, cfg.kv_heads_effective, cfg.head_dim_)
    elif kind == "mamba":
        c["conv"] = zeros(batch, cfg.d_conv - 1, cfg.d_inner)
        c["ssm"] = zeros(batch, cfg.d_inner, cfg.d_state, dt=torch.float32)
    else:
        c["shift"] = zeros(batch, 1, cfg.d_model)
        c["wkv"] = zeros(batch, cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.rwkv_head_dim,
                         dt=torch.float32)
    if cfg.mlp_type == "relu_sq":
        c["cm_shift"] = zeros(batch, 1, cfg.d_model)
    return c


def block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, pos: int,
                mode: str = "train", cache: Optional[dict] = None,
                t=None, positions: Optional[torch.Tensor] = None,
                kernel_mode: str = "auto", enc_kv: Optional[tuple] = None):
    """Returns (x, cache_out, aux): aux the MoE layer's load-balance loss in
    train mode, else None.

    mode="train":   cache_out = {}.
    mode="prefill": cache_out holds the prompt's sequence entries (B, S,
                    ...), the final recurrent states and an audio
                    decoder's cross K/V (``enc_kv``, this layer's (k, v)).
    mode="decode":  cache is this block's cache: sequence entries written
                    at the position ``t`` (an int or a device tensor) and
                    the new recurrent states copied in, both in place (the
                    cache's tensors are views a CUDA graph replays into);
                    the cross K/V are read from it as they are; it is
                    returned as cache_out.
    ``kernel_mode`` goes to the attention's kernel dispatch.
    """
    kind = cfg.mixer_kind(pos)
    decode, prefill = mode == "decode", mode == "prefill"
    cache_out: dict = {}
    x = _lc(x, ("batch", "seq", None))  # the residual stream: batch over data
    h = L.rms_norm(x, p["ln1"])
    if kind == "attn" and cfg.attention == "mla":
        out, kvc = L.mla_apply(p["mixer"], h, cfg, positions=positions,
                               cache=(cache["ckv"], cache["krope"]) if decode else None,
                               t=t, mode=kernel_mode)
        if decode or prefill:
            cache_out["ckv"], cache_out["krope"] = kvc
    elif kind == "attn":
        out, kvc = L.gqa_apply(p["mixer"], h, cfg, cfg.window_for_layer(pos),
                               positions=positions,
                               kv_cache=(cache["k"], cache["v"]) if decode else None,
                               t=t, mode=kernel_mode)
        if decode or prefill:
            cache_out["k"], cache_out["v"] = kvc
    else:
        names = ("conv", "ssm") if kind == "mamba" else ("shift", "wkv")
        apply = SSM.mamba_apply if kind == "mamba" else SSM.rwkv6_time_mix
        out, st = apply(p["mixer"], h, cfg,
                        state={n: cache[n] for n in names} if decode else None,
                        return_state=prefill)
        if decode or prefill:
            cache_out.update(_states_into(cache if decode else None, st))
    x = x + out
    if "cross" in p:
        enc_k, enc_v = (cache["cross_k"], cache["cross_v"]) if decode else enc_kv
        x = x + L.cross_attention_apply(p["cross"], L.rms_norm(x, p["ln_cross"]),
                                        enc_k, enc_v, cfg)
        if prefill:
            cache_out["cross_k"], cache_out["cross_v"] = enc_k, enc_v
    # the mixer's partial sums reduced here, as XLA's partitioner ends a
    # contraction: a DTensor residual left Partial makes the next GEMM
    # gather its weight whole on every rank instead (the dry-run counted the
    # MLP's work 16 times over on a 16x16 mesh)
    x = _lc(x, ("batch", "seq", None))
    h2 = L.rms_norm(x, p["ln2"])
    aux = None
    if cfg.ffn_kind(pos) == "moe":
        out2, aux = MOE.moe_apply(p["ffn"], h2, cfg, with_aux=mode == "train")
    elif cfg.mlp_type == "relu_sq":
        out2, st = SSM.rwkv_channel_mix(
            p["ffn"], h2, cfg, state={"shift": cache["cm_shift"]} if decode else None,
            return_state=prefill)
        if decode or prefill:
            cache_out.update(_states_into(cache if decode else None,
                                          {"cm_shift": st["shift"]}))
    else:
        out2 = L.mlp_apply(p["ffn"], h2, cfg)
    return x + out2, cache_out, aux


def _states_into(cache: Optional[dict], states: dict) -> dict:
    """New recurrent states: copied into ``cache``'s tensors in place when
    there is a cache (decode; the copied entries are returned), else
    returned as they are (prefill)."""
    if cache is None:
        return states
    for name, val in states.items():
        cache[name].copy_(val)
    return {name: cache[name] for name in states}


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------


def stack_init(gen: torch.Generator, cfg: ModelConfig,
               cross_attention: bool = False) -> list:
    """list[pos] of parameter dicts with leaves stacked over num_groups."""
    return [block_init(gen, cfg, pos, stack=(cfg.num_groups,),
                       cross_attention=cross_attention)
            for pos in range(cfg.group_size)]


def stack_axes(cfg: ModelConfig, cross_attention: bool = False) -> list:
    """``stack_init``'s tree of JAX's logical axes: "layers" first."""
    def stacked(tree):
        if isinstance(tree, dict):
            return {k: stacked(v) for k, v in tree.items()}
        return ("layers",) + tree
    return [stacked(block_axes(cfg, pos, cross_attention)) for pos in range(cfg.group_size)]


def block_cache_axes(cfg: ModelConfig, pos: int) -> dict:
    """JAX's logical axes of :func:`block_cache_init`'s entries (its cache
    ``Param`` leaves), unstacked."""
    kind = cfg.mixer_kind(pos)
    a: dict = {}
    if cfg.family == "audio":
        a["cross_k"] = a["cross_v"] = ("batch", None, "kv_heads", "head_dim")
    if kind == "attn" and cfg.attention == "mla":
        a["ckv"] = ("batch", "kv_seq", "kv_lora")
        a["krope"] = ("batch", "kv_seq", "head_dim")
    elif kind == "attn":
        a["k"] = a["v"] = ("batch", "kv_seq", "kv_heads", "head_dim")
    elif kind == "mamba":
        a["conv"] = ("batch", None, "inner")
        a["ssm"] = ("batch", "inner", "state")
    else:
        a["shift"] = ("batch", None, "embed")
        a["wkv"] = ("batch", "heads", None, None)
    if cfg.mlp_type == "relu_sq":
        a["cm_shift"] = ("batch", None, "embed")
    return a


def stack_cache_axes(cfg: ModelConfig) -> list:
    """list[pos] of :func:`block_cache_axes` behind the stacked "layers"
    axis (JAX's ``stack_cache_init`` axes)."""
    return [{k: ("layers",) + v for k, v in block_cache_axes(cfg, pos).items()}
            for pos in range(cfg.group_size)]


def stack_cache_init(cfg: ModelConfig, batch: int, seq: int, dtype,
                     device="cpu") -> list:
    """list[pos] of cache dicts stacked over num_groups."""
    return [block_cache_init(cfg, pos, batch, seq, dtype, stack=(cfg.num_groups,),
                             device=device)
            for pos in range(cfg.group_size)]


def stack_apply(groups: list, x: torch.Tensor, cfg: ModelConfig, mode: str = "train",
                cache: Optional[list] = None, t=None,
                positions: Optional[torch.Tensor] = None, kernel_mode: str = "auto",
                enc_kv: Optional[list] = None):
    """Run all layers.  Returns (x, cache_out, aux).  ``enc_kv`` (an audio
    decoder's prefill): list[pos] of (k, v), each (G, B, S_enc, Hkv, D).

    mode="prefill": cache_out is list[pos] of dicts of per-group lists of
    the sequence entries and final states each layer produced
    (``lm.prefill`` writes them into its cache).
    mode="decode": ``cache`` (list[pos] of (G, ...) stacked dicts) is
    updated in place at ``t`` (an int or a device tensor, passed down to
    every layer) and returned.  mode="train": cache_out is None and aux the
    fp32 sum of the layers' load-balance losses, in JAX's order (each
    group's sum, then the sum over groups; 0 without an MoE layer); in the
    other modes aux is None.

    ``cfg.remat`` applies in train mode with grad enabled, as JAX's
    ``jax.checkpoint`` of each group: a group keeps only
    its input for the backward pass and runs its forward again there
    (``torch.utils.checkpoint``, non-reentrant), so a step holds one
    group's activations at a time; on a mesh the recompute runs under the
    forward's mesh and rules (``partitioning.in_this_scope``).
    """
    gs = cfg.group_size
    train = mode == "train"
    remat = cfg.remat and train and torch.is_grad_enabled()
    captured = [dict() for _ in range(gs)] if mode == "prefill" else None

    def group(x, g):
        aux = torch.zeros((), dtype=torch.float32, device=x.device) if train else None
        for pos in range(gs):
            gp = {name: (leaf[g] if not isinstance(leaf, dict)
                         else {k: w[g] for k, w in leaf.items()})
                  for name, leaf in groups[pos].items()}
            gp = L.gather_where_batch_cut(gp, x)
            c = ({k: w[g] for k, w in cache[pos].items()} if cache is not None
                 else None)
            ekv = (enc_kv[pos][0][g], enc_kv[pos][1][g]) if enc_kv is not None else None
            x, nc, a = block_apply(gp, x, cfg, pos, mode=mode, cache=c, t=t,
                                   positions=positions, kernel_mode=kernel_mode,
                                   enc_kv=ekv)
            if a is not None:
                aux = aux + a
            if captured is not None:
                for k, val in nc.items():
                    captured[pos].setdefault(k, []).append(val)
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device) if train else None
    for g in range(cfg.num_groups):
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(in_this_scope(group), x, g,
                                                     use_reentrant=False)
        else:
            x, a = group(x, g)
        if train:
            aux = aux + a
    return x, (cache if mode == "decode" else captured), aux

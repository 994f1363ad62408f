"""Top-level decoder-only language model of the dense, MLA, MoE, hybrid
and SSM families: embeddings, stack, head, prefill and decode (port of
``repro.models.lm``).

Parameters are a plain dict: ``embed`` (V, d), ``final_norm`` (d,),
``blocks`` (``transformer.stack_init``'s list) and, untied, ``lm_head``
(d, V).  ``kernel_mode`` ("auto" | "kernel" | "reference") reaches the
prefill attention's dispatch.  The VLM and audio families and the losses
(training) are not ported yet.
"""
from __future__ import annotations

import math

import torch

from repro_torch import params as P
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen``'s device.  As in JAX, every leaf of two
    or more dimensions (the stacked block norms included) is cast to the
    model dtype and the rest stay fp32.  Each block position is cast as
    soon as it is drawn, so at most one position's stacked leaves exist in
    fp32 at a time (ChatGLM3-6B: 16.4 GB; Mixtral-8x7B at 4 layers: 23 GB,
    its experts' ``wi`` 15 GB of it)."""
    dt = _dt(cfg)
    cast = lambda t: t.to(dt) if t.dim() >= 2 else t
    p: dict = {"embed": cast(P.init_normal(gen, (cfg.vocab_size, cfg.d_model))),
               "final_norm": L.rms_norm_init(cfg.d_model, device=gen.device)}
    p["blocks"] = T.stack_init(gen, cfg, cast=cast)
    if not cfg.tie_embeddings:
        p["lm_head"] = cast(P.init_normal(gen, (cfg.d_model, cfg.vocab_size)))
    return p


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    e = params["embed"][tokens.long()]
    return (e * math.sqrt(cfg.d_model)).to(_dt(cfg))


def _head_matrix(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_fn(params: dict, hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return torch.matmul(hidden, _head_matrix(params, cfg))


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def forward_hidden(params: dict, batch: dict, cfg: ModelConfig,
                   kernel_mode: str = "auto"):
    """Forward to the final hidden states.  batch: {"tokens": (B, S)}.
    Returns (hidden (B, S, D), aux_loss): aux the fp32 MoE load-balance
    loss summed over layers (0 for a dense model), as JAX's."""
    x = embed_tokens(params, batch["tokens"], cfg)
    x, _, aux = T.stack_apply(params["blocks"], x, cfg, kernel_mode=kernel_mode)
    return L.rms_norm(x, params["final_norm"]), aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, seq: int, device="cpu") -> list:
    return T.stack_cache_init(cfg, batch, seq, _dt(cfg), device=device)


def prefill(params: dict, batch: dict, cfg: ModelConfig, cache_len: int,
            kernel_mode: str = "auto", cache: list | None = None):
    """Run the prompt through the stack, building the decode cache.

    JAX's rule: each layer's sequence entries of the prompt (GQA's K/V,
    MLA's latent ckv / krope, captured in the same forward pass) are
    written into positions 0 .. S-1 of a cache of length ``cache_len``
    whose later positions are zero, as JAX's fresh cache is; its final
    recurrent states (Mamba's conv / ssm, RWKV's shift / wkv / cm_shift)
    are copied whole.  That cache is a new one, or ``cache``
    (``init_cache``'s layout), which the caller owns and which is
    overwritten in place: a server's static cache outlives the CUDA graph
    that fills it.  Returns (cache, last_logits (B, V), t0 = S).
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    if s > cache_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {cache_len}")
    x = embed_tokens(params, tokens, cfg)
    x, captured, _ = T.stack_apply(params["blocks"], x, cfg, mode="prefill",
                                      kernel_mode=kernel_mode)
    hidden = L.rms_norm(x, params["final_norm"])
    last_logits = logits_fn(params, hidden[:, -1:], cfg)[:, 0]
    owned = cache is not None
    if not owned:
        cache = init_cache(cfg, b, cache_len, device=tokens.device)
    for pos in range(cfg.group_size):
        for key, vals in captured[pos].items():
            # (G, B, cache_len, ...) for a sequence entry, (G, B, ...) a state
            leaf = cache[pos][key]
            seq = key in T.SEQ_CACHE_KEYS
            if seq and leaf.shape[2] != cache_len:
                raise ValueError(f"a cache of {leaf.shape[2]} positions for "
                                 f"cache_len {cache_len}")
            for g, val in enumerate(vals):
                if seq:
                    leaf[g, :, :s] = val
                else:
                    leaf[g].copy_(val)
            if owned and seq:
                leaf[:, :, s:].zero_()
    return cache, last_logits, s


def decode_step(params: dict, cache: list, tokens: torch.Tensor, t,
                cfg: ModelConfig):
    """One token step.  tokens: (B, 1); t: the position written, an int or
    a device tensor (JAX's traced ``t``: the step then reads nothing back
    to the host and can be captured).  The cache is updated in place (slot
    t of every layer) and returned.

    Returns (logits (B, V), cache).
    """
    x = embed_tokens(params, tokens, cfg)
    x, cache, _ = T.stack_apply(params["blocks"], x, cfg, mode="decode",
                                   cache=cache, t=t)
    hidden = L.rms_norm(x, params["final_norm"])
    return logits_fn(params, hidden[:, 0], cfg), cache

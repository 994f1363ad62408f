"""Top-level language model of every family: embeddings, stack, head,
prefill and decode (port of ``repro.models.lm``).

Families:
  dense / mla / moe / hybrid / ssm: a decoder over tokens.
  vlm:   a decoder over [patch embeddings ; token embeddings]; the vision
         frontend is JAX's stub: the batch carries precomputed patch
         embeddings, ``"patches"`` (B, P, d_model).
  audio: an encoder-decoder (Whisper): a bidirectional encoder over
         precomputed frame embeddings, ``"frames"`` (B, encoder_seq,
         d_model) (the conv frontend is JAX's stub), and a decoder with
         cross-attention to it.

Parameters are a plain dict: ``embed`` (V, d), ``final_norm`` (d,),
``blocks`` (``transformer.stack_init``'s list), untied ``lm_head`` (d, V)
and, for audio, ``enc_blocks``, ``enc_norm`` (d,) and ``enc_pos``
(encoder_seq, d).  ``kernel_mode`` ("auto" | "kernel" | "reference")
reaches the prefill attention's dispatch.  ``loss_fn`` is the training
loss (chunked cross-entropy plus the MoE load-balance term);
``param_axes`` gives JAX's logical axes of ``init_params``' leaves, which
the checkpoint manifest stores.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as Fn
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Replicate

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
    or more dimensions (the stacked block norms and ``enc_pos`` included)
    is cast to the model dtype and the rest stay fp32.  Each leaf is cast
    as soon as it is drawn (``params.casting``), so at most one exists in
    fp32 at a time: InternVL2-26B's largest, the stacked SwiGLU ``wi``, is
    38.7 GB in fp32 beside ~40 GB of bf16 weights."""
    with P.casting(_dt(cfg)):
        p: dict = {"embed": P.init_normal(gen, (cfg.vocab_size, cfg.d_model)),
                   "final_norm": L.rms_norm_init(cfg.d_model, device=gen.device),
                   "blocks": T.stack_init(gen, cfg,
                                          cross_attention=cfg.family == "audio")}
        if not cfg.tie_embeddings:
            p["lm_head"] = P.init_normal(gen, (cfg.d_model, cfg.vocab_size))
        if cfg.family == "audio":
            p["enc_blocks"] = T.stack_init(gen, encoder_config(cfg))
            p["enc_norm"] = L.rms_norm_init(cfg.d_model, device=gen.device)
            p["enc_pos"] = P.init_normal(gen, (cfg.encoder_seq, cfg.d_model), scale=0.02)
    return p


def param_axes(cfg: ModelConfig) -> dict:
    """``init_params``' tree with JAX's logical axes tuples as leaves
    (``P.axes(init_params(...))`` of the JAX package); nothing is drawn."""
    axes: dict = {"embed": ("vocab", "embed"), "final_norm": L.NORM_AXES,
                  "blocks": T.stack_axes(cfg, cross_attention=cfg.family == "audio")}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    if cfg.family == "audio":
        axes["enc_blocks"] = T.stack_axes(encoder_config(cfg))
        axes["enc_norm"] = L.NORM_AXES
        axes["enc_pos"] = ("kv_seq", "embed")
    return axes


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """Whisper's encoder: bidirectional dense attention, the same width."""
    return dataclasses.replace(cfg, num_layers=cfg.encoder_layers, attn_every=0,
                               num_experts=0, global_every=0, sliding_window=0,
                               family="dense", causal=False, mlp_type="gelu")


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    table = params["embed"]
    if isinstance(table, DTensor):
        # the vocab-sharded table: each rank picks its rows, masked, and
        # the partial embeddings are summed here (indexing would gather the
        # table whole; a masked partial sum left pending cannot be summed
        # twice, as remat's recompute would)
        e = Fn.embedding(tokens.long(), table)
        e = e.redistribute(placements=[Replicate() if p.is_partial() else p
                                       for p in e.placements])
    else:
        e = table[tokens.long()]
    return (e * math.sqrt(cfg.d_model)).to(_dt(cfg))


def _head_matrix(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_fn(params: dict, hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return torch.matmul(hidden, _head_matrix(params, cfg))


# ---------------------------------------------------------------------------
# encoder (audio): bidirectional over precomputed frame embeddings
# ---------------------------------------------------------------------------


def encode_audio(params: dict, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames (B, encoder_seq, d_model) stub embeddings -> the encoder's
    output, in the model dtype."""
    dt = _dt(cfg)
    x = frames.to(dt) + params["enc_pos"][None].to(dt)
    x, _, _ = T.stack_apply(params["enc_blocks"], x, encoder_config(cfg))
    return L.rms_norm(x, params["enc_norm"])


def cross_kv_all(params: dict, enc_out: torch.Tensor, cfg: ModelConfig) -> list:
    """Every decoder layer's cross-attention K/V: list[pos] of (k, v), each
    (G, B, S_enc, Hkv, D)."""
    out = []
    for pos in range(cfg.group_size):
        cross = params["blocks"][pos]["cross"]
        out.append(tuple(torch.einsum("bsd,ldhk->lbshk", enc_out, cross[w])
                         for w in ("wk", "wv")))
    return out


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def extra_input(cfg: ModelConfig, batch: int):
    """The family's input beside the tokens, (name, shape) for ``batch``
    rows, float32: a VLM's "patches" (B, num_patches, d_model) or an audio
    model's "frames" (B, encoder_seq, d_model); None for the others."""
    if cfg.family == "vlm":
        return "patches", (batch, cfg.num_patches, cfg.d_model)
    if cfg.family == "audio":
        return "frames", (batch, cfg.encoder_seq, cfg.d_model)
    return None


def _extra(batch: dict, cfg: ModelConfig) -> torch.Tensor:
    name = extra_input(cfg, 0)[0]
    if batch.get(name) is None:
        raise ValueError(f"a {cfg.family} batch needs {name!r} beside its tokens")
    return batch[name]


def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig) -> tuple:
    """(the decoder's input sequence, the cross K/V or None): a VLM's
    patches go before the token embeddings, an audio batch's frames
    through the encoder."""
    x = embed_tokens(params, batch["tokens"], cfg)
    enc_kv = None
    if cfg.family == "vlm":
        x = torch.cat([_extra(batch, cfg).to(x.dtype), x], dim=1)
    elif cfg.family == "audio":
        enc_kv = cross_kv_all(params, encode_audio(params, _extra(batch, cfg), cfg), cfg)
    return x, enc_kv


def forward_hidden(params: dict, batch: dict, cfg: ModelConfig,
                   kernel_mode: str = "auto"):
    """Forward to the final hidden states.  batch: {"tokens": (B, S)}, with
    "patches" (VLM) or "frames" (audio).  Returns (hidden (B, S, D), with a
    VLM's P patch positions first: (B, P + S, D); aux_loss): aux the fp32
    MoE load-balance loss summed over layers (0 for a dense model), as
    JAX's."""
    x, enc_kv = _embed_inputs(params, batch, cfg)
    x, _, aux = T.stack_apply(params["blocks"], x, cfg, kernel_mode=kernel_mode,
                              enc_kv=enc_kv)
    return L.rms_norm(x, L.gather_where_batch_cut(params["final_norm"], x)), aux


def chunked_ce_loss(params: dict, hidden: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Mean cross-entropy over the weighted positions.  The logits are made
    ``cfg.loss_chunk`` positions at a time, each chunk under
    ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``): the backward pass
    makes a chunk's (B, chunk, V) fp32 logits again instead of keeping them."""
    s = hidden.shape[1]
    c = min(cfg.loss_chunk, s)
    head = L.gather_where_batch_cut(_head_matrix(params, cfg), hidden)

    def chunk_loss(h, lab, w):
        logits = torch.matmul(h, head).float()
        lse = _logsumexp(logits)
        gold = torch.gather(logits, -1, lab.long()[..., None])
        if isinstance(gold, DTensor):  # vocab-sharded: sum the masked picks first
            gold = gold.redistribute(placements=lse.placements)
        gold = gold[..., 0]
        return torch.sum((lse - gold) * w)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, c):
        sl = slice(c0, min(c0 + c, s))
        args = (hidden[:, sl], labels[:, sl], weights[:, sl])
        total = total + (torch.utils.checkpoint.checkpoint(chunk_loss, *args,
                                                           use_reentrant=False)
                         if torch.is_grad_enabled() else chunk_loss(*args))
    return total / torch.clamp(torch.sum(weights), min=1.0)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last (vocab) dim.  On vocab-sharded DTensor logits
    it is made of two reductions, a max and a sum, each a partial result
    over the vocab shards that an all-reduce of (B, chunk) values
    completes (``torch.logsumexp`` would gather the (B, chunk, V)
    logits)."""
    if not isinstance(logits, DTensor):
        return torch.logsumexp(logits, dim=-1)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    return (torch.log(torch.sum(torch.exp(logits - m), dim=-1, keepdim=True)) + m)[..., 0]


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, kernel_mode: str = "auto"):
    """The training loss of a batch, as JAX's: tokens (B, S) are the inputs
    and, shifted left, the labels; the last position is weighted 0, a VLM's
    patch positions are dropped before the loss, and an MoE model adds
    ``router_aux_coef`` times its load-balance loss.  Returns (loss, {"ce",
    "aux"}), fp32 0-d tensors."""
    hidden, aux = forward_hidden(params, batch, cfg, kernel_mode=kernel_mode)
    tokens = batch["tokens"]
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    weights = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    weights[:, -1] = 0.0
    if cfg.family == "vlm":  # hidden holds the patch positions first: no loss there
        hidden = hidden[:, cfg.num_patches:]
    loss = chunked_ce_loss(params, hidden, labels, weights, cfg)
    return loss + cfg.router_aux_coef * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, seq: int, device="cpu") -> list:
    return T.stack_cache_init(cfg, batch, seq, _dt(cfg), device=device)


def cache_axes(cfg: ModelConfig) -> list:
    """:func:`init_cache`'s tree with JAX's logical axes tuples as leaves
    (``P.axes(init_cache(...))`` of the JAX package)."""
    return T.stack_cache_axes(cfg)


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
    that fills it.  An audio decoder's cross K/V are copied whole.
    Returns (cache, last_logits (B, V), t0): t0 the length of the decoder's
    input, S, or a VLM's P + S (its patches first), as JAX's.
    """
    x, enc_kv = _embed_inputs(params, batch, cfg)
    b, s = x.shape[:2]
    if s > cache_len:
        raise ValueError(f"prompt of {s} positions does not fit a cache of {cache_len}")
    x, captured, _ = T.stack_apply(params["blocks"], x, cfg, mode="prefill",
                                   kernel_mode=kernel_mode, enc_kv=enc_kv)
    hidden = L.rms_norm(x, params["final_norm"])
    last_logits = logits_fn(params, hidden[:, -1:], cfg)[:, 0]
    owned = cache is not None
    if not owned:
        cache = init_cache(cfg, b, cache_len, device=x.device)
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
    t of every layer) and returned; an audio decoder reads its cross K/V
    from it, as prefill left them.

    Returns (logits (B, V), cache).
    """
    x = embed_tokens(params, tokens, cfg)
    x, cache, _ = T.stack_apply(params["blocks"], x, cfg, mode="decode",
                                   cache=cache, t=t)
    hidden = L.rms_norm(x, params["final_norm"])
    return logits_fn(params, hidden[:, 0], cfg), cache

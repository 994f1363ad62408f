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
import itertools
import math

import torch
import torch.distributed as dist
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
        e = L._whole_sum(Fn.embedding(tokens.long(), table))
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
    makes a chunk's (B, chunk, V) fp32 logits again instead of keeping them.
    On a mesh (DTensor ``hidden``) each rank does so on its own block
    (:class:`_MeshCE`)."""
    s = hidden.shape[1]
    c = min(cfg.loss_chunk, s)
    head = L.gather_where_batch_cut(_head_matrix(params, cfg), hidden)
    if isinstance(hidden, DTensor):
        return _mesh_ce_loss(hidden, head, labels, weights, c)

    def chunk_loss(h, lab, w):
        logits = torch.matmul(h, head).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
        return torch.sum((lse - gold) * w)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, c):
        sl = slice(c0, min(c0 + c, s))
        args = (hidden[:, sl], labels[:, sl], weights[:, sl])
        total = total + (torch.utils.checkpoint.checkpoint(chunk_loss, *args,
                                                           use_reentrant=False)
                         if torch.is_grad_enabled() else chunk_loss(*args))
    return total / torch.clamp(torch.sum(weights), min=1.0)


def _blocks_along(mesh, dims: list, length: int) -> tuple:
    """(start, size) of this rank's block of an axis of ``length`` cut over
    the mesh dims ``dims`` (major to minor), by DTensor's chunk rule."""
    start = 0
    for d in dims:
        chunk = -(-length // mesh.size(d))
        lo = min(mesh.get_local_rank(d) * chunk, length)
        start, length = start + lo, min(chunk, length - lo)
    return start, length


def _block_index(coord, dims: list, mesh) -> int:
    """The index of the block that mesh coordinate ``coord`` holds of an
    axis cut over ``dims``."""
    i = 0
    for d in dims:
        i = i * mesh.size(d) + coord[d]
    return i


class _MeshCE(torch.autograd.Function):
    """The chunked cross-entropy of a mesh's train step on each rank's
    block: hidden (B, S, D) cut on its rows over some mesh dims, the head
    (D, V) cut on its vocabulary over others (JAX's "vocab" rule), the
    rest whole.  Each rank makes its block's fp32 logits a chunk of
    ``chunk`` positions at a time, as the plain path does, and keeps four
    numbers a position: the block's max, its sum of exp(logits - max), the
    gold logit where the label falls in its vocabulary (else 0) and the
    weight.  One all-gather of these over the world gives every rank each
    position's logsumexp over the whole vocabulary and the loss, a whole
    scalar.  The backward makes each chunk's logits again (remat, as the
    plain path's checkpoint): the hidden states' gradient is a partial sum
    over the vocabulary blocks, made whole by one all-reduce; the head's
    is left a partial sum over the row blocks, for the step's gradient
    buckets (``partitioning.reduce_gradients``)."""

    @staticmethod
    def forward(ctx, hidden, head, labels, weights, chunk, batch_dims, vocab_dims):
        from repro_torch.runtime.partitioning import mesh_world_group

        mesh = hidden.device_mesh
        hl, wl = hidden.to_local(), head.to_local()
        lab, w = labels.to_local().long(), weights.to_local().float()
        v0, nv = _blocks_along(mesh, vocab_dims, head.shape[1])
        b, s = lab.shape
        stats = torch.empty((4, b, s), dtype=torch.float32, device=hl.device)
        for c0 in range(0, s, chunk):
            sl = slice(c0, min(c0 + chunk, s))
            logits = torch.matmul(hl[:, sl], wl).float()
            m = logits.amax(-1)
            stats[0, :, sl] = m
            stats[1, :, sl] = torch.exp(logits - m[..., None]).sum(-1)
            idx = lab[:, sl] - v0
            inside = (idx >= 0) & (idx < nv)
            gold = torch.gather(logits, -1, idx.clamp(0, nv - 1)[..., None])[..., 0]
            stats[2, :, sl] = torch.where(inside, gold, torch.zeros_like(gold))
        stats[3] = w
        world = mesh_world_group(mesh)
        everyone = stats.new_empty((mesh.size() * 4, b, s))
        dist.all_gather_into_tensor(everyone, stats, group=world)
        everyone = everyone.view(mesh.size(), 4, b, s)
        # each (row block, vocabulary block) once, in the world's rank order
        coords = {}
        for r, coord in _coordinates(mesh):
            key = (_block_index(coord, batch_dims, mesh), _block_index(coord, vocab_dims, mesh))
            coords.setdefault(key, r)
        n_rows = math.prod(mesh.size(d) for d in batch_dims)
        n_vocab = math.prod(mesh.size(d) for d in vocab_dims)
        lse_all, total, wsum = [], torch.zeros((), dtype=torch.float32, device=hl.device), 0
        for rb in range(n_rows):
            part = torch.stack([everyone[coords[(rb, vb)]] for vb in range(n_vocab)])
            top = part[:, 0].amax(0)
            lse = torch.log((part[:, 1] * torch.exp(part[:, 0] - top)).sum(0)) + top
            gold = part[:, 2].sum(0)
            rw = part[0, 3]
            total = total + torch.sum((lse - gold) * rw)
            wsum = wsum + torch.sum(rw)
            lse_all.append(lse)
        denom = torch.clamp(wsum, min=1.0)
        my_rows = _block_index(_my_coordinate(mesh), batch_dims, mesh)
        ctx.save_for_backward(hl, wl, lab, w, lse_all[my_rows], denom)
        ctx.meta = (chunk, v0, nv, batch_dims, vocab_dims, mesh)
        ctx.like = [(t.placements, t.shape, t.stride()) for t in (hidden, head)]
        return DTensor.from_local(total / denom, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Partial

        hl, wl, lab, w, lse, denom = ctx.saved_tensors
        chunk, v0, nv, batch_dims, vocab_dims, mesh = ctx.meta
        (h_pl, h_shape, h_stride), (w_pl, w_shape, w_stride) = ctx.like
        g = grad.to_local() if isinstance(grad, DTensor) else grad
        scale = w * (g.float() / denom)
        dh = torch.empty_like(hl)
        dw = torch.zeros(wl.shape, dtype=torch.float32, device=wl.device)
        s = lab.shape[1]
        for c0 in range(0, s, chunk):
            sl = slice(c0, min(c0 + chunk, s))
            logits = torch.matmul(hl[:, sl], wl).float()
            p = torch.exp(logits - lse[:, sl, None])
            idx = lab[:, sl] - v0
            inside = ((idx >= 0) & (idx < nv)).float()
            p = p.scatter_add(-1, idx.clamp(0, nv - 1)[..., None], -inside[..., None])
            dl = (p * scale[:, sl, None]).to(hl.dtype)
            dh[:, sl] = torch.matmul(dl, wl.transpose(0, 1))
            dw += torch.matmul(hl[:, sl].reshape(-1, hl.shape[-1]).transpose(0, 1),
                               dl.reshape(-1, dl.shape[-1])).float()
        for d in vocab_dims:
            dist.all_reduce(dh, group=mesh.get_group(d))
        dh = DTensor.from_local(dh, mesh, h_pl, run_check=False, shape=h_shape,
                                stride=h_stride)
        dwp = [Partial() if i in batch_dims else pl for i, pl in enumerate(w_pl)]
        dw = DTensor.from_local(dw.to(wl.dtype), mesh, dwp, run_check=False,
                                shape=w_shape, stride=w_stride)
        return dh, dw, None, None, None, None, None


def _coordinates(mesh) -> list:
    """(world rank, mesh coordinate) of every rank of ``mesh``."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():  # a host table: outside the dry-run's fake mode
        ranks = mesh.mesh.cpu().numpy()
    return [(int(ranks[idx]), idx) for idx in itertools.product(*map(range, ranks.shape))]


def _my_coordinate(mesh) -> tuple:
    return tuple(mesh.get_local_rank(d) for d in range(mesh.ndim))


def _mesh_ce_loss(hidden, head, labels, weights, chunk: int) -> torch.Tensor:
    """:func:`chunked_ce_loss` on a mesh (``_MeshCE``): hidden whole but on
    its rows, the head whole but on its vocabulary and on no dim that cuts
    the rows, labels and weights cut as hidden's rows."""
    from torch.distributed.tensor import Shard

    mesh = hidden.device_mesh
    rows = [Shard(0) if pl == Shard(0) else Replicate() for pl in hidden.placements]
    batch_dims = [i for i, pl in enumerate(rows) if pl == Shard(0)]
    vocab = [Shard(1) if pl == Shard(1) and i not in batch_dims else Replicate()
             for i, pl in enumerate(head.placements)]
    vocab_dims = [i for i, pl in enumerate(vocab) if pl == Shard(1)]

    def placed(t, pls):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t if list(t.placements) == pls else t.redistribute(mesh, pls)

    return _MeshCE.apply(placed(hidden, rows), placed(head, vocab), placed(labels, rows),
                         placed(weights, rows), chunk, batch_dims, vocab_dims)


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

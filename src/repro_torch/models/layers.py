"""Transformer building blocks of the dense decoders: norms, RoPE, dense
MLPs, GQA attention (port of ``repro.models.layers``).

The JAX package gives attention two executable forms with one meaning:
the jnp ``blocked_attention`` and the Pallas flash kernel for the TPU.
The port has one form per device: ``blocked_attention`` calls
``kernels.ops.flash_attention``, which is the hand-written CUDA flash
kernel on the card and the plain quadratic version on the CPU.  ``mode``
("auto" | "kernel" | "reference") reaches that dispatch from every caller.
Decode-time attention over a KV cache stays plain torch, as JAX computes
it outside Pallas.

Linears are ``torch.matmul`` on reshaped weights (XLA's einsums); RNG is
an explicit ``torch.Generator``; ``stack`` prepends the group axis of
``models.transformer`` to every parameter.  MLA, cross-attention and the
bidirectional encoder are not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from repro_torch import params as P
from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rms_norm_init(dim: int, stack=(), device="cpu") -> torch.Tensor:
    return P.init_ones((dim,), stack, device=device)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device="cpu") -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S) integers.

    Rotates the first ``fraction * D`` dims (chatglm-style partial rotary).
    The angles are fp32; cos and sin are cast to x's dtype before the
    rotation, as in JAX (in bf16 the rotation rounds in bf16).
    """
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    freqs = rope_freqs(rot, theta, x.device)
    ang = positions[..., None].float() * freqs  # (..., S, rot/2)
    while ang.dim() < xr.dim():
        ang = ang[..., None, :]  # broadcast over the head dim(s)
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp], dim=-1)


# ---------------------------------------------------------------------------
# dense MLPs
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, cfg: ModelConfig, stack=()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"wi": P.init_normal(gen, (d, 2, f), stack=stack),
                "wo": P.init_normal(gen, (f, d), stack=stack)}
    if cfg.mlp_type == "gelu":  # starcoder2
        return {"wi": P.init_normal(gen, (d, f), stack=stack),
                "wo": P.init_normal(gen, (f, d), stack=stack)}
    raise NotImplementedError(
        f"mlp_type {cfg.mlp_type!r} (RWKV's channel mix) is not ported yet "
        "(ROADMAP queue 1, item 12: hybrid and SSM)")


def _linear(x: torch.Tensor, w: torch.Tensor, k_dims: int = 1) -> torch.Tensor:
    """Contract the last ``k_dims`` axes of ``x`` with the leading ``k_dims``
    of ``w`` (an einsum such as ``...d,dgf->...gf``)."""
    k = math.prod(w.shape[:k_dims])
    lead = x.shape[: x.dim() - k_dims]
    y = torch.matmul(x.reshape(-1, k), w.reshape(k, -1))
    return y.reshape(*lead, *w.shape[k_dims:])


def mlp_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_type in ("swiglu", "geglu"):
        h = _linear(x, p["wi"])  # (..., 2, f)
        gate, up = h[..., 0, :], h[..., 1, :]
        act = Fn.silu(gate) if cfg.mlp_type == "swiglu" else Fn.gelu(gate, approximate="tanh")
        return _linear(act * up, p["wo"])
    if cfg.mlp_type == "gelu":
        return _linear(Fn.gelu(_linear(x, p["wi"]), approximate="tanh"), p["wo"])
    raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is not ported yet")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

_NEG = -1e30


def repeat_kv(k: torch.Tensor, g: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv * g, D): each KV head repeated g times in
    place (``jnp.repeat`` on the head axis)."""
    if g == 1:
        return k
    return k.repeat_interleave(g, dim=2)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: int = 0, softcap: float = 0.0,
                      mode: str = "auto") -> torch.Tensor:
    """Causal GQA attention.  q: (B, S, H, D); k, v: (B, S, Hkv, D) ->
    (B, S, H, D).

    The (B, S, H, D) tensors go to ``kernels.ops.flash_attention`` as
    (B, H, S, D) views: on the card the flash kernel reads them through
    their strides and writes an output whose (B, S, H, D) view is
    contiguous.  The JAX form's q/kv blocking (its ``cfg.attn_chunk``
    argument) is the kernel's own tiling here, as is its static block
    skipping.
    """
    o = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=True, window=window or None, softcap=softcap,
                             mode=mode)
    return o.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     t: int, window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Single-token attention over a cache, in plain torch.

    q: (B, 1, H, D); caches: (B, S, Hkv, D); t: current position.
    Positions > t (unwritten cache) and outside the window are masked.
    """
    b, _, h, d = q.shape
    s = k_cache.shape[1]
    g = h // k_cache.shape[2]
    qs = (q / math.sqrt(d)).reshape(b, h, d)
    kr = repeat_kv(k_cache, g)
    vr = repeat_kv(v_cache, g)
    logits = torch.einsum("bhd,bkhd->bhk", qs.float(), kr.float())
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    kpos = torch.arange(s, device=q.device)
    mask = kpos <= t
    if window:
        mask &= kpos > t - window
    logits = torch.where(mask[None, None, :], logits, torch.full_like(logits, _NEG))
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", p, vr.float())
    return o[:, None].to(q.dtype)


def gqa_init(gen: torch.Generator, cfg: ModelConfig, stack=()) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    p = {"wq": P.init_normal(gen, (d, h, hd), stack=stack),
         "wk": P.init_normal(gen, (d, hkv, hd), stack=stack),
         "wv": P.init_normal(gen, (d, hkv, hd), stack=stack),
         "wo": P.init_normal(gen, (h, hd, d), stack=stack)}
    if cfg.qk_norm:
        p["q_norm"] = P.init_ones((hd,), stack, device=gen.device)
        p["k_norm"] = P.init_ones((hd,), stack, device=gen.device)
    return p


def gqa_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, window: int,
              positions: torch.Tensor | None = None, kv_cache: tuple | None = None,
              t: int | None = None, mode: str = "auto"):
    """Returns (out, new_kv).

    Prefill: x (B, S, D), kv_cache None -> flash attention over the prompt;
    new_kv is the (k, v) of every position, (B, S, Hkv_eff, hd).
    Decode: x (B, 1, D), kv_cache (k, v) of shape (B, S_cache, Hkv_eff, hd),
    t = position; slot t of both caches is written in place and the caches
    are returned.
    """
    b, s, _ = x.shape
    wk, wv = p["wk"], p["wv"]
    hkv = wk.shape[1]
    if cfg.kv_heads_effective > hkv:
        rep = cfg.kv_heads_effective // hkv  # tied-copy KV padding, as JAX
        wk = wk.repeat_interleave(rep, dim=1)
        wv = wv.repeat_interleave(rep, dim=1)
    q = _linear(x, p["wq"])
    k = _linear(x, wk)
    v = _linear(x, wv)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if positions is None:
        positions = (torch.arange(s, device=x.device)[None, :] if t is None
                     else torch.full((b, 1), t, device=x.device))
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    if kv_cache is None:
        if not cfg.causal:
            raise NotImplementedError("bidirectional attention (the whisper encoder) "
                                      "is not ported yet (ROADMAP queue 1, item 12)")
        o = blocked_attention(q, k, v, window=window, softcap=cfg.logit_softcap,
                              mode=mode)
        new_kv = (k, v)
    else:
        kc, vc = kv_cache
        _cache_update(kc, k, t)
        _cache_update(vc, v, t)
        o = decode_attention(q, kc, vc, t, window=window, softcap=cfg.logit_softcap)
        new_kv = (kc, vc)
    return _linear(o, p["wo"], k_dims=2), new_kv


def _cache_update(cache: torch.Tensor, kv: torch.Tensor, t: int) -> None:
    """cache (B, S, Hkv, D)[:, t] <- kv (B, 1, Hkv, D), in place.

    JAX's ``dynamic_update_slice`` clamps a start past the end and
    overwrites the last slot; this raises instead."""
    if not 0 <= t < cache.shape[1]:
        raise ValueError(f"cache position {t} outside a cache of {cache.shape[1]}")
    cache[:, t] = kv[:, 0].to(cache.dtype)

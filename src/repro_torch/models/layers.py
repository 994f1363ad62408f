"""Transformer building blocks of the decoders: norms, RoPE, dense MLPs,
GQA attention and MLA (port of ``repro.models.layers``).

The JAX package gives attention two executable forms with one meaning:
the jnp ``blocked_attention`` and the Pallas flash kernel for the TPU.
The port has one form per device: ``blocked_attention`` calls
``kernels.ops.flash_attention``, which is the hand-written CUDA flash
kernel on the card and the plain quadratic version on the CPU.  ``mode``
("auto" | "kernel" | "reference") reaches that dispatch from every caller.
Decode-time attention over a KV cache stays plain torch, as JAX computes
it outside Pallas: grouped-query, on the cache in place (no repeated or
fp32 copy of it), at an int or a device-tensor position.

MLA (MiniCPM3) prefills in the expanded form, per-head keys and values
from the latent through the same flash kernel at (D, Dv) = (96, 64), and
decodes in the absorbed form over its latent cache, in plain torch.

Whisper's encoder self-attention and its decoder's cross-attention are
full bidirectional attention in plain fp32 torch, as JAX computes them
outside Pallas.

Linears are ``torch.matmul`` on reshaped weights (XLA's einsums); RNG is
an explicit ``torch.Generator``; ``stack`` prepends the group axis of
``models.transformer`` to every parameter.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as Fn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import params as P
from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import partitioning as PT
from repro_torch.runtime.partitioning import logical_constraint as _lc

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x = _whole_sum(x)
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _whole_sum(x: torch.Tensor) -> torch.Tensor:
    """A DTensor partial sum made whole (one all-reduce), as XLA's
    partitioner ends a contraction before a nonlinear op: left partial, a
    norm's square and its scaling would each all-reduce it again.  ``x``
    itself when it is no partial sum."""
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        return PT._Constrain.apply(x, [Replicate() if p.is_partial() else p
                                       for p in x.placements])
    return x


def rms_norm_init(dim: int, stack=(), device="cpu") -> torch.Tensor:
    return P.init_ones((dim,), stack, device=device)


NORM_AXES = ("embed",)  # JAX's logical axes of a model-width norm scale


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rope_freqs(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def rope_freqs(dim: int, theta: float, device="cpu") -> torch.Tensor:
    """The (dim / 2,) inverse frequencies, made once per (dim, theta,
    device) and shared: callers must not write into them."""
    return _rope_freqs(dim, float(theta), torch.device(device))


def _rope_angles(positions: torch.Tensor, rot: int, theta: float, ndim: int,
                 dtype: torch.dtype) -> tuple:
    """(cos, sin) in ``dtype`` of the fp32 angles positions x freqs,
    broadcastable against an ``ndim``-dimensional x[..., :rot]."""
    ang = positions[..., None].float() * rope_freqs(rot, theta, positions.device)
    while ang.dim() < ndim:
        ang = ang[..., None, :]  # broadcast over the head dim(s)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the first 2 * cos.shape[-1] dims of x in interleaved pairs."""
    rot = 2 * cos.shape[-1]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp], dim=-1) if xp.shape[-1] else out


def _rope_dims(d: int, fraction: float) -> int:
    return int(d * fraction) // 2 * 2


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S) integers.

    Rotates the first ``fraction * D`` dims (chatglm-style partial rotary).
    The angles are fp32; cos and sin are cast to x's dtype before the
    rotation, as in JAX (in bf16 the rotation rounds in bf16).
    """
    rot = _rope_dims(x.shape[-1], fraction)
    if rot == 0:
        return x
    return _rotate(x, *_rope_angles(positions, rot, theta, x.dim(), x.dtype))


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
    if cfg.mlp_type == "relu_sq":  # rwkv6 channel mix (ssm.rwkv_channel_mix)
        dev = gen.device
        return {"wk": P.init_normal(gen, (d, f), stack=stack),
                "wv": P.init_normal(gen, (f, d), stack=stack),
                "wr": P.init_normal(gen, (d, d), stack=stack),
                "mix_k": P.init_zeros((d,), stack, device=dev),
                "mix_r": P.init_zeros((d,), stack, device=dev)}
    raise ValueError(f"mlp_type {cfg.mlp_type!r}")


def mlp_axes(cfg: ModelConfig) -> dict:
    """JAX's logical axes of ``mlp_init``'s leaves (per layer)."""
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"wi": ("embed", None, "mlp"), "wo": ("mlp", "embed")}
    if cfg.mlp_type == "relu_sq":
        return {"wk": ("embed", "mlp"), "wv": ("mlp", "embed"),
                "wr": ("embed", "embed_out"), "mix_k": ("embed",), "mix_r": ("embed",)}
    return {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}


def _linear(x: torch.Tensor, w: torch.Tensor, k_dims: int = 1) -> torch.Tensor:
    """Contract the last ``k_dims`` axes of ``x`` with the leading ``k_dims``
    of ``w`` (an einsum such as ``...d,dgf->...gf``).

    A DTensor ``w`` cut on an output dim past the first (SwiGLU's ``wi``
    (d, 2, f) on "mlp", Mamba's ``in_proj`` on "inner") has that dim moved
    first before the output dims are flattened, so the flat weight stays
    cut on its columns (a flattened cut past the first dim is no placement
    a GEMM takes: DTensor would gather the whole weight), and moved back
    after."""
    k = math.prod(w.shape[:k_dims])
    lead = x.shape[: x.dim() - k_dims]
    cut = _late_cut(w, k_dims)
    if cut is not None:
        w = w.movedim(cut, k_dims)
    y = torch.matmul(x.reshape(-1, k), w.reshape(k, -1))
    y = y.reshape(*lead, *w.shape[k_dims:])
    if isinstance(y, DTensor):
        y = _GradLikeOutput.apply(y)
    return y if cut is None else y.movedim(len(lead), len(lead) + cut - k_dims)


def gather_where_batch_cut(tree, x: torch.Tensor):
    """Every DTensor leaf of ``tree`` (a layer's parameters) made whole on
    the mesh dims that cut the batch of DTensor ``x`` (its dim 0) and cut
    the leaf too: FSDP's rules put the batch and "embed" on one axis, and a
    layer's weights are gathered when it runs (again in remat's recompute).
    Their gradients stay partial sums through the backward
    (:class:`_Gathered`); the step reduce-scatters them in buckets at its
    end (``partitioning.reduce_gradients``).  Left to DTensor, a step would
    move activations between batch and feature cuts instead (a norm's scale
    cut on "embed" against a batch-cut x: the activations gathered).
    ``tree`` itself without a mesh or under rules that keep the batch off
    the weights' axes."""
    if not isinstance(x, DTensor):
        return tree
    batch = [p == Shard(0) for p in x.placements]
    if not any(batch):
        return tree

    def one(w):
        if isinstance(w, dict):
            return {k: one(v) for k, v in w.items()}
        if not isinstance(w, DTensor):
            return w
        out = [Replicate() if b and p.is_shard() else p for b, p in zip(batch, w.placements)]
        return w if out == list(w.placements) else _Gathered.apply(w, out)

    return one(tree)


class _Gathered(torch.autograd.Function):
    """DTensor ``w`` redistributed to ``placements`` (a gather), its
    gradient handed back as it comes: a partial sum (or a whole value)
    where ``w`` is cut, reduced once with the step's other gradients, not
    a leaf at a time in the backward."""

    @staticmethod
    def forward(ctx, w, placements):
        return w.redistribute(placements=placements)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _late_cut(w: torch.Tensor, k_dims: int):
    """The output dim past the first that DTensor ``w`` is cut on, or None
    (a plain tensor, or no such cut)."""
    if not isinstance(w, DTensor):
        return None
    return next((pl.dim for pl in w.placements if pl.is_shard() and pl.dim > k_dims), None)


class _GradLikeOutput(torch.autograd.Function):
    """Identity on a DTensor whose gradient is redistributed to the
    tensor's own placements.  The backward of ``_linear``'s output reshape
    flattens the gradient as the forward unflattened the product; DTensor
    may hand it a gradient cut on a dim that cannot be flattened without a
    redistribution, which a view does not make (FSDP's rules: ``wo`` cut on
    "mlp" gives the SwiGLU gradient cut on f).  Where the output is a
    partial sum, its gradient is whole."""

    @staticmethod
    def forward(ctx, y):
        # the gradient of a partial sum is whole on every rank
        ctx.placements = [Replicate() if p.is_partial() else p for p in y.placements]
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(placements=ctx.placements)


def mlp_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_type in ("swiglu", "geglu"):
        h = _linear(x, p["wi"])  # (..., 2, f)
        gate, up = h[..., 0, :], h[..., 1, :]
        act = Fn.silu(gate) if cfg.mlp_type == "swiglu" else Fn.gelu(gate, approximate="tanh")
        return _linear(act * up, p["wo"])
    if cfg.mlp_type == "gelu":
        return _linear(Fn.gelu(_linear(x, p["wi"]), approximate="tanh"), p["wo"])
    if cfg.mlp_type == "relu_sq":
        raise ValueError("rwkv channel-mix is applied via ssm.rwkv_channel_mix")
    raise ValueError(f"mlp_type {cfg.mlp_type!r}")


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
    """Causal GQA attention.  q: (B, S, H, D); k: (B, S, Hkv, D); v: (B, S,
    Hkv, Dv) -> (B, S, H, Dv), scaled by 1 / sqrt(D) (Dv may differ from D:
    MLA prefill).

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


def _bmm_f32(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    """out (fp32) <- a @ b, batched.  The products of bf16 operands are exact
    in fp32, so on the card cuBLAS takes bf16 operands with an fp32 result;
    the CPU has no such product and multiplies fp32 copies."""
    if a.is_cuda and a.dtype != torch.float32:
        torch.bmm(a, b, out_dtype=torch.float32, out=out)
    else:
        torch.bmm(a.float(), b.float(), out=out)


def _gqa_logits(q: torch.Tensor, k_cache: torch.Tensor, kpos: torch.Tensor, t,
                window: int, softcap: float):
    """Scaled (and soft-capped) fp32 logits (B, Hkv, g, S) of q (B, 1, H, D)
    against a cache (B, S, Hkv, D) whose slots hold positions ``kpos``
    (S,), and the mask (S,) of the keys q attends: positions <= t and, with
    a window, > t - window."""
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qs = (q / math.sqrt(d)).reshape(b, hkv, h // hkv, d)
    logits = torch.empty((b, hkv, h // hkv, s), dtype=torch.float32, device=q.device)
    for i in range(b):
        _bmm_f32(qs[i], k_cache[i].permute(1, 2, 0), logits[i])
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    mask = kpos <= t
    if window:
        mask &= kpos > t - window
    return logits, mask


def _gqa_values(p: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, g, S) weights (the cache's dtype) . v_cache (B, S, Hkv, D)
    -> (B, Hkv, g, D), fp32."""
    b, hkv, g, _ = p.shape
    o = torch.empty((b, hkv, g, v_cache.shape[-1]), dtype=torch.float32, device=p.device)
    for i in range(b):
        _bmm_f32(p[i], v_cache[i].transpose(0, 1), o[i])
    return o


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     t, window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Single-token grouped-query attention over a cache, in plain torch.

    q: (B, 1, H, D); caches: (B, S, Hkv, D); t: current position (an int or
    a device tensor).  Positions > t (unwritten cache) and outside the
    window are masked.  q is viewed as (B, Hkv, g, D) against the cache's
    Hkv heads: no repeated and no fp32 copy of the cache is made.  One
    sequence's cache read as (Hkv, S, D) has one batch stride, so each
    sequence's products are one strided cuBLAS call on the cache in place
    (the batch and head axes of the (B, S, Hkv, D) layout share no stride).
    Logits, mask and softmax are fp32, as in JAX; P is rounded to the cache
    dtype for P.V (fp32 accumulation), which JAX keeps in fp32.
    """
    b, _, h, d = q.shape
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    logits, mask = _gqa_logits(q, k_cache, kpos, t, window, softcap)
    p = torch.softmax(torch.where(mask, logits, _NEG), dim=-1).to(v_cache.dtype)
    return _gqa_values(p, v_cache).reshape(b, 1, h, d).to(q.dtype)


class _SeqBlocks:
    """This rank's block of a DTensor cache (B, S, ...) cut on its positions
    over the mesh dims ``dims`` (major to minor, DTensor's order of a dim
    cut on several): ``start``, the global position of its first slot, and
    the softmax across the blocks of those dims.  ``start`` follows
    DTensor's chunk rule on the global S: each mesh dim cuts what the
    dims before it left into chunks of ceil(len / n), so the last blocks of
    an S the cut does not divide are shorter or empty."""

    def __init__(self, cache, dims, s_local: int):
        mesh = cache.device_mesh
        start, length = 0, cache.shape[1]
        for d in dims:
            chunk = -(-length // mesh.size(d))
            lo = min(mesh.get_local_rank(d) * chunk, length)
            start, length = start + lo, min(chunk, length - lo)
        if length != s_local:
            raise ValueError(f"a block of {s_local} positions where DTensor's chunks of "
                             f"{cache.shape[1]} give {length}")
        self.start = start
        self.groups = [(mesh.get_group(d), mesh.size(d)) for d in dims]

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        for group, n in self.groups:
            x = PT.all_reduce(x, group, n, op=op)
        return x

    def softmax(self, logits: torch.Tensor, mask: torch.Tensor, values) -> torch.Tensor:
        """softmax over every rank's keys of ``logits`` (..., S_block), fp32,
        then times the values: ``values(p)`` gives the block's products
        (..., Dv) of unnormalised weights p.  An all-reduce MAX of the row
        maxima, then one all-reduce SUM of the products and the weights'
        sums, in fp32.  A rank whose keys are all masked, or that holds no
        slot, adds exactly 0 (its weights are exp(-1e30 - max) = 0)."""
        masked = torch.where(mask, logits, _NEG)
        local = (masked.amax(-1, keepdim=True) if masked.shape[-1]
                 else masked.new_full((*masked.shape[:-1], 1), _NEG))
        p = torch.exp(masked - self._reduce(local, dist.ReduceOp.MAX))
        both = self._reduce(torch.cat([values(p), p.sum(-1, keepdim=True)], dim=-1),
                            dist.ReduceOp.SUM)
        return both[..., :-1] / both[..., -1:]


def _block_update(cache: torch.Tensor, kv: torch.Tensor, t, start: int) -> None:
    """A cache block (B, S_block, ...) of positions [start, start +
    S_block): slot t - start <- kv (B, 1, ...) where t falls in the block,
    else the block unchanged.  The test is on the device: a device
    position is never read back."""
    n = cache.shape[1]
    if n == 0:  # an empty block (an S the cut does not divide)
        return
    pos = _position(t, cache.device).reshape(1) - start
    slot = pos.clamp(0, n - 1)
    inside = ((pos >= 0) & (pos < n)).reshape((1,) * kv.dim())
    cache.index_copy_(1, slot, torch.where(inside, kv.to(cache.dtype),
                                           cache.index_select(1, slot)))


def _seq_dims(placements) -> list:
    """The mesh dims that cut a cache (B, S, ...) on its positions."""
    return [i for i, pl in enumerate(placements) if pl == Shard(1)]


def _decode_sharded(q, k, v, k_cache, v_cache, t, window: int, softcap: float):
    """One decode step's cache write and attention on DTensors, each rank on
    its own block under ``local_map``.  No cache is gathered and no
    DTensor meets an ``out=`` op (DTensor has no strategy for
    ``index_copy_`` nor for ``bmm.out``).

    The caches' placements (batch, kv heads over "model", or positions: a
    batch too small for the data axis) are the step's: q, k and v are
    redistributed to them, whole where the caches are cut on positions.  A
    q head's kv head is in the rank's block, since the GQA groups are
    contiguous and q's heads are cut as the kv heads are.  On a cache cut
    on batch / heads the rank writes slot t of its block in place and runs
    :func:`decode_attention` there.  On a cache cut on positions the rank
    writes slot t only where t falls in its block (:func:`_block_update`),
    attends on its block with the keys' global positions (mask, window and
    softcap as ``decode_attention``'s), and the ranks combine their
    partial softmaxes (:meth:`_SeqBlocks.softmax`)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = k_cache.device_mesh
    cp = tuple(k_cache.placements)
    seq = _seq_dims(cp)
    qp = tuple(Replicate() if i in seq else pl for i, pl in enumerate(cp))

    def body(ql, kl, vl, kcl, vcl):
        if not seq:
            _cache_update(kcl, kl, t)
            _cache_update(vcl, vl, t)
            return decode_attention(ql, kcl, vcl, t, window=window, softcap=softcap)
        blocks = _SeqBlocks(k_cache, seq, kcl.shape[1])
        _block_update(kcl, kl, t, blocks.start)
        _block_update(vcl, vl, t, blocks.start)
        kpos = blocks.start + torch.arange(kcl.shape[1], device=ql.device)
        logits, mask = _gqa_logits(ql, kcl, kpos, t, window, softcap)
        o = blocks.softmax(logits, mask, lambda p: _gqa_values(p.to(vcl.dtype), vcl))
        b, _, h, d = ql.shape
        return o.reshape(b, 1, h, d).to(ql.dtype)

    q, k, v = (x.redistribute(placements=qp) for x in (q, k, v))
    return local_map(body, out_placements=list(qp), in_placements=(qp,) * 3 + (cp,) * 2,
                     device_mesh=mesh)(q, k, v, k_cache, v_cache)


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


def gqa_axes(cfg: ModelConfig) -> dict:
    """JAX's logical axes of ``gqa_init``'s leaves (per layer)."""
    p = {"wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed")}
    if cfg.qk_norm:
        p["q_norm"] = p["k_norm"] = ("head_dim",)
    return p


def gqa_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, window: int,
              positions: torch.Tensor | None = None, kv_cache: tuple | None = None,
              t=None, mode: str = "auto"):
    """Returns (out, new_kv).

    Prefill: x (B, S, D), kv_cache None -> flash attention over the prompt
    (``cfg.causal``), or the plain bidirectional attention of an encoder
    (RoPE applied all the same, as JAX does); new_kv is the (k, v) of
    every position, (B, S, Hkv_eff, hd).
    Decode: x (B, 1, D), kv_cache (k, v) of shape (B, S_cache, Hkv_eff, hd),
    t = position (an int, or a device tensor as JAX's traced ``t``); slot t
    of both caches is written in place and the caches are returned.

    k and v are projected with the stored Hkv heads and then repeated to
    ``kv_heads_effective`` (the tied-copy KV padding): each repeated head is
    the same dot products as JAX's projection by repeated weights, and a
    decode step reads Hkv / Hkv_eff of wk and wv.
    """
    b, s, _ = x.shape
    q = _lc(_linear(x, p["wq"]), ("batch", "seq", "heads", None))
    k = _lc(_linear(x, p["wk"]), ("batch", "seq", "kv_heads", None))
    v = _lc(_linear(x, p["wv"]), ("batch", "seq", "kv_heads", None))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if positions is None:
        positions = (torch.arange(s, device=x.device)[None, :] if t is None
                     else _position(t, x.device).expand(b, 1))
    rot = _rope_dims(q.shape[-1], cfg.rope_fraction)
    if rot:
        cos, sin = _rope_angles(positions, rot, cfg.rope_theta, q.dim(), q.dtype)
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    rep = cfg.kv_heads_effective // k.shape[2]
    if rep > 1:  # JAX constrains the Hkv_eff heads of its repeated weights
        k, v = (_lc(repeat_kv(t, rep), ("batch", "seq", "kv_heads", None))
                for t in (k, v))
    if kv_cache is None:
        if cfg.causal:
            o = blocked_attention(q, k, v, window=window, softcap=cfg.logit_softcap,
                                  mode=mode)
        else:  # the encoder's self-attention (Whisper): full, bidirectional
            o = _bidirectional_attention(q, k, v)
        new_kv = (k, v)
    else:
        kc, vc = kv_cache
        if isinstance(kc, DTensor):  # a mesh's decode step
            o = _decode_sharded(q, k, v, kc, vc, t, window, cfg.logit_softcap)
        else:
            _cache_update(kc, k, t)
            _cache_update(vc, v, t)
            o = decode_attention(q, kc, vc, t, window=window, softcap=cfg.logit_softcap)
        new_kv = (kc, vc)
    return _linear(o, p["wo"], k_dims=2), new_kv


def _bidirectional_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """Full bidirectional GQA attention (the Whisper encoder, the decoder's
    cross-attention) in plain torch, JAX's form: q (B, Sq, H, D), k / v (B,
    Sk, Hkv, D) repeated to H heads, logits, softmax and P.V in fp32 (P is
    not rounded), the output cast back to q's dtype."""
    d = q.shape[-1]
    g = q.shape[2] // k.shape[2]
    kr, vr = repeat_kv(k, g), repeat_kv(v, g)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) / math.sqrt(d)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr.float()).to(q.dtype)


def cross_attention_apply(p: dict, x: torch.Tensor, enc_k: torch.Tensor,
                          enc_v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The decoder's cross-attention (Whisper) over the encoder's K/V, (B,
    S_enc, Hkv, D): no RoPE, no mask."""
    o = _bidirectional_attention(_linear(x, p["wq"]), enc_k, enc_v)
    return _linear(o, p["wo"], k_dims=2)


def cross_kv(p: dict, enc_out: torch.Tensor) -> tuple:
    """One layer's cross-attention K/V of the encoder output (B, S_enc, d)."""
    return _linear(enc_out, p["wk"]), _linear(enc_out, p["wv"])


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (MiniCPM3)
# ---------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg: ModelConfig, stack=()) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dev = gen.device
    return {"w_dq": P.init_normal(gen, (d, qr), stack=stack),
            "q_norm": P.init_ones((qr,), stack, device=dev),
            "w_uq": P.init_normal(gen, (qr, h, dn + dr), stack=stack),
            "w_dkv": P.init_normal(gen, (d, kvr), stack=stack),
            "kv_norm": P.init_ones((kvr,), stack, device=dev),
            "w_kr": P.init_normal(gen, (d, dr), stack=stack),
            "w_uk": P.init_normal(gen, (kvr, h, dn), stack=stack),
            "w_uv": P.init_normal(gen, (kvr, h, dv), stack=stack),
            "wo": P.init_normal(gen, (h, dv, d), stack=stack)}


MLA_AXES = {"w_dq": ("embed", "q_lora"), "q_norm": ("q_lora",),
            "w_uq": ("q_lora", "heads", "head_dim"), "w_dkv": ("embed", "kv_lora"),
            "kv_norm": ("kv_lora",), "w_kr": ("embed", "head_dim"),
            "w_uk": ("kv_lora", "heads", "head_dim"),
            "w_uv": ("kv_lora", "heads", "head_dim"), "wo": ("heads", "head_dim", "embed")}


def _mla_logits(q_nope: torch.Tensor, q_rope: torch.Tensor, ckv_cache: torch.Tensor,
                krope_cache: torch.Tensor, w_uk: torch.Tensor, kpos: torch.Tensor, t):
    """MLA's absorbed fp32 logits (B, H, S) over latent caches whose slots
    hold positions ``kpos`` (S,), scaled, and the mask (S,) of positions
    <= t."""
    b, _, h, dn = q_nope.shape
    s, dr = krope_cache.shape[1], krope_cache.shape[2]
    # (H, B, dn) @ (H, dn, kvr) -> (B, H, kvr)
    q_abs = torch.bmm(q_nope[:, 0].transpose(0, 1), w_uk.permute(1, 2, 0)).transpose(0, 1)
    logits = torch.empty((b, h, s), dtype=torch.float32, device=q_nope.device)
    rope = torch.empty_like(logits)
    _bmm_f32(q_abs, ckv_cache.transpose(1, 2), logits)
    _bmm_f32(q_rope[:, 0], krope_cache.transpose(1, 2), rope)
    return (logits + rope) * (1.0 / math.sqrt(dn + dr)), kpos <= t


def _mla_latent(probs: torch.Tensor, ckv_cache: torch.Tensor) -> torch.Tensor:
    """(B, H, S) weights (the cache's dtype) . ckv (B, S, kvr) -> (B, H,
    kvr), fp32."""
    o_lat = torch.empty(probs.shape[:2] + ckv_cache.shape[2:], dtype=torch.float32,
                        device=probs.device)
    _bmm_f32(probs, ckv_cache, o_lat)
    return o_lat


def _mla_out(o_lat: torch.Tensor, w_uv: torch.Tensor) -> torch.Tensor:
    """(H, B, kvr) @ (H, kvr, dv) -> (B, H, dv), fp32."""
    return torch.bmm(o_lat.transpose(0, 1), w_uv.float().transpose(0, 1)).transpose(0, 1)


def mla_decode_attention(q_nope: torch.Tensor, q_rope: torch.Tensor,
                         ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
                         w_uk: torch.Tensor, w_uv: torch.Tensor, t) -> torch.Tensor:
    """MLA's absorbed single-token attention over its latent cache, in plain
    torch: scores in the kv_lora space, no per-head key or value made.

    q_nope (B, 1, H, dn), q_rope (B, 1, H, dr) (rotated); caches ckv (B, S,
    kvr), krope (B, S, dr); w_uk (kvr, H, dn), w_uv (kvr, H, dv); t the
    position (an int or a device tensor; keys past it masked).  Returns o
    (B, H, dv) in fp32.  As JAX: q_abs = q_nope . w_uk in the model dtype,
    logits, mask and softmax in fp32, o_lat . w_uv in fp32.  The cache is
    read in place, never copied to fp32: bf16 products are exact in fp32
    (``_bmm_f32``), and P is rounded to the cache dtype for P . ckv (fp32
    accumulation), which JAX keeps in fp32, as ``decode_attention`` does.
    """
    kpos = torch.arange(krope_cache.shape[1], device=q_nope.device)
    logits, mask = _mla_logits(q_nope, q_rope, ckv_cache, krope_cache, w_uk, kpos, t)
    probs = torch.softmax(torch.where(mask, logits, _NEG), dim=-1).to(ckv_cache.dtype)
    return _mla_out(_mla_latent(probs, ckv_cache), w_uv)


def _mla_decode_sharded(q_nope, q_rope, c_kv, k_rope, ckv_cache, krope_cache,
                        w_uk, w_uv, t) -> torch.Tensor:
    """MLA's decode step on DTensors, each rank on its own block under
    ``local_map``, as :func:`_decode_sharded` for GQA: no cache is
    gathered and no DTensor meets an ``out=`` op.

    The latent caches (B, S, kvr) and (B, S, dr) are cut on batch (or, a
    batch too small for the data axis, on positions); q's heads and w_uk /
    w_uv are cut on heads where w_uk is (over "model", the step's
    placements), and whole on a mesh dim that cuts the caches.  The new
    latent entries c_kv / k_rope (B, 1, ...) follow the caches' batch cut.
    A cache cut on batch: the rank writes slot t of its block and runs
    :func:`mla_decode_attention` there; cut on positions: the block write
    and the softmax across ranks of ``_decode_sharded``, on the latent
    products before w_uv.  Returns o (B, H, dv) fp32, cut on batch and
    heads as q."""
    from torch.distributed.tensor.experimental import local_map

    mesh = ckv_cache.device_mesh
    cp = tuple(ckv_cache.placements)
    if any(pl.is_shard() and pl.dim > 1 for pl in cp):
        raise NotImplementedError(f"a latent cache cut on its features: {cp}")
    seq = _seq_dims(cp)
    heads = [isinstance(w_uk, DTensor) and w_uk.placements[i] == Shard(1) and cp[i] == Replicate()
             for i in range(len(cp))]
    batch = [pl == Shard(0) for pl in cp]
    qp = tuple(Shard(0) if bt else Shard(2) if hd else Replicate()
               for bt, hd in zip(batch, heads))
    wp = tuple(Shard(1) if hd else Replicate() for hd in heads)
    lp = tuple(Shard(0) if bt else Replicate() for bt in batch)
    op = tuple(Shard(0) if bt else Shard(1) if hd else Replicate()
               for bt, hd in zip(batch, heads))

    def body(qn, qr, ckl, krl, ckc, krc, wuk, wuv):
        if not seq:
            _cache_update(ckc, ckl, t)
            _cache_update(krc, krl, t)
            return mla_decode_attention(qn, qr, ckc, krc, wuk, wuv, t)
        blocks = _SeqBlocks(ckv_cache, seq, ckc.shape[1])
        _block_update(ckc, ckl, t, blocks.start)
        _block_update(krc, krl, t, blocks.start)
        kpos = blocks.start + torch.arange(ckc.shape[1], device=qn.device)
        logits, mask = _mla_logits(qn, qr, ckc, krc, wuk, kpos, t)
        o_lat = blocks.softmax(logits, mask, lambda p: _mla_latent(p.to(ckc.dtype), ckc))
        return _mla_out(o_lat, wuv)

    return local_map(body, out_placements=list(op),
                     in_placements=(qp, qp, lp, lp, cp, cp, wp, wp),
                     device_mesh=mesh, redistribute_inputs=True)(
        q_nope, q_rope, c_kv, k_rope, ckv_cache, krope_cache, w_uk, w_uv)


def mla_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor | None = None, cache: tuple | None = None,
              t=None, mode: str = "auto"):
    """MLA attention.  Returns (out (B, S, D), (c_kv, k_rope)).

    Prefill (cache None): the expanded form.  Per-head k_nope and v from
    the latent c_kv, k_rope (B, S, dr) shared by every head; the key
    [k_nope ; k_rope] is made contiguous (B, S, H, dn + dr) and
    ``blocked_attention`` runs at (D, Dv) = (dn + dr, dv): the flash kernel
    at (96, 64) for MiniCPM3.  Returns the prompt's (c_kv, k_rope), the
    latent cache (B, S, kvr), (B, S, dr).
    Decode (cache (ckv, krope), t): slot t of both caches is written in
    place (an int or a device position) and ``mla_decode_attention``
    scores in the latent space (on DTensor caches each rank on its block:
    ``_mla_decode_sharded``); the caches are returned.
    """
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    if positions is None:
        positions = (torch.arange(s, device=x.device)[None, :] if t is None
                     else _position(t, x.device).expand(b, 1))
    q_lat = rms_norm(_linear(x, p["w_dq"]), p["q_norm"])
    q = _linear(q_lat, p["w_uq"])  # (B, S, H, dn + dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    c_kv = rms_norm(_linear(x, p["w_dkv"]), p["kv_norm"])
    k_rope = apply_rope(_linear(x, p["w_kr"]), positions, cfg.rope_theta)  # (B, S, dr)
    if cache is None:
        k_nope = _linear(c_kv, p["w_uk"])  # (B, S, H, dn)
        v = _linear(c_kv, p["w_uv"])  # (B, S, H, dv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
        o = blocked_attention(torch.cat([q_nope, q_rope], dim=-1), k, v, mode=mode)
        return _linear(o, p["wo"], k_dims=2), (c_kv, k_rope)
    ckv_cache, krope_cache = cache
    if isinstance(ckv_cache, DTensor):  # a mesh's decode step
        o = _mla_decode_sharded(q_nope, q_rope, c_kv, k_rope, ckv_cache, krope_cache,
                                p["w_uk"], p["w_uv"], t)
    else:
        _cache_update(ckv_cache, c_kv, t)
        _cache_update(krope_cache, k_rope, t)
        o = mla_decode_attention(q_nope, q_rope, ckv_cache, krope_cache, p["w_uk"],
                                 p["w_uv"], t)
    return _linear(o.to(x.dtype)[:, None], p["wo"], k_dims=2), (ckv_cache, krope_cache)


def _position(t, device) -> torch.Tensor:
    """A decode position as a (1, 1) int64 tensor on ``device``: a device
    tensor is viewed, an int is made there (no host synchronisation)."""
    if isinstance(t, torch.Tensor):
        return t.reshape(1, 1)
    return torch.full((1, 1), t, dtype=torch.long, device=device)


def _cache_update(cache: torch.Tensor, kv: torch.Tensor, t) -> None:
    """cache (B, S, ...)[:, t] <- kv (B, 1, ...), in place, at an int or
    device-tensor position (a GQA cache (B, S, Hkv, D), MLA's latent ones
    (B, S, kvr) and (B, S, dr)).

    JAX's ``dynamic_update_slice`` clamps a start past the end and
    overwrites the last slot; an int position past the cache raises
    instead.  A device position is not read back (that would synchronise):
    ``LMServer`` refuses a configuration that would decode past its cache."""
    if not isinstance(t, torch.Tensor) and not 0 <= t < cache.shape[1]:
        raise ValueError(f"cache position {t} outside a cache of {cache.shape[1]}")
    cache.index_copy_(1, _position(t, cache.device).reshape(1), kv.to(cache.dtype))

"""State-space mixers: Mamba (Jamba's 7 of 8 layers) and RWKV-6 "Finch"
(port of ``repro.models.ssm``).

Both recurrences are plain torch, as the JAX package computes them outside
any Pallas kernel (``lax.associative_scan`` / ``lax.scan``).  Each module
is functional, as JAX's: ``state=`` (decode, one token) takes the
recurrent state and ``return_state=`` (prefill) returns the final one, as
new tensors; ``models.transformer`` copies them into the cache in place.
Nothing reads a value back to the host and every loop bound comes from a
static shape, so a CUDA graph captures prefill and decode.

Mamba: the selective SSM h_t = da_t * h_{t-1} + db_t over chunks of
``cfg.ssm_chunk`` tokens.  JAX scans a chunk associatively (log depth)
and pads S to a chunk multiple with identity steps; the port runs a
chunk's steps in order, one fused multiply-add a token over the (B, di,
ds) state, and its last chunk is just shorter (an identity step leaves h
as it is, so the final state is the same).  y is reduced per chunk, so
at most one chunk's states exist at a time.
RWKV-6: data-dependent-decay linear attention, per-head (hd x hd) state
updated per token: a prefill of S tokens runs S steps of three kernels
each (r . state, the decay, the k v^T outer product); the u-bonus term is
taken out of the loop (the same sum as JAX's r . (state + u k v^T),
in another order).
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn

from repro_torch import params as P
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _linear
from repro_torch.runtime.partitioning import local_blocks
from repro_torch.runtime.partitioning import logical_constraint as _lc
from torch.distributed.tensor import DTensor

# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


def mamba_init(gen: torch.Generator, cfg: ModelConfig, stack=()) -> dict:
    d, di, ds, dc = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    dtr = max(d // 16, 1)
    dev = gen.device
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(
        tuple(stack) + (di, ds))
    return {"in_proj": P.init_normal(gen, (d, 2, di), stack=stack),
            "conv_w": P.init_normal(gen, (dc, di), scale=0.5, stack=stack),
            "conv_b": P.init_zeros((di,), stack, device=dev),
            "x_proj": P.init_normal(gen, (di, dtr + 2 * ds), stack=stack),
            "dt_proj": P.init_normal(gen, (dtr, di), stack=stack),
            "dt_bias": P.init_zeros((di,), stack, device=dev),
            "a_log": P.cast_leaf(torch.log(a)),
            "d_skip": P.init_ones((di,), stack, device=dev),
            "out_proj": P.init_normal(gen, (di, d), stack=stack)}


MAMBA_AXES = {"in_proj": ("embed", None, "inner"), "conv_w": (None, "inner"),
              "conv_b": ("inner",), "x_proj": ("inner", None), "dt_proj": (None, "inner"),
              "dt_bias": ("inner",), "a_log": ("inner", "state"), "d_skip": ("inner",),
              "out_proj": ("inner", "embed")}  # JAX's logical axes, per layer


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv.  x: (B, S, di); w: (dc, di); state: (B, dc-1,
    di), the last dc-1 inputs (decode).  Returns (y, new_state)."""
    dc, s = w.shape[0], x.shape[1]
    pad = (torch.zeros_like(x[:, : dc - 1]) if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)  # (B, S + dc - 1, di)
    y = xp[:, 0:s] * w[0]
    for i in range(1, dc):  # JAX's sum() order: ((t0 + t1) + t2) + ...
        y = y + xp[:, i:i + s] * w[i]
    return y + b, xp[:, -(dc - 1):]


def _ssm_params(p: dict, xi: torch.Tensor, cfg: ModelConfig):
    """xi: (B, S, di) -> (da, db, c), da / db (B, S, di, ds) and c (B, S,
    ds), all fp32 (computed in xi's dtype, as JAX)."""
    ds = cfg.d_state
    dtr = p["dt_proj"].shape[0]
    xdbc = _linear(xi, p["x_proj"])
    dt, b_, c = xdbc[..., :dtr], xdbc[..., dtr:dtr + ds], xdbc[..., dtr + ds:]
    dt = Fn.softplus(_linear(dt, p["dt_proj"]) + p["dt_bias"])
    a = -torch.exp(p["a_log"])  # (di, ds), negative
    da = torch.exp(dt[..., None] * a)  # (B, S, di, ds) in (0, 1)
    db = (dt * xi)[..., None] * b_[:, :, None, :]
    return da.float(), db.float(), c.float()


def _differentiable(*ts: torch.Tensor) -> bool:
    """Whether autograd records an op on ``ts``: the train step's scans then
    build their outputs out of place (autograd refuses ``out=`` and in-place
    writes on tensors that require grad), with the same ops and values."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _chunk_scan(da: torch.Tensor, db: torch.Tensor, h0: torch.Tensor):
    """h_t = da_t * h_{t-1} + db_t over one chunk, in order.  da / db: (B,
    C, di, ds); h0: (B, di, ds).  Returns (h_all (B, C, di, ds), h_last)."""
    h = h0
    if _differentiable(da, db, h0):
        hs = []
        for i in range(da.shape[1]):
            h = torch.addcmul(db[:, i], da[:, i], h)
            hs.append(h)
        return torch.stack(hs, 1), h
    h_all = torch.empty_like(db)
    for i in range(da.shape[1]):
        h = torch.addcmul(db[:, i], da[:, i], h, out=h_all[:, i])
    return h_all, h


def _mamba_scan(da: torch.Tensor, db: torch.Tensor, c: torch.Tensor, ck: int):
    """The scan over a whole sequence in chunks of ``ck`` tokens: da / db
    (B, S, di, ds), c (B, S, ds) -> (y (B, S, di), the final state (B, di,
    ds))."""
    b, s = da.shape[:2]
    h = torch.zeros((b, da.shape[2], da.shape[3]), dtype=torch.float32, device=da.device)
    ys = []
    for c0 in range(0, s, ck):
        h_all, h = _chunk_scan(da[:, c0:c0 + ck], db[:, c0:c0 + ck], h)
        ys.append(torch.matmul(h_all, c[:, c0:c0 + ck, :, None])[..., 0])
    return torch.cat(ys, 1), h


def mamba_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
                state: dict | None = None, return_state: bool = False):
    """x: (B, S, D).  state (decode): {"conv": (B, dc-1, di), "ssm": (B, di,
    ds)}; ``return_state`` (prefill) returns the final state.  Returns (out
    (B, S, D), new_state or None)."""
    b, s, _ = x.shape
    xz = _linear(x, p["in_proj"])  # (B, S, 2, di)
    xz = _lc(xz, ("batch", "seq", None, "inner"))  # d_inner stays on model
    xi, z = xz[..., 0, :], xz[..., 1, :]
    xi, new_conv = _causal_conv(xi, p["conv_w"], p["conv_b"],
                                state["conv"] if state is not None else None)
    xi = Fn.silu(xi)
    da, db, c = _ssm_params(p, xi, cfg)
    if state is not None and s == 1:  # decode: one recurrence step
        h = torch.addcmul(db[:, 0], da[:, 0], state["ssm"])  # (B, di, ds)
        y = torch.matmul(h, c[:, 0, :, None]).transpose(1, 2)  # (B, 1, di)
        new_state = {"conv": new_conv.to(state["conv"].dtype), "ssm": h}
    else:  # train / prefill: the scan chunk by chunk, y reduced per chunk
        ck = min(cfg.ssm_chunk, s)
        if isinstance(da, DTensor):  # each rank its (batch, inner) block
            y, h = local_blocks(_mamba_scan, da, (0, 2), (da, db, c, ck),
                                ((0, 2), (0, 2), (0,), None), ((0, 2), (0, 1)))
        else:
            y, h = _mamba_scan(da, db, c, ck)
        new_state = None
        if return_state or state is not None:  # prefill
            new_state = {"conv": new_conv.to(x.dtype), "ssm": h}
    y = y + xi * p["d_skip"]
    # the gate in the model dtype, as JAX
    y = y.to(x.dtype) * Fn.silu(z)
    return _linear(y, p["out_proj"]), new_state


# ---------------------------------------------------------------------------
# RWKV-6 (Finch)
# ---------------------------------------------------------------------------

_RWKV_LORA = 32


def rwkv6_init(gen: torch.Generator, cfg: ModelConfig, stack=()) -> dict:
    d = cfg.d_model
    r = _RWKV_LORA
    dev = gen.device
    # the rwkv init curve of the decay, JAX's w0
    decay = -5.0 + 8.0 * (torch.arange(d, dtype=torch.float32, device=dev)
                          / max(d - 1, 1)) ** 0.7
    return {
        # ddlerp token-shift mixers: 5 targets (w, k, v, r, g) + base mix_x
        "mix_x": P.init_zeros((d,), stack, device=dev),
        "mix_wkvrg": P.init_zeros((5, d), stack, device=dev),
        "lora_a": P.init_normal(gen, (d, 5, r), scale=0.01, stack=stack),
        "lora_b": P.init_normal(gen, (5, r, d), scale=0.01, stack=stack),
        # projections
        "wr": P.init_normal(gen, (d, d), stack=stack),
        "wk": P.init_normal(gen, (d, d), stack=stack),
        "wv": P.init_normal(gen, (d, d), stack=stack),
        "wg": P.init_normal(gen, (d, d), stack=stack),
        "wo": P.init_normal(gen, (d, d), stack=stack),
        # data-dependent decay
        "w0": P.cast_leaf(decay.expand(tuple(stack) + (d,)).clone()),
        "wd_a": P.init_normal(gen, (d, 2 * r), scale=0.01, stack=stack),
        "wd_b": P.init_normal(gen, (2 * r, d), scale=0.01, stack=stack),
        "u": P.init_normal(gen, (d,), scale=0.5, stack=stack),
        # per-head group norm
        "gn_scale": P.init_ones((d,), stack, device=dev),
        "gn_bias": P.init_zeros((d,), stack, device=dev),
    }


RWKV6_AXES = {"mix_x": ("embed",), "mix_wkvrg": (None, "embed"),
              "lora_a": ("embed", None, None), "lora_b": (None, None, "embed"),
              **{w: ("embed", "heads_flat") for w in ("wr", "wk", "wv", "wg")},
              "wo": ("heads_flat", "embed"), "w0": ("embed",), "wd_a": ("embed", None),
              "wd_b": (None, "embed"), "u": ("embed",), "gn_scale": ("embed",),
              "gn_bias": ("embed",)}  # JAX's logical axes, per layer


def _token_shift(x: torch.Tensor, last: torch.Tensor | None = None) -> torch.Tensor:
    """x_{t-1} with a zero (or carried) boundary.  x: (B, S, D)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


def _wkv_scan(rf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor, w: torch.Tensor):
    """RWKV-6's recurrence over a whole sequence, the u-bonus left out: r /
    k / v / decay (B, S, H, hd) fp32 -> (y (B, S, H, hd), the final state
    (B, H, hd, hd))."""
    b, s, h, hd = rf.shape
    # time-major copies, so that each step reads contiguous (B, H, hd)
    rs, ks, vs, ws = (t_.transpose(0, 1).contiguous() for t_ in (rf, kf, vf, w))
    st = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=rf.device)
    if _differentiable(rs, ks, vs, ws):  # train: the same steps, out of place
        steps = []
        for i in range(s):
            steps.append(torch.matmul(rs[i][..., None, :], st))
            st = torch.addcmul(st * ws[i][..., None], ks[i][..., None],
                               vs[i][..., None, :])
        outs = torch.stack(steps)
    else:
        outs = torch.empty((s, b, h, 1, hd), dtype=torch.float32, device=rf.device)
        for i in range(s):
            torch.matmul(rs[i][..., None, :], st, out=outs[i])
            st.mul_(ws[i][..., None]).addcmul_(ks[i][..., None], vs[i][..., None, :])
    return outs[:, :, :, 0].transpose(0, 1), st


def rwkv6_time_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                   state: dict | None = None, return_state: bool = False):
    """RWKV-6 time mixing.  x: (B, S, D); state (decode): {"shift": (B, 1,
    D), "wkv": (B, H, hd, hd)}.  Returns (out (B, S, D), new_state or
    None)."""
    b, s, d = x.shape
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    prev = _token_shift(x, state["shift"] if state is not None else None)
    dx = prev - x
    xxx = x + dx * p["mix_x"]
    lat = torch.tanh(_linear(xxx, p["lora_a"]))  # (B, S, 5, r)
    lora = torch.bmm(lat.reshape(b * s, 5, -1).transpose(0, 1), p["lora_b"])  # (5, BS, D)
    mixed = x[None] + dx[None] * (p["mix_wkvrg"][:, None, None, :]
                                  + lora.reshape(5, b, s, d))
    xw, xk, xv, xr, xg = mixed.unbind(0)
    r = _linear(xr, p["wr"]).reshape(b, s, h, hd)
    k = _linear(xk, p["wk"]).reshape(b, s, h, hd)
    v = _linear(xv, p["wv"]).reshape(b, s, h, hd)
    g = Fn.silu(_linear(xg, p["wg"]))
    dd = _linear(torch.tanh(_linear(xw, p["wd_a"])), p["wd_b"])
    w = torch.exp(-torch.exp((p["w0"] + dd).float())).reshape(b, s, h, hd)  # (0, 1)
    u = p["u"].reshape(h, hd)
    rf, kf, vf = r.float(), k.float(), v.float()
    # the u-bonus of every token at once: (r . (u * k)) v
    bonus = torch.sum(rf * u * kf, dim=-1, keepdim=True) * vf  # (B, S, H, hd)
    if state is not None and s == 1:
        st = state["wkv"]  # (B, H, hd_k, hd_v)
        y = torch.matmul(rf[:, 0, :, None, :], st)[:, None, :, 0] + bonus
        new_st = torch.addcmul(kf[:, 0, :, :, None] * vf[:, 0, :, None, :],
                               w[:, 0, :, :, None], st)
        new_state = {"shift": x[:, -1:].to(state["shift"].dtype), "wkv": new_st}
    else:
        if isinstance(rf, DTensor):  # each rank its (batch, heads) block
            y, st = local_blocks(_wkv_scan, rf, (0, 2), (rf, kf, vf, w),
                                 ((0, 2),) * 4, ((0, 2), (0, 1)))
        else:
            y, st = _wkv_scan(rf, kf, vf, w)
        y = y + bonus  # (B, S, H, hd)
        new_state = None
        if return_state or state is not None:
            new_state = {"shift": x[:, -1:].to(x.dtype), "wkv": st}
    # per-head group norm, gate, out-proj
    mu = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, unbiased=False)
    yn = ((y - mu) * torch.rsqrt(var + 64e-5)).reshape(b, -1, d)
    yn = (yn * p["gn_scale"] + p["gn_bias"]).to(x.dtype)
    return _linear(yn * g, p["wo"]), new_state


def rwkv_channel_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     state: dict | None = None, return_state: bool = False):
    """RWKV-6 channel mix with token shift.  state: {"shift": (B, 1, D)}."""
    prev = _token_shift(x, state["shift"] if state is not None else None)
    dx = prev - x
    xk = x + dx * p["mix_k"]
    xr = x + dx * p["mix_r"]
    k = torch.square(torch.relu(_linear(xk, p["wk"])))
    out = torch.sigmoid(_linear(xr, p["wr"])) * _linear(k, p["wv"])
    new_state = None
    if return_state or state is not None:
        new_state = {"shift": x[:, -1:].to(x.dtype)}
    return out, new_state

"""Plain PyTorch versions of the port's kernels (the correctness contract).

Port of ``repro.kernels.ref``.
Each ``*_ref`` defines the exact semantics its CUDA kernel must match; on
CPU tensors the wrappers in ``kernels/ops.py`` run these, and
``chip_smoke.py`` holds the kernels against them on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as Fn

from repro_torch.core import scatter_gather as sg
from repro_torch.core.ieee import div_rn, sqrt_rn


def segment_reduce_sorted_ref(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
    op: str = "sum",
) -> torch.Tensor:
    """Segment reduction over sorted ids; ids >= num_segments are padding,
    empty segments produce 0 for every op."""
    valid = segment_ids < num_segments
    v = torch.where(valid[:, None], values, torch.zeros_like(values)).float()
    count = sg.segment_sum(valid.float(), segment_ids, num_segments)[:, None]
    if op == "sum":
        out = sg.segment_sum(v, segment_ids, num_segments)
    elif op == "mean":
        out = sg.segment_sum(v, segment_ids, num_segments) / torch.clamp(count, min=1.0)
    elif op == "sqsum":
        out = sg.segment_sum(v * v, segment_ids, num_segments)
    elif op in ("max", "min"):
        out = sg._segment_extremum(values.float(), segment_ids, num_segments, op)
        out = torch.where(count > 0, out, torch.zeros_like(out))
    else:
        raise ValueError(f"unknown op {op!r}")
    return out.to(values.dtype)


def edge_softmax_ref(
    logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
) -> torch.Tensor:
    """Numerically stable per-destination softmax over sorted edges (GAT).

    logits (E, H); returns (E, H) weights that sum to 1 within each
    (segment, head); padding edges (ids >= num_segments) get weight 0.
    """
    valid = (segment_ids < num_segments)[:, None]
    ids = sg._sink_ids(segment_ids, num_segments)
    lm = torch.where(valid, logits.float(), torch.full_like(logits.float(), float("-inf")))
    seg_max = sg._segment_extremum(lm, segment_ids, num_segments, "max")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    # one zero row for the padding ids' sink
    seg_max = torch.cat([seg_max, seg_max.new_zeros((1, seg_max.shape[1]))])
    z = torch.exp(lm - seg_max[ids])
    z = torch.where(valid, z, torch.zeros_like(z))
    seg_sum = sg.segment_sum(z, segment_ids, num_segments)
    seg_sum = torch.cat([seg_sum, seg_sum.new_zeros((1, seg_sum.shape[1]))])
    return (z / torch.clamp(seg_sum[ids], min=1e-30)).to(logits.dtype)


def _activate(y: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.clamp(y, min=0.0)
    if activation == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return Fn.gelu(y, approximate="tanh")
    if activation != "none":
        raise ValueError(f"unknown activation {activation!r}")
    return y


def node_mlp_ref(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, activation: str = "relu"
) -> torch.Tensor:
    """Fused linear + bias + activation: x (M, K), w (K, N), b (N,)."""
    y = torch.matmul(x.float(), w.float()) + b.float()
    return _activate(y, activation).to(x.dtype)


# int8 x int8 partial products fit an f32 mantissa while
# |x| * |w| * K <= 128 * 127 * K < 2^24, i.e. K <= 1032: under that bound an
# f32 matmul over the integer-valued operands is bit-identical to an int32
# accumulator (and runs on every device; CUDA has no int32 matmul).
_EXACT_EMU_MAX_K = 1024


def _int8_accumulate(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N) int8 matmul with exact accumulation, returned f32.
    Past ``_EXACT_EMU_MAX_K`` the depth is cut into exact f32 chunks whose
    integer partial sums add in int64."""
    k = x_q.shape[-1]
    if k <= _EXACT_EMU_MAX_K:
        return torch.matmul(x_q.float(), w_q.float())
    acc = None
    for k0 in range(0, k, _EXACT_EMU_MAX_K):
        part = torch.matmul(x_q[:, k0:k0 + _EXACT_EMU_MAX_K].float(),
                            w_q[k0:k0 + _EXACT_EMU_MAX_K].float()).to(torch.int64)
        acc = part if acc is None else acc + part
    return acc.float()


def quant_node_mlp_ref(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    b: torch.Tensor,
    activation: str = "relu",
    row_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Quantized fused linear (int8 NE PE): exact int32 accumulate, then
    ``act((acc * scale) * row_scale + b)``, each step rounded once.

    x_q (M, K) int8; w_q (K, N) int8; scale (N,) or () f32 per output
    channel; row_scale (M, 1) f32 per row (dynamic per-node scales; None
    -> 1); b (N,) f32.
    """
    y = _int8_accumulate(x_q, w_q) * scale.float()
    if row_scale is not None:
        y = y * row_scale.float()
    y = y + b.float()
    return _activate(y, activation)


# floor of the dynamic per-row activation scale: must equal
# ``quant.qconfig._EPS`` so the fused gamma reproduces the unfused
# ``quantized_linear`` dynamic recipe
_ROW_EPS = 1e-8


def quantize_rows(x: torch.Tensor):
    """The int8-dynamic row recipe: exact-range symmetric scales
    ``rs = max(max|x_row|, 1e-8) / 127`` (M, 1) and ``q = clamp(round(x /
    rs), -128, 127)`` (M, K), integer-valued f32; IEEE divisions, ties to
    even.  -> (q, rs)."""
    x = x.float()
    rs = div_rn(torch.clamp(torch.abs(x).amax(dim=-1, keepdim=True), min=_ROW_EPS),
                127.0)
    return torch.clamp(torch.round(x / rs), -128.0, 127.0), rs


def quant_node_mlp_dynamic_ref(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    b: torch.Tensor,
    activation: str = "none",
) -> torch.Tensor:
    """The int8-dynamic linear: rows of f32 ``x`` (M, K) quantized by
    :func:`quantize_rows`, then :func:`quant_node_mlp_ref` with the row
    scales, ``act(((acc * w_scale) * rs) + b)``."""
    q, rs = quantize_rows(x)
    return quant_node_mlp_ref(q.to(torch.int8), w_q, w_scale, b, activation,
                              row_scale=rs)


def _fused_gamma_linear(x, w1, b1, w1_scale, precision: str) -> torch.Tensor:
    """gamma's first linear + relu, fp32 or the in-pass W8A8 boundary.

    int8: exact-range symmetric per-row quantization of ``x``
    (:func:`quantize_rows`), exact int8 accumulation, one requantize tail
    ``acc * (row_scale * w_scale) + b`` (the fused kernel's order, not the
    unfused linear's).
    """
    if precision == "int8":
        q, rs = quantize_rows(x)
        y = _int8_accumulate(q, w1) * (rs * w1_scale.float()) + b1
    else:
        y = torch.matmul(x, w1.float()) + b1
    return torch.clamp(y, min=0.0)


def fused_mp_ref(
    spec,
    ids_sorted: torch.Tensor,
    src_sorted: torch.Tensor,
    in_degree: torch.Tensor,
    node_mask: torch.Tensor,
    msrc: torch.Tensor,
    x_res: torch.Tensor,
    nop: torch.Tensor | None = None,
    eop: torch.Tensor | None = None,
    ew: torch.Tensor | None = None,
    w1: torch.Tensor | None = None,
    b1: torch.Tensor | None = None,
    w1_scale: torch.Tensor | None = None,
    w2: torch.Tensor | None = None,
    b2: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused (phi, A, gamma) message-passing pass (the operand contract of
    ``repro.kernels.ref.fused_mp_ref``).

      msrc  (N_src, F)  per-source message operand, gathered via
                    src_sorted (N_src rows: N, or every rank's rows on a
                    shard of a mesh)
      x_res (N, Fr) gamma's residual/self operand
      nop           per-node operand: gcn (N,1) 1/sqrt(d+1); pna (N,3)
                    degree scalers; dgn (N,1) sum of w_e
      eop   (E, F)  phi="add_relu" edge operand (plan order)
      ew    (E, 1)  "wsum" edge weights (plan order)
      w1/b1[/w1_scale]  gamma's first linear (int8: w1 int8 + per-channel
                    scale (H1,), the in-pass W8A8 boundary; gcn ignores
                    the precision)
      w2/b2         gamma="gin" second linear (always f32 weights)

    Empty segments contribute 0; padded node rows come out 0.
    """
    n = in_degree.shape[0]
    msg = msrc.float()[src_sorted.long()]
    if spec.phi == "add_relu":
        msg = torch.clamp(msg + eop.float(), min=0.0)
    elif spec.phi != "copy":
        raise ValueError(f"unknown phi {spec.phi!r}")
    valid = ids_sorted < n
    deg = in_degree.float()[:, None]
    c = torch.clamp(deg, min=1.0)
    agg = {}
    for op in spec.ops:
        if op == "sum":
            agg[op] = sg.segment_sum(msg, ids_sorted, n)
        elif op == "sqsum":
            agg[op] = sg.segment_sum(msg * msg, ids_sorted, n)
        elif op == "wsum":
            agg[op] = sg.segment_sum(msg * ew, ids_sorted, n)
        elif op in ("max", "min"):
            fill = float("-inf") if op == "max" else float("inf")
            vm = torch.where(valid[:, None], msg, torch.full_like(msg, fill))
            red = sg._segment_extremum(vm, ids_sorted, n, op)
            agg[op] = torch.where(deg > 0, red, torch.zeros_like(red))
        else:
            raise ValueError(f"unknown aggregator {op!r}")
    x_res = x_res.float()
    if spec.gamma == "gcn":
        out = (agg["sum"] + x_res) * nop
    elif spec.gamma == "gin":
        h = _fused_gamma_linear(x_res + agg["sum"], w1, b1, w1_scale,
                                spec.precision)
        out = torch.matmul(h, w2.float()) + b2
    elif spec.gamma == "pna":
        mean = agg["sum"] / c
        std = sqrt_rn(torch.clamp(agg["sqsum"] / c - mean * mean, min=0.0))
        agg4 = torch.cat([mean, std, agg["max"], agg["min"]], dim=-1)
        tower = torch.cat(
            [agg4 * nop[:, 0:1], agg4 * nop[:, 1:2], agg4 * nop[:, 2:3]], dim=-1
        )
        out = _fused_gamma_linear(tower, w1, b1, w1_scale, spec.precision) + x_res
    elif spec.gamma == "dgn":
        mean = agg["sum"] / c
        dx = torch.abs(agg["wsum"] - x_res * nop)
        tower = torch.cat([x_res, mean, dx], dim=-1)
        out = _fused_gamma_linear(tower, w1, b1, w1_scale, spec.precision) + x_res
    else:
        raise ValueError(f"unknown gamma {spec.gamma!r}")
    return torch.where(node_mask[:, None], out, torch.zeros_like(out))


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    window: int | None = None, scale: float | None = None, softcap: float = 0.0,
) -> torch.Tensor:
    """Full (quadratic) GQA attention: q (B, Hq, S, D), k (B, Hkv, S, D),
    v (B, Hkv, S, Dv) with Hq % Hkv == 0 -> (B, Hq, S, Dv) in q's dtype,
    computed in fp32.  The scale defaults to 1 / sqrt(D), D the query / key
    head dim, and P is contracted with v's own width (Dv may differ from D:
    MLA's prefill, as JAX's ``blocked_attention``).

    ``window`` None or 0 = full; the causal mask applies when ``causal``;
    ``softcap`` > 0 applies ``tanh(s / c) * c`` to the scaled scores before
    the masks; masked scores are filled with -1e30, as in JAX's oracle.
    """
    s, d = q.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    kq = k.repeat_interleave(g, dim=1)
    vq = v.repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq.float()) * scale
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    mask = _band(s, causal, window, q.device)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vq.float())
    return out.to(q.dtype)


def _band(s: int, causal: bool, window: int | None, device) -> torch.Tensor:
    """(S, S) bool: the key positions each query attends to."""
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= ki <= qi
    if window:
        mask &= ki > qi - window
    return mask


FLASH_BWD_BLOCK_BYTES = 1 << 29  # fp32 scores a head block may hold


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    causal: bool = True, window: int | None = None, softcap: float = 0.0,
    scale: float | None = None,
) -> tuple:
    """The backward of :func:`flash_attention_ref`: (dq, dk, dv) in the
    dtypes of q, k and v, for q (B, Hq, S, D), k (B, Hkv, S, D), v (B, Hkv,
    S, Dv) and the output's gradient do (B, Hq, S, Dv).

    P is recomputed in fp32 from q and k, as a flash backward does, with
    the forward's scale, softcap and causal / window band; then dv = P^T do,
    dP = do v^T, dS = P * (dP - rowsum(P * dP)), taken through the
    softcap's tanh (times 1 - tanh^2), and dq = scale dS k, dk = scale dS^T
    q.  A KV head's dk and dv sum its group's Hq / Hkv query heads.  The
    row sums come from the fp32 P and dP, not from the forward's output
    (a flash backward's rowsum(do * o)): in bf16, o's rounding moves them by
    ~2^-9, which dk sums over a group's every query (ChatGLM3's train shape:
    16 heads x 1024 queries) past ``FLASH_TOL``'s bf16 bound.  The (B,
    heads, S, S) scores are made one block of KV heads at a time, each
    block's fp32 scores within ``FLASH_BWD_BLOCK_BYTES`` (one KV head at the
    least).
    """
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / (d**0.5)
    mask = _band(s, causal, window, q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    per = max(1, FLASH_BWD_BLOCK_BYTES // max(b * g * s * s * 4, 1))
    for h0 in range(0, hkv, per):
        h1 = min(hkv, h0 + per)
        grouped = lambda t: t[:, h0 * g:h1 * g].float().unflatten(1, (h1 - h0, g))
        qh, doh = grouped(q), grouped(do)  # (B, n, g, S, *)
        kh, vh = k[:, h0:h1].float(), v[:, h0:h1].float()  # (B, n, S, *)
        logits = torch.einsum("bngqd,bnkd->bngqk", qh, kh) * scale
        if softcap > 0:
            tanh = torch.tanh(logits / softcap)
            logits = tanh * softcap
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        p = torch.softmax(logits, dim=-1)
        del logits
        dv[:, h0:h1] = torch.einsum("bngqk,bngqd->bnkd", p, doh).to(dv.dtype)
        dp = torch.einsum("bngqd,bnkd->bngqk", doh, vh)
        ds = p * (dp - torch.sum(p * dp, dim=-1, keepdim=True))
        del dp, p
        if softcap > 0:
            ds = ds * (1 - tanh * tanh)
            del tanh
        dq[:, h0 * g:h1 * g] = (torch.einsum("bngqk,bnkd->bngqd", ds, kh)
                                * scale).flatten(1, 2).to(dq.dtype)
        dk[:, h0:h1] = (torch.einsum("bngqk,bngqd->bnkd", ds, qh) * scale).to(dk.dtype)
    return dq, dk, dv

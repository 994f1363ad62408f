"""Model-agnostic quantization transform, PyTorch port of
``repro.quant.apply``: calibrate a parameter tree, then swap every
eligible ``{"w", "b"}`` linear for a ``QuantizedLinear``.

    qparams, report = quantize_model(params, cfg, calib_graphs)
    out = models.apply(qparams, graph, cfg)          # runs int8

Eligibility is structural (a dict with a 2-D ``w`` and a ``b``), the
activation ranges come from the calibration hook around eager forward
passes, and the quantized tree runs through the same ``models.apply`` /
``GNNEngine`` paths because ``gnn/layers.linear_apply`` dispatches on the
node type.  Under ``fused=True`` int8-dynamic linears lower into the
``fused_mp`` kernel's gamma; int8-static and "fixed" ones keep the unfused
path.  The SmoothQuant and zero-point arithmetic is the JAX package's
numpy code.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import graph as G
from repro_torch.data.pipeline import laplacian_eigvec
from repro_torch.gnn import models as M
from repro_torch.quant import observers as O
from repro_torch.quant import qconfig as Q


@dataclasses.dataclass(frozen=True)
class QuantReport:
    """What the transform did."""

    quantized: int  # linears swapped for QuantizedLinear
    kept_fp32: int  # linears left alone (skip-listed or uncalibrated)
    skipped_paths: Tuple[str, ...]
    uncalibrated_paths: Tuple[str, ...]
    scheme: str


def _is_linear(node) -> bool:
    return (
        isinstance(node, dict)
        and "w" in node
        and "b" in node
        and getattr(node["w"], "ndim", 0) == 2
    )


def calibrate(
    params: dict,
    cfg: M.GNNConfig,
    graphs: Sequence[tuple],
    qcfg: Optional[Q.QConfig] = None,
    eigvecs: Optional[Sequence[np.ndarray]] = None,
) -> O.Collector:
    """Run one forward per calibration graph, on the parameters' device,
    with the collection hook active; returns the filled Collector (weight
    id -> observer).

    ``graphs`` are raw COO tuples ``(senders, receivers, node_feat,
    edge_feat)``; DGN's eigenvector inputs are computed here when not
    supplied.
    """
    qcfg = qcfg or Q.QConfig()
    collector = O.Collector(
        lambda: O.make_observer(qcfg.observer, qcfg.percentile)
    )
    device = params["encoder"]["w"].device
    with O.collecting(collector), torch.no_grad():
        for i, g in enumerate(graphs):
            s, r, nf, ef = g[:4]
            gp = G.from_numpy(s, r, nf, ef, device=device)
            eig = None
            if cfg.model == "dgn":
                eig = (np.asarray(eigvecs[i], np.float32)[: nf.shape[0]]
                       if eigvecs is not None
                       else laplacian_eigvec(s, r, nf.shape[0]))
                eig = torch.as_tensor(eig, device=device)
            M.apply(params, gp, cfg, eigvec=eig, num_graphs=1)
    return collector


def _quantize_dynamic_linear(w, b, qcfg: Q.QConfig) -> Q.QuantizedLinear:
    """One linear -> int8 ``QuantizedLinear`` with per-row activation
    scales computed on the device (no calibration statistics)."""
    w_q, w_scale = Q.quantize_weight(w, qcfg)
    return Q.QuantizedLinear(
        w_q=w_q, w_scale=w_scale, b=b.float(),
        x_scale=torch.tensor(1.0, device=w.device), scheme="int8",
        act_mode="dynamic",
    )


def _quantize_int8_linear(w, b, obs, qcfg: Q.QConfig) -> Q.QuantizedLinear:
    """One calibrated linear -> static-activation int8 ``QuantizedLinear``:
    SmoothQuant migration of skewed columns (``smooth_alpha``), asymmetric
    activations for one-sided ranges, and the zero-point correction
    ``s_x s_w zp colsum(w_q)`` folded into the bias, all at transform time
    (see ``repro.quant.apply._quantize_int8_linear``)."""
    dev = w.device
    w_np = w.detach().cpu().numpy().astype(np.float32)
    col = obs.col_range() if hasattr(obs, "col_range") else None
    alpha = qcfg.smooth_alpha
    skewed = False
    if alpha > 0.0 and col is not None and col[0].shape[0] == w_np.shape[0]:
        colmin, colmax = col
        colabs = np.maximum(np.maximum(np.abs(colmin), np.abs(colmax)), _EPS)
        skewed = float(colabs.max() / np.median(colabs)) >= _SMOOTH_SKEW
    if skewed:
        wrowmax = np.maximum(np.abs(w_np).max(axis=1), _EPS)
        s = np.maximum(colabs ** alpha / wrowmax ** (1.0 - alpha), _EPS)
        x_premul = torch.from_numpy((1.0 / s).astype(np.float32)).to(dev)
        lo = float((colmin / s).min())
        hi = float((colmax / s).max())
        w_eff = torch.from_numpy(w_np * s[:, None]).to(dev)
    else:
        x_premul = torch.tensor(1.0, device=dev)
        lo, hi = obs.range()
        w_eff = w
    w_q, w_scale = Q.quantize_weight(w_eff, qcfg)
    x_scale, x_zero = Q.affine_act_params(lo, hi, qcfg.asymmetric_acts)
    # fold the zero-point matmul correction into the bias
    colsum = w_q.to(torch.int32).sum(dim=0).float()
    b_eff = b.float() - (x_scale * x_zero) * w_scale.float() * colsum
    return Q.QuantizedLinear(
        w_q=w_q, w_scale=w_scale, b=b_eff,
        x_scale=torch.tensor(x_scale, dtype=torch.float32, device=dev),
        x_premul=x_premul,
        x_zero=torch.tensor(x_zero, dtype=torch.float32, device=dev),
        scheme="int8", act_mode="static",
    )


_EPS = 1e-6
_SMOOTH_SKEW = 8.0  # hottest column >= this x median before migration pays


def quantize_params(
    params: dict,
    collector: Optional[O.Collector],
    qcfg: Q.QConfig,
) -> Tuple[dict, QuantReport]:
    """Swap calibrated linears for ``QuantizedLinear`` nodes.

    Top-level keys in ``qcfg.skip`` stay fp32 (default: the head).
    Static-activation int8 linears never exercised during calibration stay
    fp32 too (recorded in the report).  "fixed" and dynamic int8 need no
    activation statistics.  ``collector`` must come from calibrating this
    same tree object: observers are keyed by ``id`` of each weight.
    """
    skipped: List[str] = []
    uncalibrated: List[str] = []
    counts = {"q": 0, "fp32": 0}

    def transform(node, path):
        if _is_linear(node):
            if path and path[0] in qcfg.skip:
                skipped.append("/".join(path))
                counts["fp32"] += 1
                return node
            w, b = node["w"], node["b"]
            if qcfg.scheme == "fixed":
                w_q, lsb = Q.quantize_weight(w, qcfg)
                counts["q"] += 1
                return Q.QuantizedLinear(
                    w_q=w_q, w_scale=lsb.to(w.device),
                    b=Q.fixed_round(b, qcfg.word_bits, qcfg.int_bits),
                    x_scale=lsb.to(w.device), scheme="fixed",
                    word_bits=qcfg.word_bits, int_bits=qcfg.int_bits,
                )
            if qcfg.act_mode == "dynamic":
                counts["q"] += 1
                return _quantize_dynamic_linear(w, b, qcfg)
            obs = (collector.observers.get(id(w))
                   if collector is not None else None)
            if obs is None or getattr(obs, "count", 0) == 0:
                uncalibrated.append("/".join(path))
                counts["fp32"] += 1
                return node
            counts["q"] += 1
            return _quantize_int8_linear(w, b, obs, qcfg)
        if isinstance(node, dict):
            return {k: transform(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            seq = [transform(v, path + (str(i),)) for i, v in enumerate(node)]
            return type(node)(seq) if isinstance(node, tuple) else seq
        return node

    with torch.no_grad():
        qparams = transform(params, ())
    report = QuantReport(
        quantized=counts["q"],
        kept_fp32=counts["fp32"],
        skipped_paths=tuple(skipped),
        uncalibrated_paths=tuple(uncalibrated),
        scheme=qcfg.scheme,
    )
    return qparams, report


def quantize_model(
    params: dict,
    cfg: M.GNNConfig,
    calib_graphs: Sequence[tuple],
    qcfg: Optional[Q.QConfig] = None,
    eigvecs: Optional[Sequence[np.ndarray]] = None,
) -> Tuple[dict, QuantReport]:
    """Calibrate (when the scheme needs it) and transform in one call, on
    one tree object — what ``serve.executor.Executor.register`` uses."""
    qcfg = qcfg or Q.QConfig()
    collector = None
    if qcfg.scheme == "int8" and qcfg.act_mode == "static":
        collector = calibrate(params, cfg, calib_graphs, qcfg, eigvecs=eigvecs)
    return quantize_params(params, collector, qcfg)


def precision_qconfig(precision: str) -> Q.QConfig:
    """Map a serving / CLI ``precision`` name to its default QConfig."""
    if precision == "int8":
        return Q.QConfig(scheme="int8", act_mode="dynamic")
    if precision == "int8-static":
        return Q.QConfig(scheme="int8", act_mode="static")
    if precision == "fixed":
        return Q.QConfig(scheme="fixed")
    raise ValueError(
        f"unknown precision {precision!r}; expected "
        "fp32|int8|int8-static|fixed"
    )

"""Range calibration: observers + the forward-pass collection hook
(PyTorch port of ``repro.quant.observers``; the observers are the same
numpy code).

Static quantization needs one activation range per linear layer.  The
models route every dense transform through ``gnn/layers.linear_apply``,
which reports each layer's input here whenever a ``Collector`` is active
— so calibration is one eager forward pass per calibration graph, with
zero model-specific code.  Layers are keyed by the identity of their
weight array (stable within one param tree), which is how the transform
in ``quant/apply.py`` finds each layer's observer afterwards.

Observers:
  * ``MinMaxObserver``     — running min/max over every update.
  * ``PercentileObserver`` — symmetric absolute-value percentile over a
    bounded reservoir of samples; clips the outlier tail that would
    otherwise stretch the int8 step (the usual fix when a handful of
    activations dominate the range).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np


class _ColumnStats:
    """Signed per-feature-column extremes, shared by both observers.

    Columns are the matmul contraction dim, so per-column ranges cannot
    feed per-column activation *scales* (the requantization would not
    factorize) — they feed the SmoothQuant-style scale *migration* in
    quant/apply.py, which divides hot activation columns down and folds
    the factor into the weights.
    """

    def __init__(self):
        self.colmin = None
        self.colmax = None

    def update_cols(self, x: np.ndarray) -> None:
        if x.ndim != 2 or x.shape[0] == 0:
            return
        lo, hi = x.min(axis=0), x.max(axis=0)
        if self.colmin is None or self.colmin.shape != lo.shape:
            self.colmin, self.colmax = lo, hi
        else:
            self.colmin = np.minimum(self.colmin, lo)
            self.colmax = np.maximum(self.colmax, hi)

    def col_range(self):
        """-> (colmin, colmax) signed per-column, or None if unseen."""
        if self.colmin is None:
            return None
        return self.colmin, self.colmax


class MinMaxObserver(_ColumnStats):
    def __init__(self):
        super().__init__()
        self.lo = np.inf
        self.hi = -np.inf
        self.count = 0

    def update(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        if x.size == 0:
            return
        self.lo = min(self.lo, float(x.min()))
        self.hi = max(self.hi, float(x.max()))
        self.count += x.size
        self.update_cols(x)

    def range(self) -> Tuple[float, float]:
        if self.count == 0:
            raise ValueError("observer saw no data")
        return self.lo, self.hi


class PercentileObserver(_ColumnStats):
    """Symmetric |x| percentile over a capped sample reservoir (the
    per-tensor range; per-column extremes stay exact min/max)."""

    def __init__(self, percentile: float = 99.9, max_samples: int = 1 << 16,
                 seed: int = 0):
        super().__init__()
        self.percentile = percentile
        self.max_samples = max_samples
        self._rng = np.random.default_rng(seed)
        self._samples: list = []
        self.count = 0

    def update(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        self.update_cols(x)
        x = np.abs(x).ravel()
        if x.size == 0:
            return
        if x.size > self.max_samples:
            x = self._rng.choice(x, self.max_samples, replace=False)
        self._samples.append(x)
        self.count += x.size
        # keep the reservoir bounded: re-subsample the concatenation
        total = sum(s.size for s in self._samples)
        if total > 4 * self.max_samples:
            pool = np.concatenate(self._samples)
            self._samples = [self._rng.choice(pool, self.max_samples,
                                              replace=False)]

    def range(self) -> Tuple[float, float]:
        if not self._samples:
            raise ValueError("observer saw no data")
        bound = float(np.percentile(np.concatenate(self._samples),
                                    self.percentile))
        return -bound, bound


def make_observer(kind: str, percentile: float = 99.9):
    if kind == "minmax":
        return MinMaxObserver()
    if kind == "percentile":
        return PercentileObserver(percentile)
    raise ValueError(f"unknown observer {kind!r}; expected minmax|percentile")


# ---------------------------------------------------------------------------
# collection hook (active only during quant/apply.calibrate)
# ---------------------------------------------------------------------------


class Collector:
    """Per-layer observers keyed by ``id(weight array)``."""

    def __init__(self, factory: Callable):
        self.factory = factory
        self.observers: Dict[int, object] = {}

    def record(self, w, x) -> None:
        obs = self.observers.get(id(w))
        if obs is None:
            obs = self.observers[id(w)] = self.factory()
        obs.update(np.asarray(x))


_ACTIVE: Optional[Collector] = None


@contextlib.contextmanager
def collecting(collector: Collector):
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, collector
    try:
        yield collector
    finally:
        _ACTIVE = prev


def observe_linear_input(p, x) -> None:
    """Hook called by ``gnn/layers.linear_apply`` on every fp32 linear.
    No-op unless a Collector is active; the input is copied to the host."""
    if _ACTIVE is None:
        return
    w = p.get("w") if isinstance(p, dict) else None
    if w is None:
        return
    _ACTIVE.record(w, x.detach().cpu().numpy())

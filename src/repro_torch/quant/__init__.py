"""Quantized inference, PyTorch port of ``repro.quant`` (the paper's
``ap_fixed`` design axis):

  * ``observers.py`` — activation-range calibration (min/max, percentile)
    and the forward-pass collection hook;
  * ``qconfig.py``   — schemes (symmetric int8, ap_fixed<W,I> emulation),
    ``QuantizedLinear`` and its forward;
  * ``apply.py``     — the parameter-tree transform (``quantize_model``)
    that runs all six GNN models quantized.

``apply`` is imported lazily: it pulls in the model library, which itself
imports this package for the ``linear_apply`` dispatch.
"""
from repro_torch.quant.observers import (  # noqa: F401
    Collector,
    MinMaxObserver,
    PercentileObserver,
    collecting,
    make_observer,
    observe_linear_input,
)
from repro_torch.quant.qconfig import (  # noqa: F401
    QConfig,
    QuantizedLinear,
    affine_act_params,
    dequantize_int8,
    fixed_round,
    quantize_int8,
    quantized_linear,
    quantize_weight,
    symmetric_scale,
)

_LAZY = ("calibrate", "quantize_params", "quantize_model",
         "precision_qconfig", "QuantReport", "apply")


def __getattr__(name):
    if name in _LAZY:
        import importlib

        _apply = importlib.import_module("repro_torch.quant.apply")
        return _apply if name == "apply" else getattr(_apply, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

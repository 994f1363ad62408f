"""Weight conversion from the JAX package's parameter pytree.

The JAX tree arrives as nested dicts / lists of numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``), so this module never sees
a JAX object.  The structure is kept as is: ``{"encoder": {"w", "b"},
"layers": [...], "head": [...]}``, with GIN's scalar ``eps`` as a 0-d
tensor.  A quantized tree (``repro.quant``'s ``QuantizedLinear`` nodes,
whose leaves ``tree_map`` turns into numpy arrays) converts into the port's
``quant.QuantizedLinear``: the node is recognised by its attributes, the
int8 weights stay int8 and every other numeric field becomes float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.quant.qconfig import QuantizedLinear

_QUANT_TENSORS = ("w_q", "w_scale", "b", "x_scale", "x_premul", "x_zero")
_QUANT_STATICS = ("scheme", "act_mode", "word_bits", "int_bits")


def _tensor(leaf, device, keep_int8: bool = False) -> torch.Tensor:
    arr = np.asarray(leaf)
    dtype = np.int8 if keep_int8 and arr.dtype == np.int8 else np.float32
    return torch.from_numpy(np.array(arr, dtype=dtype)).to(device)  # a copy


def _is_quantized(node) -> bool:
    return all(hasattr(node, a) for a in _QUANT_TENSORS + _QUANT_STATICS)


def from_jax_params(tree, device="cpu"):
    """Nested dicts / lists / tuples of numpy arrays (and quantized-linear
    nodes) -> the same structure of tensors on ``device``: float32 leaves,
    ``QuantizedLinear`` nodes with int8 ``w_q`` for the int8 schemes
    (copies; the source stays untouched)."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_params(v, device) for v in tree)
    if _is_quantized(tree):
        fields = {a: _tensor(getattr(tree, a), device, keep_int8=a == "w_q")
                  for a in _QUANT_TENSORS}
        fields.update({a: getattr(tree, a) for a in _QUANT_STATICS})
        return QuantizedLinear(**fields)
    return _tensor(tree, device)

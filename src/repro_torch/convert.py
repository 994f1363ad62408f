"""Weight conversion from the JAX package's parameter pytree.

The JAX tree arrives as nested dicts / lists of numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``), so this module never sees
a JAX object.  The structure is kept as is: ``{"encoder": {"w", "b"},
"layers": [...], "head": [...]}``, with GIN's scalar ``eps`` as a 0-d
tensor.  A quantized tree (``repro.quant``'s ``QuantizedLinear`` nodes,
whose leaves ``tree_map`` turns into numpy arrays) converts into the port's
``quant.QuantizedLinear``: the node is recognised by its attributes, the
int8 weights stay int8 and every other numeric field becomes float32.

``from_jax_lm_params`` converts the LM substrate's tree (``repro.models.lm``'s
``P.values(init_params(...))``, leaves as numpy), keeping each leaf's type:
the MoE layers' ``router``, ``wi`` and ``wo`` map leaf for leaf like the
rest, with or without ``kv_pad_to``.  ``from_jax_opt_state`` converts
``repro.optim.adamw``'s state ({"m", "v", "step"}) into the port's and
``to_numpy`` any tree of tensors back into numpy (bf16 leaves as their
exact float32 values), so both packages can start from one state.
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


def _lm_tensor(leaf, device, dtype) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy rejects: through
        # float32, where every bfloat16 value is exact
        t = torch.from_numpy(np.array(arr, dtype=np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a copy
    if dtype is not None and t.is_floating_point() and t.dim() >= 2:
        t = t.to(dtype)
    return t.to(device)


def from_jax_lm_params(tree, device="cpu", dtype=None):
    """The JAX LM parameter tree (nested dicts / lists of numpy arrays) ->
    the same structure of tensors on ``device``.  Each leaf keeps its JAX
    type: bfloat16 leaves become ``torch.bfloat16`` exactly, float32 leaves
    (``final_norm``) stay float32.  ``dtype`` casts every floating leaf of
    two or more dimensions, the leaves ``init_params`` casts to the model
    dtype."""
    if isinstance(tree, dict):
        return {k: from_jax_lm_params(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_lm_params(v, device, dtype) for v in tree)
    return _lm_tensor(tree, device, dtype)


def from_jax_opt_state(state: dict, device="cpu") -> dict:
    """JAX's AdamW state (numpy leaves: fp32 m and v trees, an int32 step)
    -> ``optim.adamw``'s, on ``device``."""
    return {"m": from_jax_lm_params(state["m"], device),
            "v": from_jax_lm_params(state["v"], device),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                                 device=device)}


def to_numpy(tree):
    """A tree of tensors (dicts / lists) -> the same structure of numpy
    arrays on the host; bf16 leaves become float32, which holds every bf16
    value exactly."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

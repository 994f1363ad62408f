"""Weight conversion from the JAX package's parameter pytree.

The JAX tree arrives as nested dicts / lists of numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``), so this module never sees
a JAX object.  The structure is kept as is: ``{"encoder": {"w", "b"},
"layers": [...], "head": [...]}``, with GIN's scalar ``eps`` as a 0-d
tensor.
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax_params(tree, device="cpu"):
    """Nested dicts / lists / tuples of numpy arrays -> the same structure
    of float32 tensors on ``device`` (copies; the source stays untouched)."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_params(v, device) for v in tree)
    arr = np.array(tree, dtype=np.float32)  # a writable copy
    return torch.from_numpy(arr).to(device)

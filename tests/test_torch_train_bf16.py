"""bf16 training loss and gradients of every LM family against the JAX
package's, on the CPU.

As in ``tests/test_torch_lm_bf16.py``, JAX's fp32 ``init_params`` is the one
set of weights: JAX's bf16 model runs it cast to bfloat16 (every leaf of
two or more dimensions), the port's ``convert.from_jax_lm_params(...,
dtype=torch.bfloat16)`` of it, on one numpy batch.  The port's bf16 is held
to the distance JAX's own bf16 keeps from JAX's fp32:

  * the loss: |port bf16 - JAX fp32| <= max over positions of |JAX bf16 -
    JAX fp32| in the per-token cross-entropy that the loss averages (on
    these inputs the port's loss is within 0.14 of that bound);
  * the gradients, over every element of every leaf: max|port bf16 - JAX
    fp32| <= 2 max|JAX bf16 - JAX fp32| (the ratio is 0.14-1.19 here,
    MiniCPM3's the largest).

The scalar loss alone is no measure of JAX's bf16 noise: its distance is
one sample, 3.8e-5 for Whisper on these inputs against 0.011 for the
per-token values it averages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import lm as JLM
from repro_torch.configs import ARCHS

from test_torch_train_parity import (inputs, jax_params, jax_value_and_grad,
                                     leaves_by_path, port_step)

torch.set_num_threads(2)

GRAD_MULTIPLE = 2.0


def jax_token_ce(params, batch, cfg):
    """JAX's per-position cross-entropy, the values ``loss_fn`` averages."""
    hidden, _ = JLM.forward_hidden(params, batch, cfg)
    if cfg.family == "vlm":
        hidden = hidden[:, cfg.num_patches:]
    logits = JLM.logits_fn(params, hidden, cfg).astype(jnp.float32)
    tokens = batch["tokens"]
    labels = jnp.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
    gold = jnp.take_along_axis(logits, labels[..., None], axis=-1)[..., 0]
    return (jax.nn.logsumexp(logits, axis=-1) - gold)[:, :-1]  # weight 0 at the end


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_grads_as_near_jax_fp32_as_jax_bf16_is(arch):
    cfg32, jp32 = jax_params(arch)
    cfg16 = jget_reduced(arch, dtype="bfloat16")
    jp16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2 else a,
                                  jp32)
    batch = inputs(cfg32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (l32, _), g32 = jax_value_and_grad(cfg32)(jp32, jb, cfg32)
    _, g16 = jax_value_and_grad(cfg16)(jp16, jb, cfg16)
    ce = jax.jit(jax_token_ce, static_argnums=2)
    ce_dist = float(jnp.max(jnp.abs(ce(jp16, jb, cfg16).astype(jnp.float32)
                                    - ce(jp32, jb, cfg32))))
    loss, _, grads = port_step(arch, jp32, batch, dtype=torch.bfloat16)
    assert np.isfinite(float(loss)) and ce_dist > 0
    assert abs(float(loss) - float(l32)) <= ce_dist, (float(loss), float(l32), ce_dist)
    want, jax16 = leaves_by_path(g32), leaves_by_path(g16)
    assert set(grads) == set(want)
    port_dist = max(float(np.abs(grads[k] - want[k]).max()) for k in want)
    jax_dist = max(float(np.abs(jax16[k] - want[k]).max()) for k in want)
    assert np.isfinite(port_dist) and jax_dist > 0
    assert port_dist <= GRAD_MULTIPLE * jax_dist, (port_dist, jax_dist)

"""bf16 parity of every LM family against the JAX package, on the CPU.

For each of the ten reduced configs, JAX's ``init_params(PRNGKey(0))`` in
float32 is the one set of weights: JAX's bf16 model runs it cast to
bfloat16 (every leaf of two or more dimensions, JAX's own init rule: its
bf16 init is that cast of its fp32 draws), the port's runs
``convert.from_jax_lm_params(..., dtype=torch.bfloat16)`` of it.  Both
prefill the same numpy tokens (and a VLM's patches or an audio model's
frames), and their last logits are compared with JAX's fp32 prefill:

    max|port bf16 - JAX fp32| <= BF16_MULTIPLE * max|JAX bf16 - JAX fp32|

The port rounds in other places than XLA does (the flash kernel's plain
version scales fp32 scores, the recurrences run in order, its matmuls sum
in another order than XLA's), so the two bf16 runs are not equal; the
bound says the port's bf16 is as near JAX's fp32 as JAX's own bf16 is,
within 2x.  On these inputs the ratio is 0.71-1.32 (MiniCPM3's MLA the
largest).  Everything is deterministic on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import params as JP
from repro.configs import get_reduced as jget_reduced
from repro.models import lm as JLM
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.convert import from_jax_lm_params
from repro_torch.models import lm as TLM

torch.set_num_threads(2)

B, S = 2, 16
CACHE = 32
BF16_MULTIPLE = 2.0


def _inputs(cfg):
    """Tokens and the family's extra, numpy, from one seed."""
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(B, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_as_near_jax_fp32_as_jax_bf16_is(arch):
    cfg32, cfg16 = jget_reduced(arch, dtype="float32"), jget_reduced(arch, dtype="bfloat16")
    jp32 = jax.jit(lambda key: JP.values(JLM.init_params(key, cfg32)))(jax.random.PRNGKey(0))
    jp16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2 else a,
                                  jp32)
    batch = _inputs(cfg32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(JLM.prefill(jp32, jbatch, cfg32, CACHE)[1], np.float32)
    jax16 = np.asarray(JLM.prefill(jp16, jbatch, cfg16, CACHE)[1], np.float32)
    tp = from_jax_lm_params(jax.tree_util.tree_map(np.asarray, jp32), dtype=torch.bfloat16)
    _, got, _ = TLM.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                            get_reduced(arch, dtype="bfloat16"), CACHE)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    scale = np.abs(want).max()
    jax_dist = np.abs(jax16 - want).max() / scale
    port_dist = np.abs(got.float().numpy() - want).max() / scale
    assert np.isfinite(port_dist) and jax_dist > 0
    assert port_dist <= BF16_MULTIPLE * jax_dist, (port_dist, jax_dist)

"""The port's training loss and gradients against the JAX package's, on
the CPU, for all ten reduced LM configs in fp32.

JAX's ``init_params(PRNGKey(0))`` is the one set of weights (the port's
through ``convert.from_jax_lm_params``), and both packages see the same
numpy batch (tokens, and a VLM's patches or an audio model's frames, from
one seed).  ``train.loop.loss_and_grads`` (the port's ``lm.loss_fn`` and
autograd, each group of the stack under remat: the reduced configs have
``remat`` off, and JAX runs them so) is held against
``jax.value_and_grad(lm.loss_fn)``: the loss, ce and aux at rtol 1e-5 /
atol 1e-6, every gradient leaf at rtol 1e-4 and an atol of 1e-4 times the
leaf's largest magnitude.  On these inputs the largest gradient error is
2.7e-5 of its leaf's largest magnitude (RWKV-6's embedding, 2.0e-5
absolute: its recurrence sums in another order than XLA's); a fixed atol
of 1e-5 would not hold there.  The CPU path
differentiates the flash kernel's plain version; so Jamba's Mamba scan
and RWKV-6's time mix take a train step here, and every family's loss
reaches every leaf.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import params as JP
from repro.configs import get_reduced as jget_reduced
from repro.models import lm as JLM
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.convert import from_jax_lm_params, to_numpy
from repro_torch.train.loop import loss_and_grads

torch.set_num_threads(2)

B, S = 2, 16
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL = GRAD_ATOL_OF_MAX = 1e-4


def inputs(cfg, seed: int = 3) -> dict:
    """Tokens and the family's extra, numpy, from one seed."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(B, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return batch


def jax_params(arch: str):
    cfg = jget_reduced(arch, dtype="float32")
    return cfg, jax.jit(lambda key: JP.values(JLM.init_params(key, cfg)))(
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(cfg):
    return jax.jit(jax.value_and_grad(JLM.loss_fn, has_aux=True), static_argnums=2)


def leaves_by_path(tree) -> dict:
    """{"blocks/0/mixer/wq": array} of a JAX tree or a ``to_numpy`` tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(leaf, np.float32) for path, leaf in flat}


def port_step(arch: str, jp, batch: dict, dtype=None):
    """(loss, aux, grads as numpy by path) of the port on JAX's weights
    (cast to ``dtype`` as ``init_params`` casts)."""
    tp = from_jax_lm_params(jax.tree_util.tree_map(np.asarray, jp), dtype=dtype)
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    loss, aux, grads = loss_and_grads(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()},
        get_reduced(arch, dtype=name, remat=True))
    return loss, aux, leaves_by_path(to_numpy(grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax_fp32(arch):
    cfg, jp = jax_params(arch)
    batch = inputs(cfg)
    (jloss, jaux), jgrads = jax_value_and_grad(cfg)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    loss, aux, grads = port_step(arch, jp, batch)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **LOSS_TOL)
    want = leaves_by_path(jgrads)
    assert set(grads) == set(want)
    for path, g in want.items():
        assert grads[path].shape == g.shape, path
        np.testing.assert_allclose(grads[path], g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_OF_MAX * np.abs(g).max(), err_msg=path)
        assert np.abs(grads[path]).max() > 0, f"{path}: no gradient"

"""The port's MLA (``repro_torch.models.layers.mla_apply``) against the JAX
package's, on the CPU, at the reduced MiniCPM3 widths (4 heads, q_lora 32,
kv_lora 16, nope 16 + rope 8, v 16) in float32.

* prefill (the expanded form: per-head keys and values from the latent,
  the shared rope key; ``blocked_attention`` at (D, Dv) = (24, 16)) and
  the absorbed decode over a latent cache, outputs and caches against
  JAX's at rtol = atol = 1e-5 (fp32 matmuls of other widths; the port's
  prefill attention is the quadratic plain version, JAX's the blocked
  online softmax);
* the absorbed decode at position t over a cache filled by prefill of the
  first t tokens equals the expanded forward's output at t (1e-5);
* ``kernels.ref.flash_attention_ref`` with Dqk != Dv (24 / 16, GQA, a
  window) against JAX's ``blocked_attention`` (1e-5), and the flash
  wrapper's instance rule for the pair (the kernel itself runs on the
  card: ``tests/test_torch_on_card.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import params as JP
from repro.configs import get_reduced as jget_reduced
from repro.models import layers as JL
from repro_torch.configs import get_reduced
from repro_torch.convert import from_jax_lm_params
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as kref
from repro_torch.models import layers as TL

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
B, S_CACHE = 2, 24
ARCH = "minicpm3-4b"


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@pytest.fixture(scope="module")
def mla():
    """(JAX cfg, port cfg, JAX params, port params) of one MLA layer: JAX's
    init, the norms' scales moved off 1 by numpy noise."""
    cfg_j = jget_reduced(ARCH, dtype="float32")
    rng = np.random.default_rng(0)
    jp = jax.tree_util.tree_map(np.asarray, JP.values(JL.mla_init(jax.random.PRNGKey(0), cfg_j)))
    for k in ("q_norm", "kv_norm"):
        jp[k] = (jp[k] + 0.2 * rng.normal(size=jp[k].shape)).astype(np.float32)
    return cfg_j, get_reduced(ARCH, dtype="float32"), jp, from_jax_lm_params(jp)


def _x(cfg, s, seed):
    return np.random.default_rng(seed).normal(size=(B, s, cfg.d_model)).astype(np.float32)


def test_mla_init_matches_jax(mla):
    _, cfg, jp, _ = mla
    tp = TL.mla_init(torch.Generator().manual_seed(0), cfg, stack=(3,))
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: (3,) + v.shape for k, v in jp.items()}


@pytest.mark.parametrize("s", (1, 7, 16))
def test_mla_prefill_matches_jax(mla, s):
    cfg_j, cfg, jp, tp = mla
    x = _x(cfg, s, s)
    out_j, (ckv_j, kr_j) = JL.mla_apply(jp, jnp.asarray(x), cfg_j)
    out, (ckv, kr) = TL.mla_apply(tp, torch.from_numpy(x), cfg)
    assert tuple(ckv.shape) == (B, s, cfg.kv_lora_rank) and tuple(kr.shape) == (
        B, s, cfg.qk_rope_dim)
    for got, want in ((out, out_j), (ckv, ckv_j), (kr, kr_j)):
        _close(got, want)


@pytest.mark.parametrize("t", (0, 9, S_CACHE - 1))
def test_mla_absorbed_decode_matches_jax(mla, t):
    cfg_j, cfg, jp, tp = mla
    rng = np.random.default_rng(t)
    x = _x(cfg, 1, 50 + t)
    ckv = rng.normal(size=(B, S_CACHE, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, S_CACHE, cfg.qk_rope_dim)).astype(np.float32)
    out_j, (ckv_j, kr_j) = JL.mla_apply(jp, jnp.asarray(x), cfg_j,
                                        cache=(jnp.asarray(ckv), jnp.asarray(kr)),
                                        t=jnp.int32(t))
    cache = (torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy()))
    out, (ckv_t, kr_t) = TL.mla_apply(tp, torch.from_numpy(x), cfg, cache=cache,
                                      t=torch.tensor(t))
    assert ckv_t is cache[0] and kr_t is cache[1]  # written in place
    for got, want in ((out, out_j), (ckv_t, ckv_j), (kr_t, kr_j)):
        _close(got, want)


@pytest.mark.parametrize("t", (0, 5, 12))
def test_absorbed_decode_equals_the_expanded_forward(mla, t):
    """Prefill of tokens [0, t) into a latent cache, then the absorbed
    decode of token t: the expanded forward's output at position t."""
    _, cfg, _, tp = mla
    x = torch.from_numpy(_x(cfg, 13, 7))
    full, _ = TL.mla_apply(tp, x, cfg)
    ckv = torch.zeros((B, S_CACHE, cfg.kv_lora_rank))
    kr = torch.zeros((B, S_CACHE, cfg.qk_rope_dim))
    if t:
        _, (c0, k0) = TL.mla_apply(tp, x[:, :t], cfg)
        ckv[:, :t], kr[:, :t] = c0, k0
    step, _ = TL.mla_apply(tp, x[:, t:t + 1], cfg, cache=(ckv, kr), t=t)
    _close(step, _np(full[:, t:t + 1]))


@pytest.mark.parametrize("hq, hkv, window", ((4, 4, 0), (4, 2, 0), (6, 2, 5)))
def test_flash_attention_ref_with_dqk_not_dv_matches_jax(hq, hkv, window):
    """The plain version contracts P with v's own width: (Dqk, Dv) = (24,
    16) through ``layers.blocked_attention`` (reference mode) and
    ``flash_attention_ref`` against JAX's ``blocked_attention``."""
    cfg_j = jget_reduced(ARCH, dtype="float32")  # attn_chunk 16: JAX blocks S = 37
    rng = np.random.default_rng(hq + hkv + window)
    s = 37
    q = rng.normal(size=(B, s, hq, 24)).astype(np.float32)
    k = rng.normal(size=(B, s, hkv, 24)).astype(np.float32)
    v = rng.normal(size=(B, s, hkv, 16)).astype(np.float32)
    want = JL.blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg_j,
                                window=window)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = TL.blocked_attention(qt, kt, vt, window=window, mode="reference")
    assert tuple(got.shape) == (B, s, hq, 16)
    _close(got, want)
    ref = kref.flash_attention_ref(qt.transpose(1, 2), kt.transpose(1, 2),
                                   vt.transpose(1, 2), window=window)
    _close(ref.transpose(1, 2), want)


def test_flash_wrapper_takes_the_mla_pair_and_refuses_others():
    """(96, 64) has an instance on both routes (bf16: mma); (24, 16) and
    other pairs have none, and the wrapper refuses them before any launch
    (on a CPU tensor it refuses the device first)."""
    assert FA.has_instance(96, 64) and FA.route(torch.bfloat16, 96, 64) == "mma"
    assert FA.route(torch.float32, 96, 64) == "simt"
    FA.check_route("mma", torch.bfloat16, 96, 64)
    for d, dv in ((24, 16), (96, 32), (64, 96), (128, 64)):
        assert not FA.has_instance(d, dv)
    with pytest.raises(ValueError, match="no instance"):
        FA.check_route("mma", torch.bfloat16, 96, 32)
    q = torch.zeros(1, 2, 4, 96)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention(q, q, torch.zeros(1, 2, 4, 64))

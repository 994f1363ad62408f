"""The port's decode step (``repro_torch.models.layers``, ``models.lm``) against
the JAX package's, on the CPU, at the reduced sizes.

* ``decode_attention``: the port views q as (B, Hkv, g, D) against the
  cache's Hkv heads (no repeated and no fp32 copy of the cache); JAX repeats
  the cache g times and computes in fp32.  In fp32 both are the same sums in
  another order: rtol 1e-5, atol 1e-6, at t = 0, mid-cache and the last
  slot, with a window and a softcap, for g = 1, 2, 3; the position is a
  tensor, as the served step passes it.
* ``gqa_apply``: the port projects k and v with the stored Hkv heads and
  repeats the projections to ``kv_heads_effective``; JAX repeats ``wk`` /
  ``wv`` first.  Each repeated head is the same dot products: prefill and
  decode outputs and the K/V within 1e-5 (fp32 matmuls of another width),
  at every arch's reduced widths (MiniCPM3's and RWKV-6's with two KV
  heads: their own layers are MLA and attention-free; Whisper's cut from
  four to two).
* ``decode_step`` at a tensor position gives the int position's logits and
  cache (sequence entries, recurrent states, cross K/V) bit for bit (both
  models' dtypes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import params as JP
from repro.configs import get_reduced as jget_reduced
from repro.models import layers as JL
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.convert import from_jax_lm_params
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM

torch.set_num_threads(2)

ATTN_TOL = dict(rtol=1e-5, atol=1e-6)
GQA_TOL = dict(rtol=1e-5, atol=1e-5)
B, S_CACHE, D = 2, 24, 16
# (kind, window, softcap) of each decode_attention case
ATTN_KINDS = (("plain", 0, 0.0), ("window", 5, 0.0), ("softcap", 0, 3.0))
# arch -> overrides giving tied KV copies at the reduced size (heads 4 / 4 / 8
# / 4 / 4 / 4 / 4 / 4 / 4 / 4; MiniCPM3, RWKV-6 and Whisper have 4 KV heads,
# cut to 2)
PADS = {"chatglm3-6b": dict(kv_pad_to=4), "gemma3-12b": dict(kv_pad_to=4),
        "starcoder2-15b": dict(kv_pad_to=8), "qwen3-moe-30b-a3b": dict(kv_pad_to=4),
        "mixtral-8x7b": dict(kv_pad_to=4),
        "minicpm3-4b": dict(num_kv_heads=2, kv_pad_to=4),
        "jamba-v0.1-52b": dict(kv_pad_to=4),
        "rwkv6-1.6b": dict(num_kv_heads=2, kv_pad_to=4),
        "internvl2-26b": dict(kv_pad_to=4),
        "whisper-base": dict(num_kv_heads=2, kv_pad_to=4)}


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("g", (1, 2, 3))
@pytest.mark.parametrize("t", (0, S_CACHE // 2, S_CACHE - 1))
@pytest.mark.parametrize("kind, window, softcap", ATTN_KINDS)
def test_grouped_decode_attention_matches_jax(g, t, kind, window, softcap):
    hkv = 2
    rng = np.random.default_rng(100 * g + t)
    q = rng.normal(size=(B, 1, hkv * g, D)).astype(np.float32)
    kc, vc = (rng.normal(size=(B, S_CACHE, hkv, D)).astype(np.float32) for _ in range(2))
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.int32(t), window=window, softcap=softcap)
    got = TL.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), torch.tensor(t), window=window,
                              softcap=softcap)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **ATTN_TOL)


def _gqa_case(arch):
    """(JAX cfg, port cfg, JAX params, port params) of one attention layer
    with tied KV copies (kv_pad_to > num_kv_heads)."""
    cfg_j = jget_reduced(arch, dtype="float32", **PADS[arch])
    cfg = get_reduced(arch, dtype="float32", **PADS[arch])
    assert cfg.kv_heads_effective > cfg.num_kv_heads
    jp = jax.tree_util.tree_map(np.asarray,
                                JP.values(JL.gqa_init(jax.random.PRNGKey(2), cfg_j)))
    return cfg_j, cfg, jp, from_jax_lm_params(jp)


@pytest.mark.parametrize("arch", ARCHS)
def test_projected_then_repeated_kv_matches_jax_prefill(arch):
    cfg_j, cfg, jp, tp = _gqa_case(arch)
    x = np.random.default_rng(3).normal(size=(B, 12, cfg.d_model)).astype(np.float32)
    window = cfg.window_for_layer(0)
    out_j, (k_j, v_j) = JL.gqa_apply(jp, jnp.asarray(x), cfg_j, window)
    out, (k, v) = TL.gqa_apply(tp, torch.from_numpy(x), cfg, window)
    assert k.shape == k_j.shape and k.shape[2] == cfg.kv_heads_effective
    for got, want in ((out, out_j), (k, k_j), (v, v_j)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **GQA_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_projected_then_repeated_kv_matches_jax_decode(arch):
    cfg_j, cfg, jp, tp = _gqa_case(arch)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    shape = (B, S_CACHE, cfg.kv_heads_effective, cfg.head_dim_)
    kc, vc = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    t = 9
    window = cfg.window_for_layer(0)
    out_j, (kc_j, vc_j) = JL.gqa_apply(jp, jnp.asarray(x), cfg_j, window,
                                       kv_cache=(jnp.asarray(kc), jnp.asarray(vc)),
                                       t=jnp.int32(t))
    cache = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    out, (kc_t, vc_t) = TL.gqa_apply(tp, torch.from_numpy(x), cfg, window,
                                     kv_cache=cache, t=torch.tensor(t))
    assert kc_t is cache[0] and vc_t is cache[1]  # written in place
    for got, want in ((out, out_j), (kc_t, kc_j), (vc_t, vc_j)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **GQA_TOL)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_at_a_tensor_position_equals_the_int_position(arch, dtype):
    cfg = get_reduced(arch, dtype=dtype)
    params = TLM.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 10)))}
    extra = TLM.extra_input(cfg, B)  # a VLM's patches, an audio model's frames
    if extra is not None:
        batch[extra[0]] = torch.from_numpy(rng.normal(size=extra[1]).astype(np.float32))
    cache, _, t = TLM.prefill(params, batch, cfg,
                              16 + (cfg.num_patches if cfg.family == "vlm" else 0))
    twin = [{k: w.clone() for k, w in c.items()} for c in cache]
    for i in range(3):
        step = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
        by_int, _ = TLM.decode_step(params, cache, step, t + i, cfg)
        by_tensor, _ = TLM.decode_step(params, twin, step, torch.tensor(t + i), cfg)
        assert torch.equal(by_int, by_tensor)
    for a, b in zip(cache, twin):
        assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)

"""The VLM (InternVL2) and audio (Whisper) families of the port against the
JAX package, on the CPU, at the reduced sizes and in float32.

* ``layers._bidirectional_attention`` (Whisper's encoder self-attention and
  its decoder's cross-attention; fp32 logits, softmax and P.V, as JAX's),
  ``cross_attention_apply``, ``gqa_apply``'s bidirectional branch (RoPE
  applied, as JAX does), ``lm.encode_audio`` and ``lm.cross_kv_all`` on
  the same numpy inputs and converted weights: within 1e-5;
* the cache after prefill: an audio decoder's ``cross_k`` / ``cross_v``
  (B, encoder_seq, Hkv, D) equal to JAX's within 1e-5, carried unchanged
  by decode steps; a VLM's t0 = P + S, as JAX's;
* the server's overflow check counts a VLM's patches;
* ``lm.init_params`` casts each leaf as it is drawn (``params.casting``):
  the weights are bit for bit those of the draw order before (each block
  position drawn in fp32, then cast), and those of drawing the whole tree
  in fp32 and casting it afterwards;
* ``convert.from_jax_lm_params`` carries the encoder and cross-attention
  leaves: every leaf's path, shape and dtype is ``init_params``';
* counterparts of ``tests/test_arch_smoke.py``'s cases for the two
  families: a reduced forward's shape (a VLM's with its patch positions)
  and finiteness, decode after prefill(S-1) against forward(S) (2e-2, the
  VLM's hidden states past its patches) and the full configs' parameter
  counts (the port's, counted on fake tensors, equal to JAX's).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import params as JP
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serve.engine import LMServer as JLMServer
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import params as P
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.convert import from_jax_lm_params
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import LMServer, ServeConfig

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 16
FAMILIES = ("internvl2-26b", "whisper-base")


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def _jax_params(cfg, seed=0):
    jp = jax.jit(lambda key: JP.values(JLM.init_params(key, cfg)))(jax.random.PRNGKey(seed))
    return jp, from_jax_lm_params(jax.tree_util.tree_map(np.asarray, jp))


def _extra(cfg, rng, b=B):
    name, shape = TLM.extra_input(cfg, b)
    return {name: rng.normal(size=shape).astype(np.float32)}


def _batches(cfg, rng, s=S):
    """(JAX batch, port batch) of the same numpy tokens and extra."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32),
             **_extra(cfg, rng)}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("sq, sk, h, hkv", [(7, 7, 4, 4), (5, 12, 4, 2), (1, 12, 4, 4),
                                            (9, 3, 6, 2)])
def test_bidirectional_attention_matches_jax(sq, sk, h, hkv):
    rng = np.random.default_rng(sq * 100 + sk)
    q = rng.normal(size=(B, sq, h, 16)).astype(np.float32)
    k, v = (rng.normal(size=(B, sk, hkv, 16)).astype(np.float32) for _ in range(2))
    got = TL._bidirectional_attention(*map(torch.from_numpy, (q, k, v)))
    want = JL._bidirectional_attention(*map(jnp.asarray, (q, k, v)))
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)


def test_bidirectional_attention_keeps_fp32_probabilities_for_bf16():
    """On bf16 inputs the logits, softmax and P.V are fp32 (P never rounded)
    and only the output is cast back: the fp32 computation on the same
    bf16 values, rounded once."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, 6, 4, 16)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    got = TL._bidirectional_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    want = TL._bidirectional_attention(q.float(), k.float(), v.float()).to(torch.bfloat16)
    assert torch.equal(got, want)


def _whisper():
    cfg_j = jget_reduced("whisper-base", dtype="float32")
    jp, tp = _jax_params(cfg_j)
    return cfg_j, get_reduced("whisper-base", dtype="float32"), jp, tp


def test_cross_attention_and_cross_kv_match_jax():
    cfg_j, cfg, jp, tp = _whisper()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, 5, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    cross_j = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"][0]["cross"])
    cross_t = {n: w[0] for n, w in tp["blocks"][0]["cross"].items()}
    kj, vj = JL.cross_kv(cross_j, jnp.asarray(enc))
    kt, vt = TL.cross_kv(cross_t, torch.from_numpy(enc))
    for got, want in ((kt, kj), (vt, vj)):
        assert got.shape == want.shape == (B, cfg.encoder_seq, cfg.num_kv_heads,
                                           cfg.head_dim_)
        _close(got, want)
    _close(TL.cross_attention_apply(cross_t, torch.from_numpy(x), kt, vt, cfg),
           JL.cross_attention_apply(cross_j, jnp.asarray(x), kj, vj, cfg_j))
    # every decoder layer's K/V at once, stacked over the groups
    for (kt, vt), (kj, vj) in zip(TLM.cross_kv_all(tp, torch.from_numpy(enc), cfg),
                                  JLM.cross_kv_all(jp, jnp.asarray(enc), cfg_j)):
        assert kt.shape == kj.shape == (cfg.num_groups, B, cfg.encoder_seq,
                                        cfg.num_kv_heads, cfg.head_dim_)
        _close(kt, kj)
        _close(vt, vj)


def test_bidirectional_gqa_layer_matches_jax():
    """The encoder's self-attention layer (causal=False, tied KV copies):
    RoPE, then full attention, as JAX's ``gqa_apply(causal=False)``."""
    cfg_j = JLM.encoder_config(jget_reduced("whisper-base", dtype="float32",
                                            num_kv_heads=2, kv_pad_to=4))
    cfg = TLM.encoder_config(get_reduced("whisper-base", dtype="float32", num_kv_heads=2,
                                         kv_pad_to=4))
    assert not cfg.causal and cfg.kv_heads_effective == 4
    jp = jax.tree_util.tree_map(np.asarray,
                                JP.values(JL.gqa_init(jax.random.PRNGKey(4), cfg_j)))
    x = np.random.default_rng(4).normal(size=(B, 11, cfg.d_model)).astype(np.float32)
    out_j, (k_j, v_j) = JL.gqa_apply(jp, jnp.asarray(x), cfg_j, 0, causal=False)
    out, (k, v) = TL.gqa_apply(from_jax_lm_params(jp), torch.from_numpy(x), cfg, 0)
    for got, want in ((out, out_j), (k, k_j), (v, v_j)):
        _close(got, want)
    # not causal: the first position sees the last
    causal, _ = TL.gqa_apply(from_jax_lm_params(jp), torch.from_numpy(x),
                             dataclasses.replace(cfg, causal=True), 0)
    assert not torch.allclose(causal[:, 0], out[:, 0], atol=1e-3)


def test_encode_audio_matches_jax():
    cfg_j, cfg, jp, tp = _whisper()
    frames = np.random.default_rng(3).normal(
        size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    got = TLM.encode_audio(tp, torch.from_numpy(frames), cfg)
    want = JLM.encode_audio(jp, jnp.asarray(frames), cfg_j)
    assert got.shape == want.shape == (B, cfg.encoder_seq, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_cache_t0_and_decode_match_jax(arch):
    """prefill's cache (self-attention K/V; an audio decoder's cross K/V),
    last logits and t0 (a VLM's P + S), then three decode steps that read
    the cross K/V and carry them unchanged, all against JAX's."""
    cfg_j = jget_reduced(arch, dtype="float32")
    cfg = get_reduced(arch, dtype="float32")
    jp, tp = _jax_params(cfg_j)
    rng = np.random.default_rng(5)
    jb, tb = _batches(cfg, rng)
    cache_len = 32
    jcache, jlast, jt = JLM.prefill(jp, jb, cfg_j, cache_len)
    cache, last, t0 = TLM.prefill(tp, tb, cfg, cache_len)
    assert t0 == int(jt) == S + (cfg.num_patches if cfg.family == "vlm" else 0)
    _close(last, jlast)
    cross = {"cross_k", "cross_v"} if cfg.family == "audio" else set()
    for got, want in zip(cache, jcache):
        assert sorted(got) == sorted(want) and cross <= set(got)
        for key in want:
            assert tuple(got[key].shape) == want[key].shape
            _close(got[key], want[key])
    before = {k: w.clone() for c in cache for k, w in c.items() if k in cross}
    t = t0
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jlogits, jcache = JLM.decode_step(jp, jcache, jnp.asarray(tok), jnp.int32(t), cfg_j)
        logits, cache = TLM.decode_step(tp, cache, torch.from_numpy(tok), t, cfg)
        _close(logits, jlogits)
        t += 1
    for c in cache:
        for key in cross:
            assert torch.equal(c[key], before[key])


def test_vlm_server_starts_decoding_after_the_patches():
    """JAX's server decodes from t = P + prompt_len; the port's static
    position starts there too, and its tokens are JAX's."""
    cfg_j = jget_reduced("internvl2-26b", dtype="float32")
    cfg = get_reduced("internvl2-26b", dtype="float32")
    jp, tp = _jax_params(cfg_j)
    scfg = dict(max_batch=B, prompt_len=S, cache_len=S + cfg.num_patches + 4,
                max_new_tokens=4)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (16, 9)]
    extras = _extra(cfg, rng)
    srv = LMServer(tp, cfg, ServeConfig(**scfg), device="cpu")
    assert srv.t0 == cfg.num_patches + S
    got, _ = srv.generate(prompts, extras=extras)
    assert int(srv._pos) == srv.t0 + scfg["max_new_tokens"]
    want, _ = JLMServer(jp, cfg_j, JServeConfig(**scfg)).generate(prompts, extras=extras)
    np.testing.assert_array_equal(got, want)


def test_server_overflow_check_counts_the_patches():
    cfg = get_reduced("internvl2-26b", dtype="float32")
    params = TLM.init_params(torch.Generator().manual_seed(0), cfg)
    p = cfg.num_patches
    with pytest.raises(ValueError, match=f"{p} patches .* exceeds cache_len"):
        LMServer(params, cfg, ServeConfig(max_batch=1, prompt_len=16, cache_len=p + 20,
                                          max_new_tokens=5), device="cpu")
    LMServer(params, cfg, ServeConfig(max_batch=1, prompt_len=16, cache_len=p + 21,
                                      max_new_tokens=5), device="cpu")
    # the audio model's frames go to the encoder, not the cache
    wcfg = get_reduced("whisper-base", dtype="float32")
    LMServer(TLM.init_params(torch.Generator().manual_seed(0), wcfg), wcfg,
             ServeConfig(max_batch=1, prompt_len=16, cache_len=21, max_new_tokens=5),
             device="cpu")


def _old_init(gen, cfg):
    """``lm.init_params`` as the port drew it before ``params.casting``:
    each block position drawn whole in fp32 (stacked over the groups),
    then its leaves cast to the model dtype (no cross-attention then)."""
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    cast = lambda t: t.to(dt) if t.dim() >= 2 else t
    p = {"embed": cast(P.init_normal(gen, (cfg.vocab_size, cfg.d_model))),
         "final_norm": TL.rms_norm_init(cfg.d_model)}
    p["blocks"] = [
        {k: ({n: cast(w) for n, w in v.items()} if isinstance(v, dict) else cast(v))
         for k, v in TT.block_init(gen, cfg, pos, stack=(cfg.num_groups,)).items()}
        for pos in range(cfg.group_size)]
    if not cfg.tie_embeddings:
        p["lm_head"] = cast(P.init_normal(gen, (cfg.d_model, cfg.vocab_size)))
    return p


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _assert_same_bits(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "whisper-base"])
def test_init_casting_as_drawn_gives_the_old_draws_bit_for_bit(arch):
    cfg = get_reduced(arch)
    assert cfg.dtype == "bfloat16"
    new = TLM.init_params(torch.Generator().manual_seed(0), cfg)
    _assert_same_bits(new, _old_init(torch.Generator().manual_seed(0), cfg))
    assert new["blocks"][0]["ln1"].dtype == torch.bfloat16  # (G, d): cast
    assert new["final_norm"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_init_in_bf16_is_the_fp32_draws_cast(arch):
    """The model-dtype init equals drawing the whole tree in fp32 (the same
    draws in the same order) and casting every leaf of two or more
    dimensions afterwards."""
    cfg = get_reduced(arch)
    new = TLM.init_params(torch.Generator().manual_seed(0), cfg)
    f32 = TLM.init_params(torch.Generator().manual_seed(0),
                          dataclasses.replace(cfg, dtype="float32"))
    cast = lambda t: P.cast_leaf(t, torch.bfloat16)
    _assert_same_bits(new, jax.tree_util.tree_map(cast, f32))


@pytest.mark.parametrize("arch", FAMILIES)
def test_converted_tree_has_init_params_leaves(arch):
    """``from_jax_lm_params`` of JAX's bf16 tree: the encoder (``enc_blocks``,
    ``enc_norm``, ``enc_pos``) and cross-attention (``ln_cross``, ``cross``)
    leaves come with the rest; every leaf's path, shape and dtype is that
    of the port's own init."""
    cfg_j = jget_reduced(arch)
    jp = jax.jit(lambda key: JP.values(JLM.init_params(key, cfg_j)))(jax.random.PRNGKey(0))
    got = _leaves(from_jax_lm_params(jax.tree_util.tree_map(np.asarray, jp)))
    want = _leaves(TLM.init_params(torch.Generator().manual_seed(0), get_reduced(arch)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert (tuple(a.shape), a.dtype) == (tuple(b.shape), b.dtype), path
    paths = " ".join(p for p, _ in got)
    if arch == "whisper-base":
        assert "/enc_pos" in paths and "/cross/wk" in paths and "/ln_cross" in paths
    assert dict(got)["/final_norm"].dtype == torch.float32


@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_forward_shape_and_finite(arch):
    """JAX's ``test_reduced_config_forward_and_train_step``, its forward
    half (the port has no training yet)."""
    cfg = get_reduced(arch, dtype="float32")
    params = TLM.init_params(torch.Generator().manual_seed(0), cfg)
    _, batch = _batches(cfg, np.random.default_rng(0))
    hidden, aux = TLM.forward_hidden(params, batch, cfg)
    exp_s = S if cfg.family != "vlm" else S + cfg.num_patches
    assert tuple(hidden.shape) == (B, exp_s, cfg.d_model)
    assert torch.isfinite(hidden).all() and float(aux) == 0.0


@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_prefill_decode_consistency(arch):
    """JAX's ``test_reduced_config_prefill_decode_consistency``: decode after
    prefill(S-1) against forward(S)'s logits at the last position (a VLM's
    hidden states taken past its patches, as JAX's test does)."""
    cfg = get_reduced(arch, dtype="float32", capacity_factor=8.0)
    params = TLM.init_params(torch.Generator().manual_seed(0), cfg)
    _, batch = _batches(cfg, np.random.default_rng(0))
    cache, _, t0 = TLM.prefill(params, {**batch, "tokens": batch["tokens"][:, :S - 1]},
                               cfg, cache_len=S + 8 + cfg.num_patches)
    logits, _ = TLM.decode_step(params, cache, batch["tokens"][:, S - 1:S], t0, cfg)
    hidden, _ = TLM.forward_hidden(params, batch, cfg)
    if cfg.family == "vlm":
        hidden = hidden[:, cfg.num_patches:]
    assert hidden.shape[1] == S
    ref = TLM.logits_fn(params, hidden[:, -1], cfg)
    rel = float((logits - ref).abs().max() / (ref.abs().max() + 1e-6))
    assert rel < 2e-2, f"{arch}: decode diverges from forward ({rel:.2e})"


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_count(v) for v in tree)
    return tree.numel()


@pytest.mark.parametrize("arch", FAMILIES)
def test_full_config_counts_match_jax(arch):
    """JAX's ``test_full_config_validates_and_counts``: the full published
    config's parameters, counted without allocating (fake tensors here,
    ``eval_shape`` there): the port's count is JAX's (Whisper-base within
    JAX's published range, 0.05-0.12 B; InternVL2-26B 19.86 B)."""
    cfg = get_config(arch)
    cfg.validate()
    with FakeTensorMode():
        n_port = _count(TLM.init_params(torch.Generator().manual_seed(0), cfg))
    shapes = jax.eval_shape(lambda k: JP.values(JLM.init_params(k, jget_config(arch))),
                            jax.random.PRNGKey(0))
    n_jax = sum(math.prod(a.shape) for a in jax.tree_util.tree_leaves(shapes))
    assert n_port == n_jax
    if arch == "whisper-base":
        assert 0.05e9 < n_port < 0.12e9
    else:
        assert 19e9 < n_port < 21e9

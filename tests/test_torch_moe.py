"""The port's MoE family (``repro_torch.core.scatter_gather``'s slot helpers,
``repro_torch.models.moe``) against the JAX package's, on the CPU.

* ``rank_within_segment``, ``dispatch_to_slots`` (with and without
  ``valid``) and ``combine_from_slots`` on the same numpy ids and values:
  ``slot_index``, ``kept``, the slots and the combined rows bit for bit
  (the slots are copies; the port gathers them from the sorted order where
  JAX scatters); hypothesis counterparts of ``tests/test_core_properties.py``'s
  round trip and rank tests, with the same strategies.
* ``moe_apply``, dispatch and dense, on JAX's converted ``moe_init`` at
  rtol = atol = 1e-4 (fp32 GEMMs summed in another order), its aux loss at
  rtol 1e-5: Qwen3-MoE's renormalized top-k, Mixtral's, a GEGLU expert, and
  a tight capacity that drops tokens (the port sorts every row at once on
  ``expert * B + row``, JAX vmaps a sort per row: the same drops).
* Counterparts of ``tests/test_train_serve.py``'s MoE tests (dispatch ==
  dense at ample capacity through the whole model, the drop bound) and of
  ``tests/test_arch_smoke.py``'s decode-after-prefill check (capacity
  factor 8, so prefill(S-1) and forward(S) drop nothing), a converted
  tree with tied KV copies, and one bf16 MoE layer within JAX's bf16
  bound (2e-2 max|ref|).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import params as JP
from repro.configs import get_reduced as jget_reduced
from repro.core import scatter_gather as jsg
from repro.models import lm as JLM
from repro.models import moe as JMOE
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import from_jax_lm_params
from repro_torch.core import scatter_gather as tsg
from repro_torch.models import lm as TLM
from repro_torch.models import moe as TMOE
from repro_torch.models.config import ModelConfig

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
AUX_TOL = dict(rtol=1e-5, atol=0)
MOE_ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x7b")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(got, want):
    """Bit for bit: the same dtype kind, shape and values."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _slots_case(n_seg, e, cap, valid_share, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_seg, e).astype(np.int32)
    vals = rng.normal(size=(e, 3)).astype(np.float32)
    valid = rng.random(e) < valid_share if valid_share is not None else None
    return ids, vals, valid


def _both_dispatch(ids, vals, n_seg, cap, valid=None):
    want = jsg.dispatch_to_slots(jnp.asarray(vals), jnp.asarray(ids), n_seg, cap,
                                 None if valid is None else jnp.asarray(valid))
    got = tsg.dispatch_to_slots(torch.from_numpy(vals), torch.from_numpy(ids), n_seg,
                                cap, None if valid is None else torch.from_numpy(valid))
    return got, want


# (segments, elements, capacity): ample, tight, capacity 1, one element,
# no element, an empty segment (ids over 3 of 6), many elements a segment
SLOT_CASES = ((4, 40, 16), (4, 40, 3), (10, 33, 1), (2, 1, 8), (3, 0, 4), (6, 24, 2),
              (3, 500, 64))


@pytest.mark.parametrize("valid_share", (None, 0.7, 0.0))
@pytest.mark.parametrize("n_seg,e,cap", SLOT_CASES)
def test_slot_helpers_match_jax_bit_for_bit(n_seg, e, cap, valid_share):
    ids, vals, valid = _slots_case(n_seg, e, cap, valid_share, seed=n_seg * 1000 + e)
    if n_seg == 6:
        ids = ids % 3  # segments 3-5 empty
    got, want = _both_dispatch(ids, vals, n_seg, cap, valid)
    for g, w in zip(got, want):
        _same(g, w)
    _same(tsg.combine_from_slots(*got), jsg.combine_from_slots(*want))
    _same(tsg.rank_within_segment(torch.from_numpy(ids), n_seg),
          jsg.rank_within_segment(jnp.asarray(ids), n_seg))


def test_dropped_elements_take_the_sink_slot():
    """Every dropped element (over capacity or not valid) has slot
    num_segments * capacity and combines to zeros; kept slots are unique."""
    ids, vals, valid = _slots_case(4, 60, 5, 0.8, seed=3)
    (slots, slot, kept), _ = _both_dispatch(ids, vals, 4, 5, valid)
    assert (slot[~kept] == 4 * 5).all() and not kept[~torch.from_numpy(valid)].any()
    assert len(set(slot[kept].tolist())) == int(kept.sum())
    back = tsg.combine_from_slots(slots, slot, kept)
    assert not back[~kept].any()
    assert torch.equal(back[kept], torch.from_numpy(vals)[kept])


@settings(max_examples=30, deadline=None)
@given(
    st.integers(2, 10),  # segments
    st.integers(1, 40),  # elements
    st.integers(1, 8),  # capacity
)
def test_dispatch_combine_roundtrip(n_seg, e, cap):
    """Port counterpart of ``tests/test_core_properties.py``'s: every kept
    element returns to itself, dropped ones return 0, a segment keeps at
    most ``cap`` and keeps its first ``cap`` (FIFO); and every output is
    JAX's bit for bit."""
    rng = np.random.default_rng(n_seg * 100 + e)
    ids = rng.integers(0, n_seg, e).astype(np.int32)
    vals = rng.normal(size=(e, 3)).astype(np.float32)
    got, want = _both_dispatch(ids, vals, n_seg, cap)
    for g, w in zip(got, want):
        _same(g, w)
    back = tsg.combine_from_slots(*got)
    _same(back, jsg.combine_from_slots(*want))
    kept_np = got[2].numpy()
    np.testing.assert_allclose(back.numpy()[kept_np], vals[kept_np], rtol=1e-6)
    assert np.abs(back.numpy()[~kept_np]).max(initial=0.0) == 0.0
    for s in range(n_seg):
        where = np.where(ids == s)[0]
        assert kept_np[where].sum() <= cap
        np.testing.assert_array_equal(kept_np[where], np.arange(len(where)) < cap)


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 6), st.integers(2, 30))
def test_rank_within_segment(n_seg, e):
    rng = np.random.default_rng(e)
    ids = rng.integers(0, n_seg, e).astype(np.int32)
    rank = tsg.rank_within_segment(torch.from_numpy(ids), n_seg)
    _same(rank, jsg.rank_within_segment(jnp.asarray(ids), n_seg))
    rank = rank.numpy()
    for s in range(n_seg):
        got = rank[ids == s]
        # stable: ranks increase with position
        np.testing.assert_array_equal(got, np.arange(len(got)))


def _moe_case(arch, **kw):
    """(JAX cfg, port cfg, JAX moe params as numpy, port params) of one
    reduced MoE layer in fp32."""
    cfg_j = jget_reduced(arch, dtype="float32", **kw)
    cfg = get_reduced(arch, dtype="float32", **kw)
    jp = jax.tree_util.tree_map(np.asarray,
                                JP.values(JMOE.moe_init(jax.random.PRNGKey(1), cfg_j)))
    return cfg_j, cfg, jp, from_jax_lm_params(jp)


# (arch, config overrides): the published routing of each reduced arch, a
# GEGLU expert, and capacity factors that drop tokens (rows of S_MOE = 48
# tokens x top-2: Qwen3's 8 experts at 0.25 hold 8 slots for 12 a expert
# on average, Mixtral's 4 at 0.5 and 1.0 hold 16 and 24 for 24)
S_MOE = 48
MOE_CASES = (("qwen3-moe-30b-a3b", {}), ("mixtral-8x7b", {}),
             ("mixtral-8x7b", dict(mlp_type="geglu")),
             ("qwen3-moe-30b-a3b", dict(capacity_factor=0.25)),
             ("mixtral-8x7b", dict(capacity_factor=0.5)),
             ("mixtral-8x7b", dict(capacity_factor=1.0, norm_topk=True)))


@pytest.mark.parametrize("impl", ("dispatch", "dense"))
@pytest.mark.parametrize("arch,kw", MOE_CASES)
def test_moe_apply_matches_jax(arch, kw, impl):
    cfg_j, cfg, jp, tp = _moe_case(arch, moe_impl=impl, **kw)
    x = np.random.default_rng(4).normal(size=(3, S_MOE, cfg.d_model)).astype(np.float32)
    want, want_aux = JMOE.moe_apply(jp, jnp.asarray(x), cfg_j)
    got, aux = TMOE.moe_apply(tp, torch.from_numpy(x), cfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(_np(aux), np.asarray(want_aux), **AUX_TOL)
    _, none = TMOE.moe_apply(tp, torch.from_numpy(x), cfg, with_aux=False)
    assert none is None


@pytest.mark.parametrize("arch,kw", MOE_CASES[3:5])
def test_tight_capacity_drops_as_jax(arch, kw):
    """At a capacity that drops tokens the per-row drops are JAX's: the
    port's one sort over every row gives JAX's vmapped per-row ranks, and a
    token whose every assignment dropped outputs zeros."""
    cfg_j, cfg, jp, tp = _moe_case(arch, **kw)
    b, s, k, e = 3, S_MOE, cfg.experts_per_token, cfg.num_experts
    x = np.random.default_rng(4).normal(size=(b, s, cfg.d_model)).astype(np.float32)
    _, top_e, _ = TMOE._route(tp, torch.from_numpy(x).reshape(b * s, -1), cfg, False)
    seg = (top_e.reshape(b, s * k) * b + torch.arange(b)[:, None]).reshape(-1)
    rank = tsg.rank_within_segment(seg, e * b).reshape(b, s * k)
    per_row = jax.vmap(lambda ids: jsg.rank_within_segment(ids, e))(
        jnp.asarray(top_e.reshape(b, s * k).int().numpy()))
    _same(rank, per_row)
    assert (rank >= TMOE.capacity(cfg, s)).any()  # tokens drop
    got, _ = TMOE.moe_apply(tp, torch.from_numpy(x), cfg)
    want, _ = JMOE.moe_apply(jp, jnp.asarray(x), cfg_j)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_capacity_rule_is_jax():
    """max(int(cf * S * k / E), 1) rounded up to a multiple of 8."""
    for cf, s, k, e, want in ((1.25, 512, 8, 128, 40), (1.25, 5120, 2, 8, 1600),
                              (1.25, 1, 8, 128, 8), (1.25, 1, 2, 8, 8),
                              (8.0, 15, 2, 4, 64), (0.25, 16, 2, 8, 8), (1.0, 9, 3, 2, 16)):
        cfg = ModelConfig(num_experts=e, experts_per_token=k, capacity_factor=cf)
        assert TMOE.capacity(cfg, s) == want


def test_moe_dispatch_matches_dense_baseline():
    """Port counterpart of ``tests/test_train_serve.py``'s: the scatter-gather
    MoE equals the dense all-experts baseline at ample capacity, through
    the whole model (JAX's tiny config and its converted weights)."""
    kw = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=48,
              vocab_size=64, num_experts=4, experts_per_token=2, family="moe",
              capacity_factor=4.0, moe_impl="dispatch", attn_chunk=16, loss_chunk=16,
              remat=False, dtype="float32")
    cfg_j = JModelConfig(**kw).validate()
    cfg_d = ModelConfig(**kw).validate()
    cfg_dense = dataclasses.replace(cfg_d, moe_impl="dense")
    params = from_jax_lm_params(jax.tree_util.tree_map(
        np.asarray, JP.values(JLM.init_params(jax.random.PRNGKey(1), cfg_j))))
    tokens = np.random.default_rng(0).integers(0, 64, (2, 16))
    batch = {"tokens": torch.from_numpy(tokens)}
    h1, a1 = TLM.forward_hidden(params, batch, cfg_d)
    h2, a2 = TLM.forward_hidden(params, batch, cfg_dense)
    np.testing.assert_allclose(_np(h1), _np(h2), **TOL)
    assert torch.equal(a1, a2)  # the same routing
    want, _ = JLM.forward_hidden(JP.values(JLM.init_params(jax.random.PRNGKey(1), cfg_j)),
                                 {"tokens": jnp.asarray(tokens, jnp.int32)}, cfg_j)
    np.testing.assert_allclose(_np(h1), np.asarray(want), **TOL)


def test_moe_capacity_drops_are_bounded():
    """Port counterpart of ``tests/test_train_serve.py``'s: 128 elements
    over 4 segments of capacity 16 keep at most 64."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 4, 128).astype(np.int32)
    vals = rng.normal(size=(128, 8)).astype(np.float32)
    (_, _, kept), (_, _, want) = _both_dispatch(ids, vals, 4, 16)
    assert int(kept.sum()) <= 64
    _same(kept, want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_after_prefill_matches_forward(arch):
    """Counterpart of ``tests/test_arch_smoke.py``'s check at capacity
    factor 8 (no drops): decode after prefill(S-1) gives forward(S)'s last
    logits, and both give JAX's."""
    cfg_j = jget_reduced(arch, dtype="float32", capacity_factor=8.0)
    cfg = get_reduced(arch, dtype="float32", capacity_factor=8.0)
    jp = JP.values(JLM.init_params(jax.random.PRNGKey(0), cfg_j))
    tp = from_jax_lm_params(jax.tree_util.tree_map(np.asarray, jp))
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 12))
    cache, _, t0 = TLM.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :-1])}, cfg, 20)
    logits, _ = TLM.decode_step(tp, cache, torch.from_numpy(tokens[:, -1:]), t0, cfg)
    hidden, _ = TLM.forward_hidden(tp, {"tokens": torch.from_numpy(tokens)}, cfg)
    ref = TLM.logits_fn(tp, hidden[:, -1], cfg)
    assert float((logits - ref).abs().max() / ref.abs().max()) < 1e-4
    jcache, _, jt = JLM.prefill(jp, {"tokens": jnp.asarray(tokens[:, :-1], jnp.int32)},
                                cfg_j, 20)
    want, _ = JLM.decode_step(jp, jcache, jnp.asarray(tokens[:, -1:], jnp.int32), jt, cfg_j)
    np.testing.assert_allclose(_np(logits), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_converted_tree_with_tied_kv_copies_matches_jax(arch):
    """``from_jax_lm_params`` carries router, wi and wo leaf for leaf beside
    the attention's under ``kv_pad_to``: forward and prefill logits are
    JAX's, and the cache has the padded head count."""
    cfg_j = jget_reduced(arch, dtype="float32", kv_pad_to=4)
    cfg = get_reduced(arch, dtype="float32", kv_pad_to=4)
    assert cfg.kv_heads_effective == 4 > cfg.num_kv_heads
    jp = JP.values(JLM.init_params(jax.random.PRNGKey(2), cfg_j))
    tp = from_jax_lm_params(jax.tree_util.tree_map(np.asarray, jp))
    moe = tp["blocks"][0]["ffn"]
    assert sorted(moe) == ["router", "wi", "wo"]
    assert tuple(moe["wi"].shape) == (cfg.num_groups, cfg.num_experts, cfg.d_model, 2,
                                      cfg.d_ff)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 10))
    want, want_aux = JLM.forward_hidden(jp, {"tokens": jnp.asarray(tokens, jnp.int32)},
                                        cfg_j)
    got, aux = TLM.forward_hidden(tp, {"tokens": torch.from_numpy(tokens)}, cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(aux), np.asarray(want_aux), **AUX_TOL)
    cache, last, _ = TLM.prefill(tp, {"tokens": torch.from_numpy(tokens)}, cfg, 16)
    _, jlast, _ = JLM.prefill(jp, {"tokens": jnp.asarray(tokens, jnp.int32)}, cfg_j, 16)
    np.testing.assert_allclose(_np(last), np.asarray(jlast), **TOL)
    assert cache[0]["k"].shape[3] == 4


@pytest.mark.parametrize("impl", ("dispatch", "dense"))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_moe_layer_within_jax_bf16_bound(arch, impl):
    """One MoE layer in bf16 (JAX's weights and input cast to bf16): within
    JAX's bf16 bound, 2e-2 max|ref| (one layer: about one bf16 ulp).  The
    whole reduced model is not held in bf16: the two packages' hidden
    states differ by bf16 roundings, and where a token's
    router probabilities nearly tie, one picks another expert than the
    other, and that token's logits then differ by the order of max|ref|;
    in fp32 the model is held at 1e-4 (``test_torch_lm.py``)."""
    cfg_j = jget_reduced(arch, moe_impl=impl)
    cfg = get_reduced(arch, moe_impl=impl)
    assert cfg.dtype == "bfloat16"
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                JP.values(JMOE.moe_init(jax.random.PRNGKey(1), cfg_j)))
    tp = from_jax_lm_params(jax.tree_util.tree_map(np.asarray, jp))
    assert tp["wi"].dtype == torch.bfloat16
    x = np.random.default_rng(4).normal(size=(3, 16, cfg.d_model)).astype(np.float32)
    want, _ = JMOE.moe_apply(jp, jnp.asarray(x).astype(jnp.bfloat16), cfg_j)
    got, _ = TMOE.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    assert np.abs(_np(got) - want).max() <= 2e-2 * np.abs(want).max()

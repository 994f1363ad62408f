"""The port's state-space mixers (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``), on the CPU, at the reduced Jamba (Mamba:
d_inner 128, d_state 4, ssm_chunk 8) and RWKV-6 (4 heads of 16) widths in
float32.

Parameters are JAX's init with every leaf moved off its init value by
numpy noise (the token-shift mixers, biases and the group norm's bias
start at zero, which would hide their paths), converted leaf for leaf;
inputs are numpy draws handed to both.  Modes: train (no state), prefill
(``return_state``: the final state) and a run of decode steps from the
prefill state, at S a multiple of ``ssm_chunk`` and not (13, 16, 21).

Tolerances: the depthwise conv is the same products summed in the same
order (rtol = atol = 1e-6); everything else rtol = atol = 1e-5 (fp32
matmuls of other widths, the port's in-order scan against JAX's
associative one, the RWKV u-bonus summed apart).  Each recurrent state,
after prefill and after every decode step, is held at rtol 1e-5 and atol
1e-5 max|state|: RWKV's wkv sums k v^T terms of up to ~20 into elements
near 0, and the two packages round the decayed sum apart (a fused
multiply-add against a product and a sum), so an element near 0 carries
the absolute error of the large ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import params as JP
from repro.configs import get_reduced as jget_reduced
from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch.configs import get_reduced
from repro_torch.convert import from_jax_lm_params
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-6, atol=1e-6)
B = 2
LENGTHS = (13, 16, 21)  # ssm_chunk 8: ragged, a multiple, ragged past two chunks
N_DECODE = 5


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def _params(init, arch, seed):
    """(JAX cfg, port cfg, JAX params, port params): JAX's init of one
    mixer, every leaf perturbed by N(0, 0.1) numpy noise."""
    cfg_j = jget_reduced(arch, dtype="float32")
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
        JP.values(init(jax.random.PRNGKey(seed), cfg_j)))
    return cfg_j, get_reduced(arch, dtype="float32"), jp, from_jax_lm_params(jp)


def _x(cfg, s, seed):
    return np.random.default_rng(seed).normal(size=(B, s, cfg.d_model)).astype(np.float32)


def _state_close(got: dict, want: dict):
    """Each entry at rtol 1e-5, atol 1e-5 max|entry|."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        w = np.asarray(want[k], np.float32)
        _close(got[k], w, dict(rtol=1e-5, atol=1e-5 * float(np.abs(w).max())))


# ---------------------------------------------------------------- Mamba


def test_mamba_init_matches_jax():
    cfg_j = jget_reduced("jamba-v0.1-52b", dtype="float32")
    jp = JP.values(JS.mamba_init(jax.random.PRNGKey(0), cfg_j))
    tp = TS.mamba_init(torch.Generator().manual_seed(0),
                       get_reduced("jamba-v0.1-52b", dtype="float32"), stack=(3,))
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == (3,) + jp[k].shape and tp[k].dtype == torch.float32
    for k in ("a_log", "conv_b", "dt_bias", "d_skip"):  # deterministic leaves
        for g in range(3):
            np.testing.assert_array_equal(_np(tp[k][g]), np.asarray(jp[k]))


@pytest.mark.parametrize("with_state", (False, True))
@pytest.mark.parametrize("s", (1, 13))
def test_causal_conv_matches_jax(s, with_state):
    rng = np.random.default_rng(s)
    x = rng.normal(size=(B, s, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    st = rng.normal(size=(B, 3, 24)).astype(np.float32) if with_state else None
    y_j, st_j = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                None if st is None else jnp.asarray(st))
    y, st_t = TS._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)),
                              None if st is None else torch.from_numpy(st))
    _close(y, y_j, CONV_TOL)
    _close(st_t, st_j, CONV_TOL)


def test_ssm_params_match_jax():
    cfg_j, cfg, jp, tp = _params(JS.mamba_init, "jamba-v0.1-52b", 1)
    xi = np.random.default_rng(2).normal(size=(B, 11, cfg.d_inner)).astype(np.float32)
    for got, want in zip(TS._ssm_params(tp, torch.from_numpy(xi), cfg),
                         JS._ssm_params(jp, jnp.asarray(xi), cfg_j)):
        assert got.dtype == torch.float32
        _close(got, want)


@pytest.mark.parametrize("c", (1, 8, 13))
def test_chunk_scan_matches_jax(c):
    rng = np.random.default_rng(c)
    da = rng.uniform(0.5, 1.0, size=(B, c, 6, 4)).astype(np.float32)
    db = rng.normal(size=(B, c, 6, 4)).astype(np.float32)
    h0 = rng.normal(size=(B, 6, 4)).astype(np.float32)
    h_all_j, h_last_j = JS._chunk_scan(jnp.asarray(da), jnp.asarray(db), jnp.asarray(h0))
    h_all, h_last = TS._chunk_scan(*(torch.from_numpy(a) for a in (da, db, h0)))
    _close(h_all, h_all_j)
    _close(h_last, h_last_j)


@pytest.mark.parametrize("s", LENGTHS)
def test_mamba_train_prefill_and_decode_match_jax(s):
    cfg_j, cfg, jp, tp = _params(JS.mamba_init, "jamba-v0.1-52b", 3)
    x = _x(cfg, s, s)
    out_j, none_j = JS.mamba_apply(jp, jnp.asarray(x), cfg_j)
    out, none = TS.mamba_apply(tp, torch.from_numpy(x), cfg)
    assert none is None and none_j is None
    _close(out, out_j)
    out_j, st_j = JS.mamba_apply(jp, jnp.asarray(x), cfg_j, return_state=True)
    out, st = TS.mamba_apply(tp, torch.from_numpy(x), cfg, return_state=True)
    _close(out, out_j)
    _state_close(st, st_j)
    assert st["ssm"].dtype == torch.float32
    steps = _x(cfg, N_DECODE, 100 + s)
    for i in range(N_DECODE):
        out_j, st_j = JS.mamba_apply(jp, jnp.asarray(steps[:, i:i + 1]), cfg_j, state=st_j)
        out, st = TS.mamba_apply(tp, torch.from_numpy(steps[:, i:i + 1]), cfg, state=st)
        _close(out, out_j)
        _state_close(st, st_j)


def test_mamba_decode_after_prefill_is_the_longer_prefill():
    """Prefill(S) then one decode step gives prefill(S + 1)'s last output
    and final state, at S = 15 (the chunk of 8 ragged on both sides)."""
    _, cfg, _, tp = _params(JS.mamba_init, "jamba-v0.1-52b", 4)
    x = torch.from_numpy(_x(cfg, 16, 5))
    _, st = TS.mamba_apply(tp, x[:, :15], cfg, return_state=True)
    step, st = TS.mamba_apply(tp, x[:, 15:], cfg, state=st)
    full, st_full = TS.mamba_apply(tp, x, cfg, return_state=True)
    _close(step, _np(full[:, 15:]))
    _state_close(st, {k: _np(v) for k, v in st_full.items()})


# ---------------------------------------------------------------- RWKV-6


def test_rwkv6_init_matches_jax():
    cfg_j = jget_reduced("rwkv6-1.6b", dtype="float32")
    jp = JP.values(JS.rwkv6_init(jax.random.PRNGKey(0), cfg_j))
    tp = TS.rwkv6_init(torch.Generator().manual_seed(0),
                       get_reduced("rwkv6-1.6b", dtype="float32"), stack=(2,))
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == (2,) + jp[k].shape
    for k in ("w0", "mix_x", "mix_wkvrg", "gn_scale", "gn_bias"):
        np.testing.assert_allclose(_np(tp[k][1]), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
    # relu_sq: the channel mix's leaves
    mj = JP.values(JL.mlp_init(jax.random.PRNGKey(1), cfg_j))
    mt = TL.mlp_init(torch.Generator().manual_seed(1),
                     get_reduced("rwkv6-1.6b", dtype="float32"))
    assert {k: tuple(v.shape) for k, v in mt.items()} == {k: v.shape for k, v in mj.items()}
    with pytest.raises(ValueError, match="rwkv_channel_mix"):
        TL.mlp_apply(mt, torch.zeros(1, 2, 64), get_reduced("rwkv6-1.6b"))


def test_token_shift_matches_jax():
    x = np.random.default_rng(0).normal(size=(B, 7, 8)).astype(np.float32)
    last = np.random.default_rng(1).normal(size=(B, 1, 8)).astype(np.float32)
    for lt in (None, last):
        want = JS._token_shift(jnp.asarray(x), None if lt is None else jnp.asarray(lt))
        got = TS._token_shift(torch.from_numpy(x), None if lt is None else torch.from_numpy(lt))
        np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("s", LENGTHS)
def test_rwkv6_time_mix_train_prefill_and_decode_match_jax(s):
    cfg_j, cfg, jp, tp = _params(JS.rwkv6_init, "rwkv6-1.6b", 5)
    x = _x(cfg, s, s)
    out_j, _ = JS.rwkv6_time_mix(jp, jnp.asarray(x), cfg_j)
    out, none = TS.rwkv6_time_mix(tp, torch.from_numpy(x), cfg)
    assert none is None
    _close(out, out_j)
    out_j, st_j = JS.rwkv6_time_mix(jp, jnp.asarray(x), cfg_j, return_state=True)
    out, st = TS.rwkv6_time_mix(tp, torch.from_numpy(x), cfg, return_state=True)
    _close(out, out_j)
    _state_close(st, st_j)
    assert st["wkv"].dtype == torch.float32
    steps = _x(cfg, N_DECODE, 200 + s)
    for i in range(N_DECODE):
        out_j, st_j = JS.rwkv6_time_mix(jp, jnp.asarray(steps[:, i:i + 1]), cfg_j,
                                        state=st_j)
        out, st = TS.rwkv6_time_mix(tp, torch.from_numpy(steps[:, i:i + 1]), cfg, state=st)
        _close(out, out_j)
        _state_close(st, st_j)


@pytest.mark.parametrize("s", LENGTHS)
def test_rwkv_channel_mix_train_prefill_and_decode_match_jax(s):
    cfg_j, cfg, jp, tp = _params(JL.mlp_init, "rwkv6-1.6b", 6)
    x = _x(cfg, s, s)
    out_j, _ = JS.rwkv_channel_mix(jp, jnp.asarray(x), cfg_j)
    out, none = TS.rwkv_channel_mix(tp, torch.from_numpy(x), cfg)
    assert none is None
    _close(out, out_j)
    out_j, st_j = JS.rwkv_channel_mix(jp, jnp.asarray(x), cfg_j, return_state=True)
    out, st = TS.rwkv_channel_mix(tp, torch.from_numpy(x), cfg, return_state=True)
    _close(out, out_j)
    _state_close(st, st_j)
    steps = _x(cfg, N_DECODE, 300 + s)
    for i in range(N_DECODE):
        out_j, st_j = JS.rwkv_channel_mix(jp, jnp.asarray(steps[:, i:i + 1]), cfg_j,
                                          state=st_j)
        out, st = TS.rwkv_channel_mix(tp, torch.from_numpy(steps[:, i:i + 1]), cfg,
                                      state=st)
        _close(out, out_j)
        _state_close(st, st_j)


def test_rwkv6_decode_after_prefill_is_the_longer_prefill():
    _, cfg, _, tp = _params(JS.rwkv6_init, "rwkv6-1.6b", 7)
    x = torch.from_numpy(_x(cfg, 12, 8))
    _, st = TS.rwkv6_time_mix(tp, x[:, :11], cfg, return_state=True)
    step, st = TS.rwkv6_time_mix(tp, x[:, 11:], cfg, state=st)
    full, st_full = TS.rwkv6_time_mix(tp, x, cfg, return_state=True)
    _close(step, _np(full[:, 11:]))
    _state_close(st, {k: _np(v) for k, v in st_full.items()})

"""The port's AdamW and int8 error-feedback compression
(``repro_torch.optim``) against the JAX package's, on the CPU.

Counterparts of ``tests/test_optim.py``'s five tests, then parity with
``repro.optim``: ``update`` over 3 steps from one state on one numpy tree
(matrices and vectors, a step whose gradient is clipped), fp32 parameters
and moments at rtol 1e-6 / atol 1e-7 and bf16 parameters within one bf16
ulp (2^-8 relative: an fp32 update one ulp apart may round to the other
bf16 neighbour); ``schedule`` and ``global_norm`` at rtol 1e-6;
``quantize`` / ``ef_compress``: the int8 payload and the fp32 scale bit
for bit, the dequantized gradients and the residual at rtol 1e-6 / atol
1e-7 (fp32 round-off).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro_torch.convert import from_jax_opt_state, to_numpy
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-6, atol=1e-7)


def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.3, warmup_steps=5, total_steps=4000,
                            weight_decay=0.0, grad_clip=100.0)
    params = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(16,)) * 5).float()}
    target = torch.ones(16)
    state = adamw.init(params)
    start = float((params["w"] - target).abs().max())
    for _ in range(400):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw.update(cfg, g, state, params)
    end = float((params["w"] - target).abs().max())
    assert end < 0.05 * start, (start, end)


def test_warmup_cosine_schedule():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(adamw.schedule(cfg, torch.tensor(0))) == 0.0
    assert np.isclose(float(adamw.schedule(cfg, torch.tensor(10))), 1.0)
    assert np.isclose(float(adamw.schedule(cfg, torch.tensor(100))), 0.1, atol=1e-3)
    assert 0.1 < float(adamw.schedule(cfg, torch.tensor(55))) < 1.0


def test_grad_clipping_bounds_update():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=0, total_steps=10,
                            grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = adamw.init(params)
    new_params, state, m = adamw.update(cfg, {"w": torch.full((4,), 1e6)}, state, params)
    assert float(m["grad_norm"]) > 1e5
    assert float(new_params["w"].abs().max()) < 10.0


def test_weight_decay_applies_to_matrices_only():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10,
                            weight_decay=1.0, grad_clip=1e9)
    params = {"mat": torch.ones((4, 4)), "vec": torch.ones(4)}
    state = adamw.init(params)
    zeros = adamw.tree_map(torch.zeros_like, params)
    new_params, *_ = adamw.update(cfg, zeros, state, params)
    assert float(new_params["mat"].max()) < 1.0
    assert np.isclose(float(new_params["vec"].max()), 1.0)


def test_moments_shapes_match_params():
    params = {"a": torch.zeros((3, 5)), "b": {"c": torch.zeros(7)}}
    st = adamw.init(params)
    assert st["m"]["a"].shape == (3, 5) and st["m"]["a"].dtype == torch.float32
    assert st["v"]["b"]["c"].shape == (7,)
    assert st["step"].dtype == torch.int32 and st["step"].dim() == 0


def _tree(rng):
    """A parameter tree like an LM's: stacked matrices, a list, vectors."""
    return {"blocks": [{"w": rng.normal(size=(2, 6, 5)), "ln": rng.normal(size=(2, 5))}],
            "embed": rng.normal(size=(9, 5)), "final_norm": rng.normal(size=(5,))}


def _np(tree, dtype=np.float32):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_matches_jax_over_three_steps(dtype):
    rng = np.random.default_rng(7)
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0)
    jcfg = JA.AdamWConfig(**vars(cfg))
    p0 = _np(_tree(rng))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    # matrices in the model dtype, vectors fp32 (init_params' rule)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt if a.ndim >= 2 else jnp.float32),
                                p0)
    jst = JA.init(jp)
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            torch.bfloat16 if a.ndim >= 2 and dtype == "bfloat16" else torch.float32), jp)
    tst = from_jax_opt_state(jax.tree_util.tree_map(np.asarray, jst))
    for step in range(3):
        grads = _np(jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape), p0))
        if step == 1:  # a large gradient: clipped by the global norm
            grads = jax.tree_util.tree_map(lambda a: a * 100, grads)
        jp, jst, jm = JA.update(jcfg, jax.tree_util.tree_map(jnp.asarray, grads), jst, jp)
        tp, tst, tm = adamw.update(cfg, jax.tree_util.tree_map(torch.from_numpy, grads),
                                   tst, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(tst["step"]) == int(jst["step"]) == 3
    for name, got, want in (("m", tst["m"], jst["m"]), ("v", tst["v"], jst["v"])):
        for g, w in zip(adamw.leaves(to_numpy(got)), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g, np.asarray(w), err_msg=name, **F32_TOL)
    for g, w, t in zip(adamw.leaves(to_numpy(tp)), jax.tree_util.tree_leaves(jp),
                       adamw.leaves(tp)):
        w = np.asarray(w, np.float32)
        if t.dtype == torch.bfloat16:
            np.testing.assert_allclose(g, w, rtol=2.0 ** -8, atol=0)
        else:
            np.testing.assert_allclose(g, w, **F32_TOL)


def test_schedule_matches_jax():
    for cfg in (adamw.AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000),
                adamw.AdamWConfig(lr=1.0, warmup_steps=7, total_steps=40, min_lr_ratio=0.2),
                adamw.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=1)):
        jcfg = JA.AdamWConfig(**vars(cfg))
        steps = np.array([0, 1, 2, 5, 7, 50, 99, 100, 101, 5000, 9999, 10_000, 20_000],
                         np.int32)
        got = adamw.schedule(cfg, torch.from_numpy(steps)).numpy()
        want = np.asarray(JA.schedule(jcfg, jnp.asarray(steps)))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_global_norm_matches_jax():
    tree = _np(_tree(np.random.default_rng(8)))
    got = float(adamw.global_norm(jax.tree_util.tree_map(torch.from_numpy, tree)))
    np.testing.assert_allclose(got, float(JA.global_norm(tree)), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_payload_and_scale_bit_for_bit(dtype):
    rng = np.random.default_rng(9)
    # ties at .5 after scaling: round half to even in both packages
    xs = [rng.normal(size=(64, 33)) * 3, np.array([127.0, -63.5, 0.5, 1.5, -2.5, 0.0]),
          np.zeros((4,)), rng.normal(size=(1000,)) * 1e-8]
    for x in xs:
        x = np.asarray(x, np.float32)
        jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        jq, js = JC.quantize(jx)
        tq, ts = comp.quantize(tx)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(comp.dequantize(tq, ts).numpy(),
                                      np.asarray(JC.dequantize(jq, js)))


def test_ef_compress_matches_jax_over_steps():
    rng = np.random.default_rng(10)
    shapes = _np(_tree(rng))
    jerr = JC.init_error_buf(shapes)
    terr = comp.init_error_buf(jax.tree_util.tree_map(torch.from_numpy, shapes))
    assert all(e.dtype == torch.float32 and not e.any() for e in adamw.leaves(terr))
    for _ in range(3):
        g = _np(jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape), shapes))
        jg, jerr = JC.ef_compress(jax.tree_util.tree_map(jnp.asarray, g), jerr)
        tg, terr = comp.ef_compress(jax.tree_util.tree_map(torch.from_numpy, g), terr)
        for got, want in ((tg, jg), (terr, jerr)):
            for a, b in zip(adamw.leaves(to_numpy(got)), jax.tree_util.tree_leaves(want)):
                np.testing.assert_allclose(a, np.asarray(b), **F32_TOL)
    # the payload of the corrected gradient, bit for bit
    leaf = np.asarray(jax.tree_util.tree_leaves(jerr)[0]) + 1.0
    np.testing.assert_array_equal(comp.quantize(torch.from_numpy(leaf))[0].numpy(),
                                  np.asarray(JC.quantize(jnp.asarray(leaf))[0]))


def test_opt_state_converts_both_ways_bit_for_bit():
    tree = _np(_tree(np.random.default_rng(11)))
    jst = JA.init(tree)
    jst = {"m": jax.tree_util.tree_map(lambda a: a + 1.5, jst["m"]),
           "v": jax.tree_util.tree_map(lambda a: a + 0.25, jst["v"]),
           "step": jnp.asarray(5, jnp.int32)}
    host = jax.tree_util.tree_map(np.asarray, jst)
    tst = from_jax_opt_state(host)
    assert tst["step"].dtype == torch.int32 and int(tst["step"]) == 5
    back = to_numpy(tst)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(host)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(host)

"""The port's training path on the CPU: the loop (``repro_torch.train``),
its launcher, the token data, the logical axes and remat, against the JAX
package where both have the piece.

  * the loop: counterparts of ``tests/test_train_serve.py:28-69`` (the loss
    falls and the loop recovers from an injected failure; compressed and
    uncompressed training end close; the token stream's determinism and
    sharding), and ``train()`` on that file's ``TINY`` config for 10
    steps from one state (JAX's init), with and without compression, each
    step's loss, ce, grad_norm and lr held to JAX's history (rtol 1e-5, and
    2e-3 with compression: ``HISTORY_RTOL``), the final parameters at rtol
    1e-3 / atol 1e-5 (atol 1e-2, the learning rate, with compression:
    ``PARAMS_TOL``);
  * the token data bit for bit with JAX's (``SyntheticTokens``,
    ``BinTokenDataset``, ``write_synthetic_corpus``);
  * ``lm.param_axes`` equal to JAX's ``P.axes(init_params(...))`` leaf for
    leaf for all ten configs;
  * remat on and off give the same loss and gradients bit for bit, for all
    ten reduced configs;
  * the launcher as a process on the CPU (its mesh flags:
    ``test_torch_train_mesh_launch.py``).
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import params as JP
from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.configs import get_reduced as jget_reduced
from repro.data import pipeline as JD
from repro.models import lm as JLM
from repro.models.config import ModelConfig as JModelConfig
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.loop import LoopConfig as JLoopConfig
from repro.train.loop import train as jtrain
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.convert import from_jax_lm_params, to_numpy
from repro_torch.data import pipeline as TD
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, loss_and_grads, train

from test_torch_train_parity import inputs

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TINY_KW = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
               vocab_size=64, attn_chunk=16, loss_chunk=16, remat=False, dtype="float32")
TINY = ModelConfig(**TINY_KW).validate()
# by compression: off, fp32 round-off (6e-7 at most on these inputs); on,
# a gradient one ulp apart can round its int8 element to the next quantum
# (amax / 127), and that grows over the steps (grad_norm 7.4e-4 by step 10)
HISTORY_RTOL = {False: 1e-5, True: 2e-3}
# the final parameters by compression: with it, an element whose int8 value
# flipped takes another Adam step, which moves it by up to ~lr (3.1e-3 at
# most here, lr 1e-2)
PARAMS_TOL = {False: dict(rtol=1e-3, atol=1e-5), True: dict(rtol=1e-3, atol=1e-2)}


def _data(**kw):
    return TD.SyntheticTokens(TD.TokenPipelineConfig(vocab_size=64, batch=4, seq_len=16, **kw))


def test_loss_decreases_and_recovers_from_failure():
    with tempfile.TemporaryDirectory() as d:
        out = train(TINY, AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=40),
                    LoopConfig(steps=40, log_every=10, ckpt_every=10, ckpt_dir=d,
                               max_retries=2),
                    _data(), inject_failure_at=25, device="cpu")
        h = out["history"]
        assert h[-1]["loss"] < h[0]["loss"]
        assert [e["step"] for e in out["events"] if e["event"] == "failure"] == [25]
        assert h[-1]["step"] == 40
        # what the loop saved last restores onto the live tree bit for bit
        live = {"params": out["params"], "opt": out["opt_state"]}
        step, got = CheckpointManager(d).restore(template=live)
        assert step == 40
        for g, w in zip(adamw.leaves(got), adamw.leaves(live)):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert not any(p.requires_grad for p in adamw.leaves(out["params"]))


def test_failure_before_any_checkpoint_restarts_the_optimizer():
    with tempfile.TemporaryDirectory() as d:
        out = train(TINY, AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6),
                    LoopConfig(steps=6, log_every=1, ckpt_every=100, ckpt_dir=d),
                    _data(), inject_failure_at=3, device="cpu")
    steps = [h["step"] for h in out["history"]]
    assert steps == [1, 2, 3, 1, 2, 3, 4, 5, 6]  # step 0 again, the params kept
    assert int(out["opt_state"]["step"]) == 6


def test_grad_compression_training_matches_uncompressed_closely():
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        base = train(TINY, AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=30),
                     LoopConfig(steps=30, ckpt_every=1000, ckpt_dir=d1), _data(),
                     device="cpu")
        comp = train(TINY, AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=30),
                     LoopConfig(steps=30, ckpt_every=1000, ckpt_dir=d2,
                                grad_compression=True), _data(), device="cpu")
    l_base, l_comp = base["history"][-1]["loss"], comp["history"][-1]["loss"]
    assert l_base != l_comp and abs(l_base - l_comp) < 0.25 * l_base


@pytest.mark.parametrize("compression", [False, True])
def test_train_history_matches_jax(compression, monkeypatch):
    """10 steps of ``train()`` on TINY from JAX's init, with a checkpoint at
    step 5 and a failure injected at step 7 (restored from step 5).  JAX's
    loop asks for the latest checkpoint without waiting for a save in
    flight, so its saves are made blocking here; the port's loop waits."""
    monkeypatch.setattr(sys.modules["repro.train.loop"], "CheckpointManager",
                        _BlockingJaxManager)
    jcfg = JModelConfig(**TINY_KW).validate()
    jparams = JP.values(JLM.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = from_jax_lm_params(jax.tree_util.tree_map(np.asarray, jparams))
    opt = dict(lr=1e-2, warmup_steps=3, total_steps=10)
    loop = dict(steps=10, log_every=1, ckpt_every=5, grad_compression=compression)
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        want = jtrain(jcfg, JAdamWConfig(**opt), JLoopConfig(ckpt_dir=d1, **loop),
                      JD.SyntheticTokens(JD.TokenPipelineConfig(64, 4, 16)),
                      params=JLM.init_params(jax.random.PRNGKey(0), jcfg),
                      inject_failure_at=7)
        got = train(TINY, AdamWConfig(**opt), LoopConfig(ckpt_dir=d2, **loop), _data(),
                    params=tparams, inject_failure_at=7, device="cpu")
    assert [h["step"] for h in got["history"]] == [h["step"] for h in want["history"]]
    failures = lambda out: [e["step"] for e in out["events"] if e["event"] == "failure"]
    assert failures(got) == failures(want) == [7]  # stragglers are timing noise
    for g, w in zip(got["history"], want["history"]):
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=HISTORY_RTOL[compression], err_msg=k)
    for g, w in zip(adamw.leaves(to_numpy(got["params"])),
                    jax.tree_util.tree_leaves(want["params"])):
        np.testing.assert_allclose(g, np.asarray(w), **PARAMS_TOL[compression])


class _BlockingJaxManager(JaxManager):
    def save(self, step, tree, axes_tree=None, blocking=False):
        super().save(step, tree, axes_tree=axes_tree, blocking=True)


def test_token_data_bit_for_bit_with_jax(tmp_path):
    for kw in (dict(vocab_size=100, batch=8, seq_len=32, seed=5),
               dict(vocab_size=65024, batch=2, seq_len=64, seed=0, zipf_a=1.1),
               dict(vocab_size=100, batch=8, seq_len=32, seed=5, shard_index=1,
                    shard_count=2)):
        t, j = TD.SyntheticTokens(TD.TokenPipelineConfig(**kw)), JD.SyntheticTokens(
            JD.TokenPipelineConfig(**kw))
        for step in (0, 3, 1000):
            a, b = t.batch_at(step)["tokens"], j.batch_at(step)["tokens"]
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    path_t, path_j = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    TD.write_synthetic_corpus(path_t, 5000, 300, seed=4)
    JD.write_synthetic_corpus(path_j, 5000, 300, seed=4)
    assert open(path_t, "rb").read() == open(path_j, "rb").read()
    for kw in (dict(shard_index=0, shard_count=1), dict(shard_index=1, shard_count=2)):
        cfg = dict(vocab_size=250, batch=3, seq_len=17, seed=2, **kw)
        t = TD.BinTokenDataset(path_t, TD.TokenPipelineConfig(**cfg))
        j = JD.BinTokenDataset(path_j, JD.TokenPipelineConfig(**cfg))
        for step in (0, 9):
            np.testing.assert_array_equal(t.batch_at(step)["tokens"],
                                          j.batch_at(step)["tokens"])
        assert next(iter(t))["tokens"].shape == (3, 17)


def test_data_pipeline_determinism_and_sharding():
    cfg = TD.TokenPipelineConfig(vocab_size=100, batch=8, seq_len=32, seed=5)
    a = TD.SyntheticTokens(cfg).batch_at(3)["tokens"]
    np.testing.assert_array_equal(a, TD.SyntheticTokens(cfg).batch_at(3)["tokens"])
    assert not np.array_equal(a, TD.SyntheticTokens(cfg).batch_at(4)["tokens"])
    s0, s1 = (dataclasses.replace(cfg, shard_index=i, shard_count=2) for i in (0, 1))
    assert not np.array_equal(TD.SyntheticTokens(s0).batch_at(0)["tokens"],
                              TD.SyntheticTokens(s1).batch_at(0)["tokens"])


def _axes_tree(tree):
    """A tree of axes tuples as nested dicts / lists with tuple leaves."""
    if isinstance(tree, dict):
        return {k: _axes_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_axes_tree(v) for v in tree]
    return tuple(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_jax(arch):
    cfg = jget_reduced(arch)
    ptree = jax.eval_shape(lambda key: JLM.init_params(key, cfg), jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(lambda p: p.axes, ptree, is_leaf=JP.is_param)
    got = TLM.param_axes(get_reduced(arch))
    assert _axes_tree(got) == _axes_tree(want)
    # and the port's init has a leaf of that rank at every axes leaf
    params = TLM.init_params(torch.Generator().manual_seed(0), get_reduced(arch))
    for p, ax in zip(adamw.leaves(params), _ax_leaves(got), strict=True):
        assert p.dim() == len(ax)


def _ax_leaves(tree):
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _ax_leaves(tree[k])]
    if isinstance(tree, list):
        return [a for v in tree for a in _ax_leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_identical_loss_and_gradients(arch):
    cfg = get_reduced(arch, dtype="float32")
    params = TLM.init_params(torch.Generator().manual_seed(1), cfg)
    batch = {k: torch.from_numpy(v) for k, v in inputs(cfg, seed=4).items()}
    on = loss_and_grads(params, batch, dataclasses.replace(cfg, remat=True))
    off = loss_and_grads(params, batch, dataclasses.replace(cfg, remat=False))
    assert torch.equal(on[0], off[0])
    for k in ("ce", "aux"):
        assert torch.equal(on[1][k], off[1][k])
    for g_on, g_off in zip(adamw.leaves(on[2]), adamw.leaves(off[2])):
        assert torch.equal(g_on, g_off)


def test_launcher_on_the_cpu_as_a_process(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "rwkv6-1.6b",
         "--reduced", "--steps", "3", "--batch", "2", "--seq", "32", "--ckpt-every", "2",
         "--grad-compression", "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert [ln.split()[:2] for ln in lines[:3]] == [["step", str(i)] for i in range(3)]
    assert all(" loss " in ln and ln.endswith(" ms)") for ln in lines[:3])
    assert lines[-1] == "done"
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [2, 3]


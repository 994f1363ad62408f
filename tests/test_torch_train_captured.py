"""The training step's runners (``repro_torch.train.runner``) on the CPU.

JAX jits its train step; the port replays it as one CUDA graph on the card
(``CapturedStep``) and runs it op by op on the CPU and on gloo ranks
(``EagerStep``).  A CUDA graph cannot be captured here, so the captured
runner runs with a stand-in graph (``_stand_in_graphs``): the capture runs
the step's body once and a replay runs it again, its outputs copied into the
first ones, as a replay refills the graph's own tensors.  The runner's own
logic (the warm step as step ``start``, the batch copied into the captured
buffers, the new step count and error buffer copied into the state, a
restore copied into the same tensors and the graph kept) is what runs.

  * the rule: the card without collectives or on NCCL captures; the CPU and
    gloo run eagerly (``captures``, ``runner``, ``train.loop.make_runner``);
  * ``load`` copies a checkpoint into the live tree (the same ``data_ptr``s,
    bit for bit the checkpoint) and ``zero`` zeroes in place, also on
    DTensors of a 2-rank gloo world (each rank's local block); after a
    failure every rank restores the step rank 0 wrote, even where its
    files land late;
  * ``train()`` through either runner gives JAX's ``train()`` history on
    the same numpy batches, with a failure injected at step 7 and the
    restore from step 5, compression off and on (``HISTORY_RTOL`` of
    ``tests/test_torch_train.py``: 1e-5, 2e-3 with compression), with one
    capture for the whole run; before any checkpoint the optimizer starts
    again in place;
  * the GIN example's step through either runner gives JAX's
    ``examples/train_gin_molhiv.py`` step (losses and accuracies rtol 1e-5,
    the parameters after 3 steps rtol 1e-4 / atol 1e-6, as
    ``tests/test_torch_gnn_grad.py``) from JAX's weights (``from_jax_params``);
  * the launcher prints JAX's lines through the captured runner.
"""
import contextlib
import importlib.util
import json
import sys
import tempfile
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import params as JP
from repro.core import graph as JG
from repro.data import pipeline as JD
from repro.gnn import models as JM
from repro.models import lm as JLM
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import adamw as JA
from repro.train.loop import LoopConfig as JLoopConfig
from repro.train.loop import train as jtrain
from repro_torch import runtime as RT
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.gengnn_models import get_gnn_config
from repro_torch.convert import from_jax_lm_params, from_jax_params, to_numpy
from repro_torch.models import lm as TLM
from repro_torch.optim import adamw
from repro_torch.train import loop as TL
from repro_torch.train import runner as R
from repro_torch.train.loop import LoopConfig, train

from test_torch_distributed import WORLD_PREAMBLE, run_world
from test_torch_train import HISTORY_RTOL, TINY, TINY_KW, _BlockingJaxManager, _data

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
GIN_SMALL = dict(num_layers=2, hidden=16)
GIN_BATCH = 4


class _StandInGraph:
    """A captured step on the CPU: the capture runs the body once for its
    outputs and puts ``state`` back as it was (a capture runs nothing);
    ``replay`` runs the body again and copies its outputs into those of
    the capture."""

    def __init__(self, body, state):
        self.body = body
        before = [t.clone() for t in R._flat(state)]
        self.out = body()
        for t, b in zip(R._flat(state), before):
            t.copy_(b)

    def replay(self):
        new = self.body()
        for dst, src in zip(R._flat(self.out), R._flat(new)):
            dst.copy_(src)


def _stand_in_graphs(monkeypatch):
    """Every runner is the captured one, with stand-in graphs."""
    monkeypatch.setattr(R, "captures", lambda device, backend="none": True)
    monkeypatch.setattr(R, "_side_stream", contextlib.nullcontext)

    def capture(body, state):
        g = _StandInGraph(body, state)
        return g, g.out

    monkeypatch.setattr(R, "_capture", capture)


@pytest.mark.parametrize("device,backend,want", [
    ("cpu", "none", False), ("cpu", "gloo", False), ("cpu", "nccl", False),
    ("cuda", "none", True), ("cuda", "nccl", True), ("cuda", "gloo", False)])
def test_the_rule_captures_on_the_card_without_gloo(device, backend, want):
    assert R.captures(device, backend) is want
    assert R.captures(torch.device(device), backend) is want


@pytest.mark.parametrize("device,backend,kind", [
    ("cpu", None, R.EagerStep), ("cpu", "gloo", R.EagerStep),
    ("cuda", None, R.CapturedStep), ("cuda", "none", R.CapturedStep),
    ("cuda", "nccl", R.CapturedStep), ("cuda", "gloo", R.EagerStep)])
def test_runner_and_make_runner_follow_the_rule(device, backend, kind):
    """A mesh stand-in names its backend ("none": a 1-rank mesh without a
    process group); building a runner touches no card."""
    mesh = None if backend is None else types.SimpleNamespace(backend=backend)
    state = {"w": torch.zeros(3)}
    assert type(R.runner(lambda s, b: (s, {}), state, device, mesh)) is kind
    run = TL.make_runner(lambda *a: a, {"w": torch.zeros(3)}, {"step": torch.zeros(())},
                         None, device, mesh)
    assert type(run) is kind and set(run.state) == {"params", "opt", "ef"}


def test_a_one_rank_mesh_without_a_process_group_counts_as_no_mesh():
    mesh = RT.make_debug_mesh(1, 1, device="cpu")
    assert mesh.backend == "none"
    assert type(R.runner(lambda s, b: (s, {}), {}, "cuda", mesh)) is R.CapturedStep
    assert type(R.runner(lambda s, b: (s, {}), {}, "cpu", mesh)) is R.EagerStep


def _tiny_state():
    params = TLM.init_params(torch.Generator().manual_seed(0), TINY)
    return params, adamw.init(params)


def test_load_copies_a_checkpoint_into_the_live_tree(tmp_path):
    params, opt = _tiny_state()
    step_fn = TL.make_train_step(TINY, adamw.AdamWConfig(lr=1e-2, warmup_steps=1,
                                                         total_steps=4))
    run = TL.make_runner(step_fn, params, opt, None, "cpu")
    batches = iter(_data())
    for _ in range(2):
        run(TL.device_batch(next(batches), "cpu"))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"params": run.state["params"], "opt": run.state["opt"]}, blocking=True)
    saved = [t.clone() for t in adamw.leaves({"p": run.state["params"],
                                              "o": run.state["opt"]})]
    run(TL.device_batch(next(batches), "cpu"))  # moves every leaf on
    live = adamw.leaves({"p": run.state["params"], "o": run.state["opt"]})
    ptrs = [t.data_ptr() for t in live]
    assert not all(torch.equal(a, b) for a, b in zip(saved, live))
    step, params2, opt2 = TL._restore(mgr, run.state["params"], run.state["opt"],
                                      TLM.param_axes(TINY), None, None)
    run.load({"params": params2, "opt": opt2})
    live = adamw.leaves({"p": run.state["params"], "o": run.state["opt"]})
    assert step == 2 and [t.data_ptr() for t in live] == ptrs
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(live, saved))
    assert int(run.state["opt"]["step"]) == 2
    run.zero("opt", "ef")
    assert all(not t.any() for t in adamw.leaves(run.state["opt"]))
    assert [t.data_ptr() for t in adamw.leaves({"p": run.state["params"],
                                                "o": run.state["opt"]})] == ptrs


def test_load_refuses_another_shape_or_dtype():
    run = R.EagerStep(lambda s, b: (s, {}), {"w": torch.zeros(3), "v": [torch.zeros(2)]})
    with pytest.raises(ValueError, match="cannot copy"):
        run.load({"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="cannot copy"):
        run.load({"w": torch.zeros(3, dtype=torch.int32)})
    with pytest.raises(ValueError, match="leaves"):
        run.load({"v": [torch.zeros(2), torch.zeros(2)]})


_DTENSOR_LOAD = WORLD_PREAMBLE + r"""
import json
from torch.distributed.tensor import DTensor
from repro_torch import runtime as RT
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train import loop as TL

cfg = ModelConfig(**json.loads(sys.argv[4])).validate()
mesh = RT.make_debug_mesh(1, world, device="cpu")
rules = RT.batch_rules(mesh, 4)
paxes = lm.param_axes(cfg)
params = RT.place_tree(lm.init_params(torch.Generator().manual_seed(0), cfg), paxes,
                       mesh, rules)
opt = adamw.init(params)
run = TL.make_runner(TL.make_train_step(cfg, adamw.AdamWConfig()), params, opt, None,
                     "cpu", mesh)
for t in adamw.leaves(run.state["opt"]["m"]):
    (t.to_local() if isinstance(t, DTensor) else t).normal_()
mgr = CheckpointManager(sys.argv[5])
mgr.save(3, {"params": run.state["params"], "opt": run.state["opt"]},
         axes_tree={"params": paxes, "opt": None}, blocking=True)
dist.barrier()
live = adamw.leaves({"p": run.state["params"], "o": run.state["opt"]})
whole = [t.full_tensor() if isinstance(t, DTensor) else t.clone() for t in live]
local = lambda t: t.to_local() if isinstance(t, DTensor) else t
for t in live:  # the live tree moves on
    local(t).add_(1)
ptrs = [local(t).data_ptr() for t in live]
placements = [getattr(t, "placements", None) for t in live]
step, p2, o2 = TL._restore(mgr, run.state["params"], run.state["opt"], paxes, mesh, rules)
run.load({"params": p2, "opt": o2})
live = adamw.leaves({"p": run.state["params"], "o": run.state["opt"]})
back = [t.full_tensor() if isinstance(t, DTensor) else t for t in live]
run.zero("opt")
print(json.dumps({
    "step": step, "dtensors": sum(isinstance(t, DTensor) for t in live),
    "cut": sum(isinstance(t, DTensor) and local(t).numel() < t.numel() for t in live),
    "ptrs": [local(t).data_ptr() for t in live] == ptrs,
    "placements": [getattr(t, "placements", None) for t in live] == placements,
    "equal": all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(back, whole)),
    "zeroed": all(not local(t).any() for t in adamw.leaves(run.state["opt"])),
    "eager": type(run).__name__}))
"""


def test_load_on_dtensors_of_a_gloo_world(tmp_path):
    """Each rank's local blocks take the checkpoint in place (placements
    kept); a gloo mesh takes the eager runner."""
    outs = run_world(_DTENSOR_LOAD, 2, tmp_path,
                     args=(json.dumps(TINY_KW), str(tmp_path / "ckpt")))
    for out in outs:
        res = json.loads(out.strip().splitlines()[-1])
        assert res["step"] == 3 and res["dtensors"] > 0 and res["cut"] > 0, res
        assert res["ptrs"] and res["placements"] and res["equal"] and res["zeroed"], res
        assert res["eager"] == "EagerStep", res


_SLOW_SAVE = WORLD_PREAMBLE + r"""
import json, os, time
from repro_torch import runtime as RT
from repro_torch.data.pipeline import SyntheticTokens, TokenPipelineConfig
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, train

if rank == 0:  # rank 0's checkpoint lands late: its writer sleeps before the rename
    rename = os.rename
    os.rename = lambda a, b: (time.sleep(3.0), rename(a, b))[1]
cfg = ModelConfig(**json.loads(sys.argv[4])).validate()
mesh = RT.make_debug_mesh(1, world, device="cpu")
out = train(cfg, adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4),
            LoopConfig(steps=4, log_every=1, ckpt_every=2, ckpt_dir=sys.argv[5]),
            SyntheticTokens(TokenPipelineConfig(vocab_size=64, batch=4, seq_len=16)),
            mesh=mesh, rules=RT.batch_rules(mesh, 4), inject_failure_at=3, device="cpu")
print(json.dumps([[h["step"], h["loss"]] for h in out["history"]]))
"""


def test_every_rank_restores_the_step_rank_0_wrote(tmp_path):
    """On a 2-rank gloo world, rank 0's checkpoint of step 2 is renamed
    into place 3 s late, after the failure at step 3: rank 1, which does
    not write, restores the step rank 0 saw after its wait (not an older
    one, nor a fresh optimizer), so both ranks run the same steps and
    their collectives meet."""
    outs = run_world(_SLOW_SAVE, 2, tmp_path,
                     args=(json.dumps(TINY_KW), str(tmp_path / "ckpt")))
    hist = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [h[0] for h in hist[0]] == [h[0] for h in hist[1]] == [1, 2, 3, 3, 4], hist
    assert hist[0] == hist[1]


def _jax_train(compression: bool, opt: dict, loop: dict, monkeypatch):
    monkeypatch.setattr(sys.modules["repro.train.loop"], "CheckpointManager",
                        _BlockingJaxManager)
    jcfg = JModelConfig(**TINY_KW).validate()
    with tempfile.TemporaryDirectory() as d:
        return jtrain(jcfg, JA.AdamWConfig(**opt), JLoopConfig(ckpt_dir=d, **loop),
                      JD.SyntheticTokens(JD.TokenPipelineConfig(64, 4, 16)),
                      params=JLM.init_params(jax.random.PRNGKey(0), jcfg),
                      inject_failure_at=7)


def _port_train(opt: dict, loop: dict) -> tuple:
    jparams = JP.values(JLM.init_params(jax.random.PRNGKey(0), JModelConfig(**TINY_KW)))
    tparams = from_jax_lm_params(jax.tree_util.tree_map(np.asarray, jparams))
    ptrs = [t.data_ptr() for t in adamw.leaves(tparams)]
    before = (R.capture_count, R.replay_count)
    with tempfile.TemporaryDirectory() as d:
        got = train(TINY, adamw.AdamWConfig(**opt), LoopConfig(ckpt_dir=d, **loop), _data(),
                    params=tparams, inject_failure_at=7, device="cpu")
    counts = (R.capture_count - before[0], R.replay_count - before[1])
    return got, counts, [t.data_ptr() for t in adamw.leaves(got["params"])] == ptrs


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])
@pytest.mark.parametrize("compression", [False, True])
def test_train_through_the_runner_matches_jax(compression, captured, monkeypatch):
    """10 steps on TINY from JAX's init, a checkpoint at step 5, a failure
    at step 7 restored from step 5 (as ``test_torch_train.py``'s
    ``test_train_history_matches_jax``, whose tolerance this keeps).  The
    captured runner captures once (the restore copies into its state) and
    replays every step after its warm one; the parameters returned are
    the tensors it started with."""
    if captured:
        _stand_in_graphs(monkeypatch)
    opt = dict(lr=1e-2, warmup_steps=3, total_steps=10)
    loop = dict(steps=10, log_every=1, ckpt_every=5, grad_compression=compression)
    want = _jax_train(compression, opt, loop, monkeypatch)
    got, (caps, reps), same_tensors = _port_train(opt, loop)
    steps = [h["step"] for h in got["history"]]
    assert steps == [h["step"] for h in want["history"]] == [1, 2, 3, 4, 5, 6, 7, 6, 7, 8,
                                                             9, 10]
    failures = lambda out: [e["step"] for e in out["events"] if e["event"] == "failure"]
    assert failures(got) == failures(want) == [7]
    for g, w in zip(got["history"], want["history"]):
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=HISTORY_RTOL[compression], err_msg=k)
    assert same_tensors
    assert (caps, reps) == ((1, len(steps) - 1) if captured else (0, 0))


def test_failure_before_a_checkpoint_restarts_the_optimizer_in_place(monkeypatch):
    """No checkpoint yet: the moments and the step count are zeroed in the
    captured state (the graph kept) and step 0 runs again, the parameters
    kept, as ``test_torch_train.py``'s eager case."""
    _stand_in_graphs(monkeypatch)
    before = R.capture_count
    with tempfile.TemporaryDirectory() as d:
        out = train(TINY, adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6),
                    LoopConfig(steps=6, log_every=1, ckpt_every=100, ckpt_dir=d),
                    _data(), inject_failure_at=3, device="cpu")
    assert [h["step"] for h in out["history"]] == [1, 2, 3, 1, 2, 3, 4, 5, 6]
    assert int(out["opt_state"]["step"]) == 6 and R.capture_count - before == 1


def test_a_graph_that_fails_raises_and_is_not_retried(monkeypatch):
    """A capture that fails is no node failure: ``train()`` raises
    ``StepGraphError`` at once (no failure event, no retry, no eager step)."""
    monkeypatch.setattr(R, "captures", lambda device, backend="none": True)
    monkeypatch.setattr(R, "_side_stream", contextlib.nullcontext)

    def capture(body, state):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(R, "_capture", capture)
    calls = []
    real = TL.make_train_step

    def counted(*a, **k):
        step = real(*a, **k)
        return lambda *x: calls.append(1) or step(*x)

    monkeypatch.setattr(TL, "make_train_step", counted)
    with tempfile.TemporaryDirectory() as d, pytest.raises(R.StepGraphError,
                                                           match="could not be captured"):
        train(TINY, adamw.AdamWConfig(), LoopConfig(steps=4, ckpt_dir=d, max_retries=3),
              _data(), device="cpu")
    assert calls == [1]  # the warm step, nothing after the capture failed


def _gin_example():
    spec = importlib.util.spec_from_file_location(
        "torch_train_gin_molhiv", ROOT / "examples" / "torch_train_gin_molhiv.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("captured", [False, True], ids=["eager", "captured"])
def test_gin_example_step_through_the_runner_matches_jax(captured, monkeypatch):
    """Three steps of the example's ``train_step`` through a runner against
    JAX's example step (``examples/train_gin_molhiv.py:46-51``, loss,
    AdamW, the accuracy on the updated weights) on JAX's weights: losses
    and accuracies at rtol 1e-5, every parameter after the steps at rtol
    1e-4 / atol 1e-6."""
    if captured:
        _stand_in_graphs(monkeypatch)
    ex = _gin_example()
    jcfg = JM.paper_config("gin", **GIN_SMALL)
    jp = jax.tree_util.tree_map(np.asarray, JM.init(jax.random.PRNGKey(1), jcfg))
    for lp in jp["layers"]:  # a non-zero eps, so its gradient matters
        lp["eps"] = lp["eps"] + np.float32(0.25)
    tp = from_jax_params(jp)
    kw = dict(lr=3e-4, warmup_steps=20, total_steps=3, weight_decay=0.01)
    jopt_cfg = JA.AdamWConfig(**kw)

    def jloss(p, g, y):
        logits = JM.apply(p, g, jcfg)[: y.shape[0], 0]
        return jnp.mean(jnp.maximum(logits, 0) - logits * y
                        + jnp.log1p(jnp.exp(-jnp.abs(logits))))

    @jax.jit
    def jstep(p, o, g, y):
        loss, grads = jax.value_and_grad(jloss)(p, g, y)
        p, o, _ = JA.update(jopt_cfg, grads, o, p)
        acc = jnp.mean((JM.apply(p, g, jcfg)[: y.shape[0], 0] > 0) == (y > 0.5))
        return p, o, loss, acc

    run = R.runner(ex.train_step(adamw.AdamWConfig(**kw), get_gnn_config("gin", **GIN_SMALL)),
                   {"params": tp, "opt": adamw.init(tp)}, "cpu")
    assert type(run) is (R.CapturedStep if captured else R.EagerStep)
    jopt = JA.init(jp)
    stream = JD.MoleculeStream(JD.MOLHIV, seed=0)
    rng = np.random.default_rng(0)
    for step in range(3):
        tg, ty = ex.make_batch(stream, rng, step, batch=GIN_BATCH)
        raw = [stream.graph_at(step * GIN_BATCH + i) for i in range(GIN_BATCH)]
        jg = JG.batch_graphs([r[:4] for r in raw], GIN_BATCH * 64, GIN_BATCH * 192)
        jp, jopt, jl, ja = jstep(jp, jopt, jg, jnp.asarray([r[4] for r in raw]))
        tl, ta = run((tg, ty))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5, err_msg=f"step {step}")
    assert int(run.state["opt"]["step"]) == 3
    for a, b in zip(adamw.leaves(to_numpy(run.state["params"])),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)


def test_gin_example_main_captured_gives_the_eager_run(monkeypatch, tmp_path, capsys):
    """``main`` through the captured runner prints the eager run's lines and
    returns its losses, accuracies and parameters bit for bit (the same
    operations); one capture, a replay each later step."""
    ex = _gin_example()
    eager = ex.main(["4", "--device", "cpu", "--ckpt-dir", str(tmp_path / "a")])
    lines = capsys.readouterr().out.splitlines()[:-1]
    _stand_in_graphs(monkeypatch)
    before = (R.capture_count, R.replay_count)
    got = ex.main(["4", "--device", "cpu", "--ckpt-dir", str(tmp_path / "b")])
    assert capsys.readouterr().out.splitlines()[:-1] == lines
    assert (R.capture_count - before[0], R.replay_count - before[1]) == (1, 3)
    assert got["losses"] == eager["losses"] and got["accs"] == eager["accs"]
    assert all(torch.equal(a, b) for a, b in zip(adamw.leaves(got["params"]),
                                                 adamw.leaves(eager["params"])))


@pytest.mark.parametrize("compression", [False, True])
def test_launcher_through_the_captured_runner(compression, monkeypatch, tmp_path, capsys):
    """The launcher's lines (JAX's, and no other) through the captured
    runner: step 0 the warm step, then a replay a step, the losses those
    of the eager launcher."""
    from repro_torch.launch import train as LT

    argv = ["--arch", "chatglm3-6b", "--reduced", "--steps", "3", "--batch", "2", "--seq",
            "16", "--device", "cpu"] + (["--grad-compression"] if compression else [])
    LT.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    eager = capsys.readouterr().out.splitlines()
    _stand_in_graphs(monkeypatch)
    before = (R.capture_count, R.replay_count)
    LT.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    got = capsys.readouterr().out.splitlines()
    assert (R.capture_count - before[0], R.replay_count - before[1]) == (1, 2)
    strip = lambda lines: [ln.rsplit(" (", 1)[0] for ln in lines]  # the ms differ
    assert strip(got) == strip(eager) and len(got) == 4 and got[-1] == "done", got

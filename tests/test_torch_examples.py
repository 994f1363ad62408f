"""The port's four example scripts (``examples/torch_*.py``) on the CPU.

  * each script's ``main`` runs in a child process with ``--device cpu`` at
    a few graphs or steps (the quickstart at its 8, the DGN script on a
    2,000-node graph), exits 0,
    prints what its JAX counterpart prints and no NaN;
  * without ``--device cpu`` and without a card each exits 1 with a
    message (no silent fallback);
  * the training script's loss falls over 20 steps (the mean of the last 5
    below the mean of the first 5), and its checkpoint restores to the tree
    it saved, leaf for leaf;
  * its step runs the kernel branch of ``kernels/ops.py`` under grad when
    the kernels are forced (stand-ins, ``tests/torch_kernel_standins.py``):
    every ``node_mlp`` of the forward in ``ops.KernelFunction``, the losses
    those of the plain path to 1e-6;
  * no script imports anything but ``repro_torch``, ``torch``, ``numpy``
    and the standard library (never ``jax`` or ``repro``).
"""
import ast
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_kernel_standins import forced_kernels

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
SCRIPTS = {
    "quickstart": [],
    "serve_realtime_stream": ["8"],
    "large_graph_dgn": ["--nodes", "2000", "--edges", "9000", "--feat", "50"],
    "train_gin_molhiv": ["4"],
}
EXPECT = {
    "quickstart": ["gcn     -> 8 graphs", "gin_vn  -> 8 graphs", "dgn     -> 8 graphs"],
    "serve_realtime_stream": ["streamed 8 graphs", "latency us:", "batched mode:"],
    "large_graph_dgn": ["PubMed-sized DGN: 2000 nodes", "output (2048, 3), NaNs: False"],
    "train_gin_molhiv": ["step    0  bce", "step    3  bce", "final checkpoint at:"],
}


def _env():
    return dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}",
                OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")


def _run(argv, timeout=300):
    return subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                          env=_env(), cwd=str(ROOT), timeout=timeout)


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_example_runs_on_cpu(tmp_path, name):
    extra = ["--ckpt-dir", str(tmp_path / "ckpt")] if name == "train_gin_molhiv" else []
    r = _run([str(EXAMPLES / f"torch_{name}.py"), *SCRIPTS[name], "--device", "cpu", *extra])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    for line in EXPECT[name]:
        assert line in r.stdout, (line, r.stdout)
    assert not re.search(r"\bnan\b", r.stdout, re.I), r.stdout


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_example_refuses_without_a_card(name):
    r = _run([str(EXAMPLES / f"torch_{name}.py"), *SCRIPTS[name]])
    assert r.returncode == 1 and r.stdout == "", (r.returncode, r.stdout)
    assert "CUDA is not available" in r.stderr and "--device cpu" in r.stderr, r.stderr


_TRAIN = r"""
import json, sys, importlib.util
import torch
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.optim import adamw

spec = importlib.util.spec_from_file_location("ex", sys.argv[1])
ex = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ex)
out = ex.main(["20", "--device", "cpu", "--ckpt-dir", sys.argv[2]])
step, tree = CheckpointManager(sys.argv[2]).restore(template={"params": out["params"]})
saved, back = adamw.leaves(out["params"]), adamw.leaves(tree["params"])
print(json.dumps({"losses": out["losses"], "step": step, "leaves": len(saved),
                  "same": all(a.dtype == b.dtype and torch.equal(a, b)
                              for a, b in zip(saved, back))}))
"""


def test_train_loss_falls_and_checkpoint_restores(tmp_path):
    r = _run(["-c", _TRAIN, str(EXAMPLES / "torch_train_gin_molhiv.py"),
              str(tmp_path / "ckpt")])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    losses = res["losses"]
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert res["step"] == 19 and res["leaves"] == 39 and res["same"], res


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_step_runs_the_kernel_branch_under_grad(monkeypatch, tmp_path, capsys):
    torch.set_num_threads(2)
    ex = _example("torch_train_gin_molhiv")
    plain = ex.main(["3", "--device", "cpu", "--ckpt-dir", str(tmp_path / "a")])["losses"]
    calls = forced_kernels(monkeypatch)
    nonzero = []
    real_update = ex.adamw.update

    def update(cfg, grads, state, params):  # every leaf got a gradient
        nonzero.append(sum(int(bool(torch.any(g != 0))) for g in ex.adamw.leaves(grads)))
        return real_update(cfg, grads, state, params)

    monkeypatch.setattr(ex.adamw, "update", update)
    forced = ex.main(["3", "--device", "cpu", "--ckpt-dir", str(tmp_path / "b")])["losses"]
    np.testing.assert_allclose(forced, plain, rtol=1e-6)
    # GIN: encoder + 5 x (edge, 2 MLP) + head = 17 node_mlp a forward; a step
    # runs the forward under grad and again for the accuracy
    assert calls["node_mlp"] == 3 * 2 * 17 and set(calls) == {"node_mlp"}, dict(calls)
    assert nonzero == [39, 39, 39]
    capsys.readouterr()


def test_node_mlp_outputs_of_the_train_forward_have_the_function(monkeypatch):
    forced_kernels(monkeypatch)
    ex = _example("torch_train_gin_molhiv")
    from repro_torch.configs.gengnn_models import get_gnn_config
    from repro_torch.data.pipeline import MOLHIV, MoleculeStream
    from repro_torch.gnn import init
    from repro_torch.kernels import ops as kops

    cfg = get_gnn_config("gin")
    params = init(torch.Generator().manual_seed(0), cfg)
    g, y = ex.make_batch(MoleculeStream(MOLHIV, seed=0), None, 0)
    outs = []
    real = kops.node_mlp

    def spy(*a, **k):
        outs.append(real(*a, **k))
        return outs[-1]

    monkeypatch.setattr(kops, "node_mlp", spy)
    for p in ex.adamw.leaves(params):
        p.requires_grad_(True)
    ex.loss_fn(params, g, y, cfg).backward()
    assert len(outs) == 17
    assert all(type(o.grad_fn).__name__ == "KernelFunctionBackward" for o in outs)
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in ex.adamw.leaves(params))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_examples_import_only_the_port_torch_and_numpy():
    files = sorted(EXAMPLES.glob("torch_*.py"))
    assert [f.stem for f in files] == sorted(f"torch_{n}" for n in SCRIPTS)
    allowed = {"repro_torch", "torch", "numpy"} | set(sys.stdlib_module_names)
    bad = [f"{f.name}: {m}" for f in files for m in _imports(f)
           if m.split(".")[0] not in allowed or m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad

"""Train GIN end to end on the PyTorch port (the counterpart of
``examples/train_gin_molhiv.py``): a synthetic MolHIV-statistics stream,
binary graph classification, BCE loss, AdamW, checkpoints.  On the card
every linear and message-passing layer of the forward runs its
hand-written kernel, with the plain version's gradient
(``kernels/ops.py:KernelFunction``), and the step (forward, gradient,
AdamW, the accuracy's forward) runs as one CUDA graph, as JAX jits it
(``repro_torch.train.runner``: step 0 eager and the capture, replays from
step 1); on the CPU it runs op by op.

  PYTHONPATH=src python examples/torch_train_gin_molhiv.py [steps]
  PYTHONPATH=src python examples/torch_train_gin_molhiv.py 20 --device cpu
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.gengnn_models import get_gnn_config
from repro_torch.core.graph import batch_graphs
from repro_torch.data.pipeline import MOLHIV, MoleculeStream
from repro_torch.device import device_or_exit
from repro_torch.gnn import apply, init
from repro_torch.optim import adamw
from repro_torch.train.runner import runner


def make_batch(stream, rng, step, batch=16, device="cpu"):
    gs, labels = [], []
    for i in range(batch):
        s, r, nf, ef, y = stream.graph_at(step * batch + i)
        gs.append((s, r, nf, ef))
        labels.append(y)
    g = batch_graphs(gs, n_pad=batch * 64, e_pad=batch * 192, device=device)
    return g, torch.tensor(np.asarray(labels, np.float32), device=device)


def bce_with_logits(logits, y):
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def loss_fn(params, g, y, cfg):
    return bce_with_logits(apply(params, g, cfg)[: y.shape[0], 0], y)


def step_fn(params, opt, opt_cfg, cfg, g, y):
    """One AdamW step -> (params, opt, loss, accuracy on the updated params),
    as JAX's ``step_fn`` (the parameters and moments are updated in place,
    the step count is a new tensor)."""
    flat = adamw.leaves(params)
    for p in flat:  # the leaves require grad only within the step
        p.requires_grad_(True)
    try:
        loss = loss_fn(params, g, y, cfg)
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    finally:
        for p in flat:
            p.requires_grad_(False)
    it = iter(grads)
    params, opt, _ = adamw.update(opt_cfg, adamw.tree_map(lambda _: next(it), params),
                                  opt, params)
    with torch.no_grad():
        acc = torch.mean(((apply(params, g, cfg)[: y.shape[0], 0] > 0) == (y > 0.5)).float())
    return params, opt, loss.detach(), acc


def train_step(opt_cfg, cfg):
    """:func:`step_fn` as a runner's step (``repro_torch.train.runner``):
    state {"params", "opt"} and batch (graph, labels) -> (new state,
    (loss, accuracy))."""

    def fn(state, batch):
        params, opt, loss, acc = step_fn(state["params"], state["opt"], opt_cfg, cfg, *batch)
        return {"params": params, "opt": opt}, (loss, acc)

    return fn


def main(argv=None, on_step=None):
    """Trains and returns {"losses", "accs", "params", "ckpt_dir"};
    ``on_step(step, seconds)`` (optional) is called after each step with its
    seconds (CUDA events on the card around the call: from step 1 a
    replay with its input copies; the host clock on the CPU)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", type=int, nargs="?", default=200)
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain PyTorch path")
    ap.add_argument("--ckpt-dir", default=None, help="default: a new temporary directory")
    args = ap.parse_args(argv)
    device = device_or_exit(args.device, "torch_train_gin_molhiv")
    steps = args.steps
    cfg = get_gnn_config("gin")
    params = init(torch.Generator().manual_seed(0), cfg, device)
    stream = MoleculeStream(MOLHIV, seed=0)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps,
                                weight_decay=0.01)
    run = runner(train_step(opt_cfg, cfg), {"params": params, "opt": adamw.init(params)},
                 device)

    cuda = device.type == "cuda"
    rng = np.random.default_rng(0)
    ckpt = CheckpointManager(args.ckpt_dir or tempfile.mkdtemp(prefix="gin_ckpt_"), keep=2)
    losses, accs = [], []
    try:
        for step in range(steps):
            g, y = make_batch(stream, rng, step, device=device)
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            else:
                t0 = time.perf_counter()
            loss, acc = run((g, y))
            if cuda:
                end.record()
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
            else:
                seconds = time.perf_counter() - t0
            losses.append(float(loss))
            accs.append(float(acc))
            if on_step is not None:
                on_step(step, seconds)
            if step % max(steps // 10, 1) == 0 or step == steps - 1:
                print(f"step {step:4d}  bce {losses[-1]:.4f}  acc {accs[-1]:.2f}", flush=True)
            if step == steps - 1:
                ckpt.save(step, {"params": run.state["params"]}, blocking=True)
    finally:
        run.close()
    print("final checkpoint at:", ckpt.dir)
    return {"losses": losses, "accs": accs, "params": run.state["params"],
            "ckpt_dir": ckpt.dir}


if __name__ == "__main__":
    main()

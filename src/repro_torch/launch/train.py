"""Training launcher of the LM substrate (port of ``repro.launch.train``).

Runs ``train.loop.make_train_step`` for ``--steps`` steps on one device
over ``SyntheticTokens`` batches, with AdamW (warmup a tenth of the steps,
cosine decay to the end), optional int8 error-feedback gradient
compression, and an async checkpoint every ``--ckpt-every`` steps and at
the end.  Parameters are random (``lm.init_params`` from a generator
seeded 0).  Prints JAX's lines, ``step N loss L (T ms)`` ten times over
the run and at its last step, then ``done``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
      --reduced --steps 20 --batch 4 --seq 64 --device cpu

Runs on the card unless ``--device cpu`` is given.  Not taken yet:
``--debug-mesh`` and ``--rules``.  The mesh substrate exists
(``repro_torch.runtime``, which the GNN serving path takes); the train
loop's mesh branch is ROADMAP queue 1, item 11, part 2.
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.data.pipeline import SyntheticTokens, TokenPipelineConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp
from repro_torch.train.loop import device_batch, make_train_step

_MESH_FLAGS = ("--debug-mesh", "--rules")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain PyTorch path)")
    for flag in _MESH_FLAGS:
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag in _MESH_FLAGS:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag} is not taken: the train loop's mesh branch is "
                     f"multi-device work (ROADMAP queue 1, item 11, part 2)")

    device = resolve_device(args.device)
    cfg = (get_reduced if args.reduced else get_config)(args.arch)
    data = SyntheticTokens(
        TokenPipelineConfig(vocab_size=cfg.vocab_size, batch=args.batch, seq_len=args.seq)
    )
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                                total_steps=args.steps)
    params = lm.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    paxes = lm.param_axes(cfg)
    opt_state = adamw.init(params)
    ef = comp.init_error_buf(params) if args.grad_compression else None
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    step_fn = make_train_step(cfg, opt_cfg, args.grad_compression)

    it = iter(data)
    for step in range(args.steps):
        batch = device_batch(next(it), device)
        t0 = time.perf_counter()
        params, opt_state, ef, metrics = step_fn(params, opt_state, ef, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)", flush=True)
        if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
            mgr.save(step + 1, {"params": params, "opt": opt_state},
                     axes_tree={"params": paxes, "opt": None})
    mgr.wait()
    print("done")


if __name__ == "__main__":
    main()

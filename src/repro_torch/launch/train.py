"""Training launcher of the LM substrate (port of ``repro.launch.train``).

Runs ``train.loop.make_train_step`` for ``--steps`` steps over
``SyntheticTokens`` batches, with AdamW (warmup a tenth of the steps,
cosine decay to the end), optional int8 error-feedback gradient
compression, and an async checkpoint every ``--ckpt-every`` steps and at
the end.  Parameters are random (``lm.init_params`` from a generator
seeded 0).  Prints JAX's lines, ``step N loss L (T ms)`` ten times over
the run and at its last step, then ``done``.  The step runs as JAX's
jitted one does, as one program: through ``train.loop.make_runner``, one
CUDA graph on the card (step 0 eager and the capture, as JAX's step 0
compiles; replays from step 1), op by op on the CPU and on gloo ranks.

Mesh, as JAX's launcher: ``--debug-mesh DxM`` trains on a ``("data",
"model")`` mesh of D x M ranks under ``--rules`` (``default``:
``batch_rules``, heads / mlp / vocab / experts on "model"; ``fsdp``:
``fsdp_rules``, the batch on both axes and "embed" on "model").  The
parameters, moments and batches are DTensors placed by those rules and
each step runs in ``train.loop.mesh_scope`` (the flash kernel on each
rank's heads).  The launcher starts the D x M ranks itself
(``launch/ranks.py``: NCCL where every rank has a card of its own, gloo
otherwise, two gloo ranks sharing one card); ``--debug-mesh 1x1`` runs one
rank with no process group.  Rank 0 prints the lines; a rank that fails
fails the launcher; every rank joins a checkpoint and rank 0 writes it.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
      --reduced --steps 20 --batch 4 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \\
      --reduced --steps 3 --batch 4 --seq 32 --debug-mesh 2x2 --rules fsdp \\
      --device cpu

Runs on the card unless ``--device cpu`` is given (then the ranks are
gloo ranks on the CPU).
"""
import argparse
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import runtime as RT
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.data.pipeline import SyntheticTokens, TokenPipelineConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp
from repro_torch.train.loop import device_batch, make_runner, make_train_step, mesh_scope


def _mesh_shape(text: str) -> tuple:
    try:
        d, m = (int(x) for x in text.split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"--debug-mesh takes DxM, not {text!r}") from None
    if d < 1 or m < 1:
        raise argparse.ArgumentTypeError(f"--debug-mesh {text}: sizes must be >= 1")
    return d, m


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
    ap.add_argument("--debug-mesh", type=_mesh_shape, default=None,
                    help="e.g. 2x2 (data x model): the launcher starts D*M ranks")
    ap.add_argument("--rules", default="default", choices=("default", "fsdp"),
                    help="sharding preset of --debug-mesh")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = (get_reduced if args.reduced else get_config)(args.arch)
    mesh = rules = None
    if args.debug_mesh is not None:
        world = args.debug_mesh[0] * args.debug_mesh[1]
        if world > 1 and not dist.is_initialized():
            from repro_torch.launch import ranks

            ranks.spawn(main, world, args.device,
                        sys.argv[1:] if argv is None else list(argv))
            return
        mesh = RT.make_debug_mesh(*args.debug_mesh, device=args.device)
        rules = (RT.fsdp_rules if args.rules == "fsdp" else RT.batch_rules)(mesh, args.batch)

    device = resolve_device(args.device)
    data = SyntheticTokens(
        TokenPipelineConfig(vocab_size=cfg.vocab_size, batch=args.batch, seq_len=args.seq)
    )
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                                total_steps=args.steps)
    params = lm.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    paxes = lm.param_axes(cfg)
    params = RT.place_tree(params, paxes, mesh, rules)
    opt_state = adamw.init(params)
    ef = comp.init_error_buf(params) if args.grad_compression else None
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    run = make_runner(make_train_step(cfg, opt_cfg, args.grad_compression), params,
                      opt_state, ef, device, mesh)

    it = iter(data)
    try:
        with mesh_scope(mesh, rules):
            for step in range(args.steps):
                batch = device_batch(next(it), device, mesh, rules)
                t0 = time.perf_counter()
                loss = float(run(batch)["loss"])
                dt = time.perf_counter() - t0
                if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
                    print(f"step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)", flush=True)
                if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
                    mgr.save(step + 1, {"params": run.state["params"], "opt": run.state["opt"]},
                             axes_tree={"params": paxes, "opt": None})
    finally:
        run.close()  # the graph and its pool go before the ranks' process group
    mgr.wait()
    print("done")


if __name__ == "__main__":
    main()

"""Fault-tolerant training loop (port of ``repro.train.loop``, its mesh-less
branch).

  * restore-latest-and-retry on a step's exception (bounded retries; with
    no checkpoint yet, the optimizer starts again and the parameters stay);
  * async atomic checkpoints every ``ckpt_every`` steps;
  * a step-time watchdog that flags stragglers (> factor x the running
    median);
  * optional int8 error-feedback gradient compression.

The step runs eagerly on the parameters' device: the loss and its
gradients by autograd (``lm.loss_fn``, the attention's forward the flash
kernel on the card), then ``optim.adamw.update`` in place.  JAX's mesh
branch (``runtime.use_mesh``, sharded parameters, elastic restore on
another mesh) is ROADMAP queue 1, item 11, part 2: the substrate
(``repro_torch.runtime``) and the checkpoint manager's elastic restore
exist, the loop does not use them yet.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep: int = 3
    max_retries: int = 3
    straggler_factor: float = 3.0
    grad_compression: bool = False


def loss_and_grads(params, batch: dict, cfg: ModelConfig, kernel_mode: str = "auto"):
    """(loss, {"ce", "aux"}, grads): ``lm.loss_fn`` and the gradient of its
    loss for every leaf of ``params`` (a zero tensor for a leaf the loss
    does not reach, as JAX's ``value_and_grad``).  The leaves require grad
    only within the call."""
    flat = adamw.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, aux = lm.loss_fn(params, batch, cfg, kernel_mode=kernel_mode)
            grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    finally:
        for p in flat:
            p.requires_grad_(False)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            adamw.tree_map(lambda _: next(it), params))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    grad_compression: bool = False) -> Callable:
    """The train step: (params, opt_state, ef, batch) -> (params, opt_state,
    ef, metrics), batch a dict of tensors on the parameters' device and
    metrics {"loss", "ce", "aux", "grad_norm", "lr"} 0-d tensors.  The
    parameters and moments are updated in place."""

    def step(params, opt_state, ef, batch):
        loss, aux, grads = loss_and_grads(params, batch, cfg)
        if grad_compression:
            grads, ef = comp.ef_compress(grads, ef)
        new_params, new_opt, om = adamw.update(opt_cfg, grads, opt_state, params)
        return new_params, new_opt, ef, {"loss": loss, **aux, **om}

    return step


def train(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    loop_cfg: LoopConfig,
    data: Iterable[dict],
    gen: Optional[torch.Generator] = None,
    params: Any = None,
    inject_failure_at: Optional[int] = None,  # test hook
    device="cuda",
) -> dict:
    """The training run on one device.  ``params`` (a tree of tensors,
    used in place) or ``lm.init_params(gen)`` (default: a generator seeded
    0 on ``device``) are the starting weights; ``data`` yields numpy
    batches.
    Returns {"params", "opt_state", "history", "events", "axes"}."""
    device = resolve_device(device)
    if params is None:
        gen = gen if gen is not None else torch.Generator(device).manual_seed(0)
        params = lm.init_params(gen, cfg)
    paxes = lm.param_axes(cfg)
    opt_state = adamw.init(params)
    ef = comp.init_error_buf(params) if loop_cfg.grad_compression else None
    mgr = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep)
    step_fn = make_train_step(cfg, opt_cfg, loop_cfg.grad_compression)

    start = 0
    if mgr.latest_step() is not None:
        start, state = mgr.restore(template={"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]

    params, opt_state, ef, history, events = _run_loop(
        loop_cfg, step_fn, mgr, iter(data), params, opt_state, ef, start, paxes,
        inject_failure_at, device)
    mgr.wait()
    return {"params": params, "opt_state": opt_state, "history": history,
            "events": events, "axes": paxes}


def _run_loop(loop_cfg, step_fn, mgr, it, params, opt_state, ef, step, paxes,
              inject_failure_at, device):
    history, events = [], []
    durations: list = []
    retries = 0
    injected = False
    while step < loop_cfg.steps:
        batch = device_batch(next(it), device)
        t0 = time.perf_counter()
        try:
            if inject_failure_at is not None and step == inject_failure_at and not injected:
                injected = True
                raise RuntimeError("injected node failure")
            params, opt_state, ef, metrics = step_fn(params, opt_state, ef, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
        except Exception as e:  # noqa: BLE001 — any step failure triggers recovery
            retries += 1
            events.append({"step": step, "event": "failure", "error": str(e)})
            if retries > loop_cfg.max_retries:
                raise
            mgr.wait()  # a save in flight lands first: restore the newest
            if mgr.latest_step() is not None:
                step, state = mgr.restore(template={"params": params, "opt": opt_state})
                params, opt_state = state["params"], state["opt"]
            else:  # no checkpoint yet: re-init optimizer, keep params
                opt_state = adamw.init(params)
                step = 0
            ef = comp.init_error_buf(params) if loop_cfg.grad_compression else None
            continue
        dt = time.perf_counter() - t0
        durations.append(dt)
        med = float(np.median(durations[-20:]))
        if len(durations) > 5 and dt > loop_cfg.straggler_factor * med:
            events.append({"step": step, "event": "straggler", "dt": dt, "median": med})
        step += 1
        if step % loop_cfg.log_every == 0 or step == loop_cfg.steps:
            history.append({"step": step, **metrics, "dt": dt})
        if step % loop_cfg.ckpt_every == 0 or step == loop_cfg.steps:
            mgr.save(step, {"params": params, "opt": opt_state},
                     axes_tree={"params": paxes, "opt": None}, blocking=False)
    return params, opt_state, ef, history, events


def device_batch(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}

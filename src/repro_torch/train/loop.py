"""Fault-tolerant training loop (port of ``repro.train.loop``), with and
without a mesh.

  * restore-latest-and-retry on a step's exception (bounded retries; with
    no checkpoint yet, the optimizer starts again and the parameters stay);
  * async atomic checkpoints every ``ckpt_every`` steps;
  * a step-time watchdog that flags stragglers (> factor x the running
    median);
  * optional int8 error-feedback gradient compression.

The step is the loss and its gradients by autograd (``lm.loss_fn``, the
attention's forward the flash kernel on the card), then
``optim.adamw.update`` in place.  JAX jits it; the port runs it through a
runner (``train.runner``): on the card, without a mesh or on an NCCL mesh,
one CUDA graph a step (the first step eager, a real one, then the capture,
replayed from the second on); on the CPU and on gloo ranks, op by op.  The
graph holds the addresses of the parameters, moments, step count and
error buffer, so a restore copies the checkpoint into those tensors and
the graph is kept; a graph that fails raises, and is not retried.

The mesh branch (``train(..., mesh=, rules=)``, JAX's ``use_mesh`` +
``active_rules`` around its jitted step) runs the same step on DTensors,
which stand for GSPMD: the parameters are placed by their logical axes
(``runtime.place_tree``), the moments and the error buffer take their
placements, each global batch is placed by ``partitioning.BATCH_AXES``,
and inside :func:`mesh_scope` the models' ``logical_constraint`` calls
redistribute the activations as JAX's sharding constraints do.  DTensor
propagates every other op; the flash kernel runs on each rank's (batch,
head) block under ``local_map`` (``kernels.ops``), as do the MoE dispatch
and combine (rows) and the Mamba / RWKV-6 recurrences (batch, channels).
The gradients, left partial sums by the backward, are reduced once to
their parameters' placements in a few flat buckets
(``partitioning.reduce_gradients``); AdamW updates each rank's blocks
with the global norm over every shard, and compression
quantizes each block against its tensor's global amax (one all-reduce
each for the norm and the scales); the step calls no ``compressed_psum``,
as JAX's does not.  Checkpoints gather DTensor leaves whole and rank 0
writes them; a restore places what it reads on the mesh, which may have
another shape than the one that saved (elastic).
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
from repro_torch.runtime import partitioning as PT
from repro_torch.runtime.partitioning import mesh_scope
from repro_torch.train import runner as R


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
    only within the call.  DTensor parameters (a mesh's step, within
    :func:`mesh_scope`) get their gradients at their own placements (the
    partial sums reduced in buckets: ``partitioning.reduce_gradients``)
    and plain 0-d metrics."""
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
    it = iter(PT.reduce_gradients(list(grads), flat))
    grads = adamw.tree_map(lambda p: next(it), params)
    return (_whole(loss.detach()), {k: _whole(v.detach()) for k, v in aux.items()}, grads)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A plain tensor of a (replicated) DTensor metric; ``t`` itself when
    plain."""
    return t.full_tensor() if adamw.is_dtensor(t) else t


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


def make_runner(step_fn: Callable, params, opt_state: dict, ef, device, mesh=None):
    """A runner (``train.runner``) of :func:`make_train_step`'s ``step_fn``
    over the state {"params", "opt", "ef"} (``ef`` None without
    compression): captured on the card without a mesh or on NCCL, eager on
    the CPU and on gloo.  A call takes a batch and returns the metrics."""

    def fn(state, batch):
        params, opt, ef, metrics = step_fn(state["params"], state["opt"], state["ef"], batch)
        return {"params": params, "opt": opt, "ef": ef}, metrics

    return R.runner(fn, {"params": params, "opt": opt_state, "ef": ef}, device, mesh)


def train(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    loop_cfg: LoopConfig,
    data: Iterable[dict],
    gen: Optional[torch.Generator] = None,
    params: Any = None,
    mesh: Any = None,
    rules: Optional[dict] = None,
    inject_failure_at: Optional[int] = None,  # test hook
    device="cuda",
) -> dict:
    """The training run.  ``params`` (a tree of tensors, used in place) or
    ``lm.init_params(gen)`` (default: a generator seeded 0 on ``device``)
    are the starting weights, the same on every rank; ``data`` yields
    numpy batches, the same global batch on every rank.

    With ``mesh`` (a ``runtime.Mesh`` over the ranks) the parameters are
    placed as DTensors by their logical axes under ``rules`` (default
    ``DEFAULT_RULES``), the moments and the error buffer follow them, each
    batch is placed by ``partitioning.BATCH_AXES``, a restore places what
    it reads on the mesh, and every step runs in :func:`mesh_scope`.  A
    1-rank mesh without a process group runs as no mesh.
    Returns {"params", "opt_state", "history", "events", "axes"}."""
    device = resolve_device(device)
    if params is None:
        gen = gen if gen is not None else torch.Generator(device).manual_seed(0)
        params = lm.init_params(gen, cfg)
    paxes = lm.param_axes(cfg)
    params = PT.place_tree(params, paxes, mesh, rules)
    opt_state = adamw.init(params)
    ef = comp.init_error_buf(params) if loop_cfg.grad_compression else None
    mgr = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep)
    step_fn = make_train_step(cfg, opt_cfg, loop_cfg.grad_compression)

    start = 0
    if mgr.latest_step() is not None:
        start, params, opt_state = _restore(mgr, params, opt_state, paxes, mesh, rules)

    run = make_runner(step_fn, params, opt_state, ef, device, mesh)
    try:
        with mesh_scope(mesh, rules):
            history, events = _run_loop(loop_cfg, run, mgr, iter(data), start, paxes,
                                        inject_failure_at, device, mesh, rules)
    finally:
        run.close()  # the graph and its pool go before the caller's process group
    mgr.wait()
    return {"params": run.state["params"], "opt_state": run.state["opt"],
            "history": history, "events": events, "axes": paxes}


def _restore(mgr, params, opt_state, paxes, mesh, rules, step=None) -> tuple:
    """(step, params, opt_state) of checkpoint ``step`` (default the
    newest): through the manager's elastic path on a mesh (the parameters
    by the manifest's axes), the moments then placed as their parameters."""
    step, state = mgr.restore(step=step, template={"params": params, "opt": opt_state},
                              mesh=mesh, rules=rules)
    opt = state["opt"]
    moments = PT.place_tree({"m": opt["m"], "v": opt["v"]},
                            {"m": paxes, "v": paxes}, mesh, rules)
    return step, state["params"], {**moments, "step": opt["step"]}


def _rank0_latest(mgr, mesh) -> Optional[int]:
    """The newest checkpoint's step as rank 0 sees it, on every rank of
    ``mesh``'s process group.  Rank 0 writes the files on a thread that
    only it waits for: another rank can look before the directory is
    renamed and restart from an older step (or from none) while rank 0
    restores, and their collectives then deadlock.  Every rank receives
    the step after rank 0's wait, when the files are whole."""
    latest = mgr.latest_step()
    if mesh is None or mesh.device_mesh is None:
        return latest
    import torch.distributed as dist

    box = [latest]
    dist.broadcast_object_list(box, src=0, group=PT.mesh_world_group(mesh.device_mesh))
    return box[0]


def _run_loop(loop_cfg, run, mgr, it, step, paxes, inject_failure_at, device, mesh=None,
              rules=None):
    history, events = [], []
    durations: list = []
    retries = 0
    injected = False
    while step < loop_cfg.steps:
        batch = device_batch(next(it), device, mesh, rules)
        t0 = time.perf_counter()
        try:
            if inject_failure_at is not None and step == inject_failure_at and not injected:
                injected = True
                raise RuntimeError("injected node failure")
            metrics = {k: float(v) for k, v in run(batch).items()}
        except R.StepGraphError:
            raise
        except Exception as e:  # noqa: BLE001 — any step failure triggers recovery
            retries += 1
            events.append({"step": step, "event": "failure", "error": str(e)})
            if retries > loop_cfg.max_retries:
                raise
            mgr.wait()  # a save in flight lands first: restore the newest
            latest = _rank0_latest(mgr, mesh)
            if latest is not None:
                step, params, opt_state = _restore(mgr, run.state["params"], run.state["opt"],
                                                   paxes, mesh, rules, latest)
                run.load({"params": params, "opt": opt_state})
            else:  # no checkpoint yet: re-init optimizer, keep params
                run.zero("opt")
                step = 0
            run.zero("ef")
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
            mgr.save(step, {"params": run.state["params"], "opt": run.state["opt"]},
                     axes_tree={"params": paxes, "opt": None}, blocking=False)
    return history, events


def device_batch(batch: dict, device, mesh=None, rules=None) -> dict:
    """A numpy batch as tensors on ``device``; on a mesh of several ranks,
    the global batch as DTensors placed by ``partitioning.BATCH_AXES``
    (JAX's ``_device_batch`` makes global arrays too)."""
    if mesh is not None and mesh.device_mesh is not None:
        return PT.place_batch(batch, mesh, rules)
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}

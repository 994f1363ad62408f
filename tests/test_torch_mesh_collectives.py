"""The port's mesh train step against JAX's compiled schedule, on the CPU.

JAX's side: ``repro.launch.dryrun.build_lowerable`` lowered and compiled
on ``make_debug_mesh(2, 2)`` of 4 forced host devices (``XLA_FLAGS`` set
before the first ``jax`` import, in a child process), under
``use_mesh`` + ``active_rules`` as its ``run_cell`` does; its FLOPs a
device from ``cost_analysis`` and its collectives from the compiled HLO by
``repro.roofline.parse_collectives``.  The HLO's ``/*index=N*/`` comments
are removed first: XLA's combined collectives return tuples whose type
carries such a comment from the sixth operand on, and the parser's result
pattern (``[^=]+?``) cannot cross the ``=`` in it, so every tuple of six or
more operands, where XLA puts its gradient reductions, would be dropped.

The port's side: ``repro_torch.launch.dryrun.run_cell`` on a fake 2x2
world (fake tensors, every collective recorded by the same ring model).

Cells: ChatGLM3-6B, Qwen3-MoE-30B-A3B, RWKV6-1.6B, MiniCPM3-4B and
Whisper-base, reduced, ``stack_mode="unroll"``, fp32 on both sides (XLA's
CPU backend sends bf16 collectives as f32), B 8 x S 64, under the
``default`` (Megatron) and ``fsdp`` rules.  In every cell the port holds:

  * FLOPs a device <= 1.05 x JAX's (no replicated work);
  * wire bytes a device <= 1.10 x JAX's;
  * collectives a step <= 2 x JAX's.

Each side runs once for the module, both children at once (~2 min with
one thread each).

A 4-rank gloo world holds ``partitioning.reduce_gradients`` (the step's
gradient buckets) against DTensor's per-leaf ``redistribute``: synthetic
partial sums of every move it buckets, the collectives it issues, and one
reduced ChatGLM3-6B step's gradients under both presets, whose fp32 gap
from the per-leaf reduction is printed and held within 1e-4 relative.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_distributed import WORLD_PREAMBLE, run_world

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("chatglm3-6b", "qwen3-moe-30b-a3b", "rwkv6-1.6b", "minicpm3-4b", "whisper-base")
PRESETS = ("default", "fsdp")
FLOPS_RATIO, BYTES_RATIO, COUNT_RATIO = 1.05, 1.10, 2.0
CHILD_TIMEOUT_S = 400

_JAX_SIDE = r"""
import json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from repro import roofline as R
from repro.configs import get_reduced
from repro.launch import dryrun as JD
from repro.models.config import ShapeConfig
from repro.runtime import compat as RTC
from repro.runtime import partitioning as SH
from repro.runtime.mesh import make_debug_mesh

shape = ShapeConfig("train_b8_s64", 64, 8, "train")
mesh = make_debug_mesh(2, 2)
out = {}
for arch in sys.argv[1].split(","):
    cfg = get_reduced(arch, stack_mode="unroll", dtype="float32")
    for preset in ("default", "fsdp"):
        rules = (SH.fsdp_rules if preset == "fsdp" else SH.batch_rules)(mesh, shape.global_batch)
        fn, args, _ = JD.build_lowerable(cfg, shape, mesh, rules)
        with RTC.use_mesh(mesh), SH.active_rules(rules):
            compiled = fn.lower(*args).compile()
        # a tuple's type carries /*index=N*/ from its sixth operand on
        hlo = re.sub(r"/\*index=\d+\*/", "", compiled.as_text())
        out[f"{arch}|{preset}"] = dict(
            flops=float((compiled.cost_analysis() or {}).get("flops", 0.0)),
            summary=R.summarize_collectives(R.parse_collectives(hlo)))
print(json.dumps(out))
"""

_PORT_SIDE = r"""
import json, logging, sys
logging.disable(logging.WARNING)
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun as D
from repro_torch.models.config import ShapeConfig

shape = ShapeConfig("train_b8_s64", 64, 8, "train")
fp32 = lambda arch, **kw: get_reduced(arch, dtype="float32", **kw)
out = {}
for arch in sys.argv[1].split(","):
    for preset in ("default", "fsdp"):
        rec = D.run_cell(arch, shape, False, mesh=(2, 2), rules_preset=preset,
                         config_fn=fp32)
        out[f"{arch}|{preset}"] = dict(flops=rec["flops_per_device"],
                                       summary=rec["collective_summary"])
print(json.dumps(out))
"""


def run_sides() -> dict:
    """{"jax": ..., "port": ...}: each cell's FLOPs a device and its
    collectives by kind, both children run at once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = {side: subprocess.Popen([sys.executable, "-W", "ignore", "-c", code,
                                     ",".join(ARCHS)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True, env=env, cwd=str(ROOT))
             for side, code in (("jax", _JAX_SIDE), ("port", _PORT_SIDE))}
    outs = {}
    try:
        for side, p in procs.items():
            outs[side] = p.communicate(timeout=CHILD_TIMEOUT_S)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for side, p in procs.items():
        assert p.returncode == 0, (side, outs[side][0][-2000:], outs[side][1][-4000:])
    return {side: json.loads(outs[side][0].strip().splitlines()[-1]) for side in procs}


@pytest.fixture(scope="module")
def schedules():
    return run_sides()


def _totals(summary: dict) -> tuple:
    return (sum(s["wire_bytes"] for s in summary.values()),
            sum(s["count"] for s in summary.values()))


def _by_kind(summary: dict) -> str:
    return ", ".join(f"{op} {s['count']}x {s['wire_bytes'] / 1e6:.4f} MB"
                     for op, s in sorted(summary.items()))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("arch", ARCHS)
def test_port_schedule_within_jax_compiled_schedule(schedules, arch, preset):
    key = f"{arch}|{preset}"
    jax_cell, port = schedules["jax"][key], schedules["port"][key]
    jb, jc = _totals(jax_cell["summary"])
    pb, pc = _totals(port["summary"])
    note = (f"{key}: JAX {jax_cell['flops']:.4g} FLOPs, {_by_kind(jax_cell['summary'])}; "
            f"port {port['flops']:.4g} FLOPs, {_by_kind(port['summary'])}")
    assert jc > 0 and pc > 0, note
    assert port["flops"] <= FLOPS_RATIO * jax_cell["flops"], note
    assert pb <= BYTES_RATIO * jb, note
    assert pc <= COUNT_RATIO * jc, note


# ------------------------------------------------------- the gradient buckets

_BUCKETS = WORLD_PREAMBLE + r"""
import json, logging
logging.disable(logging.WARNING)
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch import roofline as R
from repro_torch.runtime import make_debug_mesh
from repro_torch.runtime import partitioning as PT

mesh = make_debug_mesh(2, 2, device="cpu")
dm = mesh.device_mesh
P, Rp, S = Partial(), Replicate(), Shard
# (gradient placements, parameter placements) on the (data, model) mesh
MOVES = {
    "partial both -> whole": ((P, P), (Rp, Rp)),
    "partial both -> cut on model": ((P, P), (Rp, S(0))),
    "partial data -> whole": ((P, Rp), (Rp, Rp)),
    "partial data, cut on model": ((P, S(1)), (Rp, S(1))),
    "whole -> cut on both": ((Rp, Rp), (S(0), S(1))),
    "partial model -> cut on data": ((Rp, P), (S(1), Rp)),
}
gen = torch.Generator().manual_seed(100 + rank)
grads, params, names = [], [], []
for name, (gp, pp) in MOVES.items():
    for shape in ((8, 12), (4, 6)):
        local = torch.randn(shape, generator=gen)
        if S(1) in gp:  # a cut gradient: this rank's columns of a (8, 24) / (4, 12)
            shape = (shape[0], shape[1] * 2)
        g = DTensor.from_local(local, dm, list(gp), run_check=False, shape=shape,
                               stride=(shape[1], 1))
        if gp == (Rp, Rp):  # a whole value is the same on every rank
            g = DTensor.from_local(torch.ones(shape) * 0.5, dm, list(gp), run_check=False)
        p = DTensor.from_local(torch.zeros(shape), dm, [Rp, Rp], run_check=False)
        params.append(p.redistribute(dm, list(pp)))
        grads.append(g)
        names.append(name)
rec = R.CollectiveRecorder()
with rec:
    got = PT.reduce_gradients(grads, params)
want = [g.redistribute(p.device_mesh, p.placements) for g, p in zip(grads, params)]
out = {"collectives": len(rec.records), "per_leaf": {}}
for name, a, b, p in zip(names, got, want, params):
    assert tuple(a.placements) == tuple(p.placements), (name, a.placements)
    err = float((a.to_local() - b.to_local()).abs().max())
    out["per_leaf"][name] = max(out["per_leaf"].get(name, 0.0), err)

# one reduced ChatGLM3-6B step's gradients, bucketed and per leaf
from repro_torch.configs import get_reduced
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train.loop import device_batch, mesh_scope

cfg = get_reduced("chatglm3-6b", dtype="float32")
tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)
out["step"] = {}
for preset in ("default", "fsdp"):
    rules = (PT.fsdp_rules if preset == "fsdp" else PT.batch_rules)(mesh, 8)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    placed = PT.place_tree(params, lm.param_axes(cfg), mesh, rules)
    flat = adamw.leaves(placed)
    with mesh_scope(mesh, rules):
        for p in flat:
            p.requires_grad_(True)
        loss, _ = lm.loss_fn(placed, device_batch({"tokens": tokens}, "cpu", mesh, rules), cfg)
        raw = torch.autograd.grad(loss, flat, materialize_grads=True)
        with rec:
            bucketed = PT.reduce_gradients(list(raw), flat)
        n_buckets = len(rec.records)
        with rec:
            per_leaf = [adamw.like(g, p) for g, p in zip(raw, flat)]
        n_leaf = len(rec.records)
    gap = 0.0
    for a, b in zip(bucketed, per_leaf):
        a, b = a.full_tensor(), b.full_tensor()
        gap = max(gap, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
    out["step"][preset] = dict(gap=gap, bucketed=n_buckets, per_leaf=n_leaf)
if rank == 0:
    print(json.dumps(out))
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def buckets(tmp_path_factory):
    outs = run_world(_BUCKETS, 4, tmp_path_factory.mktemp("buckets"))
    return json.loads(outs[0].strip().splitlines()[-1])


@pytest.mark.parametrize("move", [
    "partial both -> whole", "partial both -> cut on model", "partial data -> whole",
    "partial data, cut on model", "whole -> cut on both", "partial model -> cut on data"])
def test_reduce_gradients_equals_redistribute(buckets, move):
    # sums of 2 or 4 fp32 values: an order apart at most by an ulp of each
    assert buckets["per_leaf"][move] <= 1e-6, buckets["per_leaf"]


def test_reduce_gradients_one_collective_a_bucket_and_mesh_dim(buckets):
    # a bucket each (dtype, move on each mesh dim): partial on both dims and
    # whole, one all-reduce over the world; partial on both and cut on
    # model, a reduce-scatter over model and an all-reduce over data;
    # partial on data (whole or cut on model: one bucket), an all-reduce
    # over data; whole and cut on both, none; partial on model and cut on
    # data, a local cut and an all-reduce over model
    assert buckets["collectives"] == 1 + 2 + 1 + 0 + 1, buckets


@pytest.mark.parametrize("preset", PRESETS)
def test_bucketed_step_gradients_within_1e4_of_per_leaf(buckets, preset):
    step = buckets["step"][preset]
    print(f"{preset}: bucketed gradients from the per-leaf reduction: "
          f"largest relative gap {step['gap']:.3e}; collectives {step['bucketed']} "
          f"bucketed, {step['per_leaf']} per leaf")
    assert step["gap"] <= 1e-4, step
    assert step["bucketed"] < step["per_leaf"], step


def table(sides: dict) -> str:
    """The cells as a markdown table: wire MB a device and collectives a
    step on each side, with the port's ratios to JAX's."""
    rows = ["| family | rules | JAX MB (count) | port MB (count) | bytes × | count × | FLOPs × |",
            "|---|---|---|---|---|---|---|"]
    for arch in ARCHS:
        for preset in PRESETS:
            j, p = sides["jax"][f"{arch}|{preset}"], sides["port"][f"{arch}|{preset}"]
            (jb, jc), (pb, pc) = _totals(j["summary"]), _totals(p["summary"])
            rows.append(f"| {arch} | {preset} | {jb / 1e6:.2f} ({jc}) | {pb / 1e6:.2f} ({pc}) "
                        f"| {pb / jb:.2f} | {pc / jc:.2f} | {p['flops'] / j['flops']:.2f} |")
    return "\n".join(rows)


if __name__ == "__main__":  # the table of docs/DRYRUN_TORCH.md (~2 min)
    print(table(run_sides()))

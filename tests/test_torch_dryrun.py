"""The port's dry-run (``repro_torch.launch.{specs,dryrun,gnn_dryrun,report}``)
against the JAX package's, on the CPU.

* ``specs``: the batch and decode stand-ins of ten configs x four shapes
  equal JAX's in shapes and dtypes.
* ``cell_skip_reason`` equals JAX's on all 40 cells, and ``estimate_hbm``
  JAX's on the same record apart from the capacity (80 GB: ``fits_80gb``).
  JAX's ``launch/dryrun.py`` overwrites ``XLA_FLAGS`` on import, so it runs
  in a child process (``JAX_PLATFORMS=cpu``), never in a test worker.
* Reduced ChatGLM3-6B (dense) and Qwen3-MoE (MoE) train cells on a fake
  2x2 world under ``default`` and ``fsdp`` (one child process: a fake world
  is process-global): 4 x the per-device FLOPs within 1 % of the one-rank
  count (a rank does a quarter of the matmuls; the MoE's routing leaves
  some replicated work), ``argument_bytes`` equal to an independent sum of
  the local shard bytes, the collective kinds the rules imply (all-reduces
  under ``default``, all-gathers and reduce-scatters under ``fsdp``) and
  ``useful_flops_ratio`` in (0.3, 1].  Nothing allocates the model: the
  tensors are fake.
* ``gnn_dryrun`` at 2^10 nodes, 2^12 edges, F 16 on a fake world of 4: the
  all-gather's wire bytes and the argument bytes equal their closed forms.
* ``report``: tables equal to JAX's on the same records, apart from the
  header's capacity and ``trace_s`` (JAX's ``compile_s``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import report as JREP
from repro.launch import specs as JSPECS
from repro.models.config import SHAPES as JSHAPES
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import report as REP
from repro_torch.launch import specs as SPECS
from repro_torch.models.config import SHAPES
from repro_torch.runtime import compat as RTC
from repro_torch.runtime import partitioning as SH
from repro_torch.runtime.mesh import PRODUCTION_SHAPES

ROOT = Path(__file__).resolve().parent.parent
_JDT = {"int32": torch.int32, "bfloat16": torch.bfloat16, "float32": torch.float32}


def _child(code: str, *args) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-W", "ignore", "-c", code, *args],
                       capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=400)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert SPECS.batch_axes(cfg) == JSPECS.batch_axes(jcfg)
    for name in SHAPES:
        got, want = SPECS.batch_specs(cfg, SHAPES[name]), JSPECS.batch_specs(jcfg, JSHAPES[name])
        assert list(got) == list(want)
        for k in got:
            assert got[k].shape == tuple(want[k].shape), (arch, name, k)
            assert got[k].dtype == _JDT[str(want[k].dtype)], (arch, name, k)
        for g, w in zip(SPECS.decode_token_specs(cfg, SHAPES[name]),
                        JSPECS.decode_token_specs(jcfg, JSHAPES[name])):
            assert g.shape == tuple(w.shape) and g.dtype == _JDT[str(w.dtype)]


_JAX_SIDE = r"""
import json, sys
from repro.configs import ARCHS, get_config
from repro.launch import dryrun as JD
from repro.models.config import SHAPES
from repro.runtime import partitioning as SH
from repro.runtime.mesh import make_production_mesh

rec = json.loads(sys.argv[1])
out = {"skip": {f"{a}|{s}": JD.cell_skip_reason(a, get_config(a), SHAPES[s])
                for a in ARCHS for s in SHAPES}, "hbm": {}}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch, shape in (("chatglm3-6b", "train_4k"), ("qwen3-moe-30b-a3b", "decode_32k"),
                        ("rwkv6-1.6b", "long_500k"), ("gemma3-12b", "prefill_32k")):
        cfg, sh = get_config(arch), SHAPES[shape]
        for preset in ("default", "fsdp"):
            rules = (SH.fsdp_rules if preset == "fsdp" else SH.batch_rules)(mesh, sh.global_batch)
            out["hbm"][f"{multi}|{arch}|{shape}|{preset}"] = JD.estimate_hbm(cfg, sh, mesh, rec, rules)
print(json.dumps(out))
"""
_RECORD = {"memory": {"argument_bytes": 3_141_592_653}}


@pytest.fixture(scope="module")
def jax_side():
    return _child(_JAX_SIDE, json.dumps(_RECORD))


def test_cell_skip_reason_equals_jax_on_all_40_cells(jax_side):
    got = {f"{a}|{s}": D.cell_skip_reason(a, get_config(a), SHAPES[s])
           for a in ARCHS for s in SHAPES}
    assert len(got) == 40 and got == jax_side["skip"]
    assert sum(v is not None for v in got.values()) > 0


def test_estimate_hbm_equals_jax_apart_from_the_capacity(jax_side):
    for key, want in jax_side["hbm"].items():
        multi, arch, shape, preset = key.split("|")
        dims, axes = PRODUCTION_SHAPES[multi == "True"]
        mesh = RTC.Mesh(dict(zip(axes, dims)), "cpu")  # shapes only: no world
        sh = SHAPES[shape]
        rules = (SH.fsdp_rules if preset == "fsdp" else SH.batch_rules)(mesh, sh.global_batch)
        got = D.estimate_hbm(get_config(arch), sh, mesh, _RECORD, rules)
        assert got.pop("fits_80gb") == (got["total"] < 80e9)
        want.pop("fits_16gb")
        assert got == want, key


_CELLS = r"""
import json, logging
logging.disable(logging.WARNING)
import torch
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun as D
from repro_torch.launch import gnn_dryrun as G
from repro_torch.models import lm
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw
from repro_torch.runtime import partitioning as SH

shape = ShapeConfig("train_b8_s64", 64, 8, "train")
red = lambda a, **kw: get_reduced(a, **kw)
out = {}
for arch in ("chatglm3-6b", "qwen3-moe-30b-a3b"):
    one = D.run_cell(arch, shape, False, mesh=(1, 1), config_fn=red)
    for preset in ("default", "fsdp"):
        rec = D.run_cell(arch, shape, False, mesh=(2, 2), rules_preset=preset, config_fn=red)
        mesh = D._mesh_for((2, 2), False)
        rules = (SH.fsdp_rules if preset == "fsdp" else SH.batch_rules)(mesh, 8)
        cfg = get_reduced(arch, stack_mode="unroll")
        with D.fake_mode():
            params = lm.init_params(torch.Generator().manual_seed(0), cfg)
        # the rank's bytes by the specs alone: each dim over its axes' sizes
        def local(shape, axes, itemsize):
            spec = SH.resolve_spec(axes, tuple(shape), mesh, rules)
            n = 1
            for dim, entry in zip(shape, spec):
                cut = 1
                for ax in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
                    cut *= mesh.shape[ax]
                n *= dim // cut
            return n * itemsize
        total = 0
        def visit(p, ax):
            global total
            axes = ax if ax is not None else (None,) * p.dim()
            total += local(p.shape, axes, p.element_size())  # the parameter
            total += 2 * local(p.shape, axes, 4)  # its two fp32 moments
        SH._map_with_axes(visit, params, lm.param_axes(cfg))
        total += 4  # the optimizer's step
        total += local((8, 64), ("batch", "seq"), 4)  # the tokens
        out[f"{arch}|{preset}"] = dict(
            flops=rec["flops_per_device"], one=one["flops_per_device"],
            args=rec["memory"]["argument_bytes"], want_args=total,
            kinds={k: v["count"] for k, v in rec["collective_summary"].items()},
            useful=rec["roofline"]["useful_flops_ratio"],
            temp=rec["memory"]["temp_bytes"], alias=rec["memory"]["alias_bytes"])
g = G.run(False, log_nodes=10, log_edges=12, feat=16, world=4)
out["gnn"] = dict(colls=g["collectives"], memory=g["memory"])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cells():
    return _child(_CELLS)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("preset", ["default", "fsdp"])
def test_train_cell_on_a_fake_2x2_world(cells, arch, preset):
    c = cells[f"{arch}|{preset}"]
    assert c["flops"] > 0 and c["one"] > 0
    assert 4 * c["flops"] == pytest.approx(c["one"], rel=1e-2)
    assert c["args"] == c["want_args"]
    assert 0 < c["alias"] <= c["args"] and c["temp"] > 0  # updated in place
    kinds = c["kinds"]
    if preset == "default":
        assert kinds.get("all-reduce", 0) > 0
    else:
        assert kinds.get("all-gather", 0) > 0 and kinds.get("reduce-scatter", 0) > 0
    assert 0.3 < c["useful"] <= 1.0


def test_gnn_dryrun_bytes_equal_their_closed_forms(cells):
    n, e, f, p = 2**10, 2**12, 16, 4
    gathers = [c for c in cells["gnn"]["colls"] if c["op"] == "all-gather"]
    # x's rows gathered from every rank (bf16): N F 2 bytes, (P-1)/P on the wire
    assert gathers[0]["result_bytes"] == n * f * 2
    assert gathers[0]["wire_bytes"] == n * f * 2 * (p - 1) / p
    assert all(c["group_size"] == p for c in cells["gnn"]["colls"])
    # a rank's arguments: its rows of x and its edges' src, dst (int32), mask
    assert cells["gnn"]["memory"]["argument_bytes"] == (n * f * 2 + e * (4 + 4 + 1)) // p


def _records():
    base = dict(arch="chatglm3-6b", shape="train_4k", mesh="16x16", kind="train",
                flops_per_device=2.4e14, memory=dict(argument_bytes=4.5e9, temp_bytes=3.1e10),
                collective_summary={"all-reduce": {"count": 209, "wire_bytes": 3.6e11},
                                    "all-gather": {"count": 56, "wire_bytes": 1.2e9}},
                hbm_estimate={"total": 2.3e10},
                roofline=dict(compute_s=0.245, memory_s=0.036, collective_s=0.73,
                              bound="collective", step_lower_bound_s=0.73,
                              useful_flops_ratio=0.578))
    recs = [dict(base), dict(base, shape="decode_32k", kind="decode",
                             roofline=dict(base["roofline"], bound="memory")),
            dict(base, mesh="2x16x16"), dict(base, arch="whisper-base", shape="long_500k",
                                             skipped="whisper decoder context is 448"),
            dict(base, arch="x", error="RuntimeError: boom")]
    for i, r in enumerate(recs):
        r["compile_s"] = r["trace_s"] = 12.5 + i
        r["hbm_estimate"] = dict(r["hbm_estimate"], fits_16gb=i % 2 == 0, fits_80gb=i % 2 == 0)
    return recs


def test_report_tables_equal_jax_apart_from_the_header():
    recs = _records()
    for ours, theirs in ((REP.dryrun_table, JREP.dryrun_table),
                         (REP.roofline_table, JREP.roofline_table)):
        got, want = ours(recs).splitlines(), theirs(recs).splitlines()
        assert got[1:] == want[1:]
        assert got[0] == want[0].replace("compile_s", "trace_s").replace("16G", "80G")


def test_report_fills_both_markers(tmp_path):
    recs = _records()
    md = "# x\n\n## Dry-run\n\n<!-- DRYRUN_TABLE -->\nold\n\n## Roofline\n\n<!-- ROOFLINE_TABLE -->\nold\n"
    out = REP.fill(md, recs)
    assert "old" not in out and REP.dryrun_table(recs) in out and REP.roofline_table(recs) in out
    assert REP.fill(out, recs) == out  # idempotent


# ------------------------------------------------------------ decode on a mesh
#
# A decode step on a mesh writes slot t of each rank's block of the cache
# and attends on that block under ``local_map`` (``models/layers.py:
# _decode_sharded``).  Without it DTensor has no strategy for the cache's
# ``index_copy_`` nor for decode attention's ``bmm(out=)`` on torch 2.11,
# and on torch 2.13 it all-gathers the cache a sequence at a time.

_DECODE = r"""
import json, logging
logging.disable(logging.WARNING)
from torch.distributed.tensor import DTensor
from torch.overrides import TorchFunctionMode
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun as D
from repro_torch.models.config import ShapeConfig


class OutOnDTensor(TorchFunctionMode):
    # every torch call given out= where an argument or the out is a DTensor
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = kwargs.get("out")
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        if out is not None and any(isinstance(t, DTensor) for t in [*args, *outs]):
            self.calls.append(str(func))
        return func(*args, **kwargs)


shape = ShapeConfig("decode_b8_c256", 256, 8, "decode")
red = lambda a, **kw: get_reduced(a, **kw)
mode = OutOnDTensor()
with mode:
    rec = D.run_cell("chatglm3-6b", shape, False, mesh=(2, 2), config_fn=red)
one = D.run_cell("chatglm3-6b", shape, False, mesh=(1, 1), config_fn=red)
print(json.dumps(dict(error=rec.get("error"), colls=rec["collectives"], out_calls=mode.calls,
                      flops=rec["flops_per_device"], one=one["flops_per_device"])))
"""


def test_decode_cell_on_a_fake_2x2_world_gathers_no_cache():
    """A reduced ChatGLM3-6B decode cell (B 8, cache 256) on a fake 2x2
    world: no ``out=`` call meets a DTensor, and no all-gather moves the
    cache (no gathered shape has the cache's 256 positions; the one
    all-gather left is the vocab-cut head's (d, V) weight in ``logits_fn``,
    where the unsharded step gathered 193 times); a rank does a quarter of
    the one-rank FLOPs (its batch half and its head half) within 5 %."""
    c = _child(_DECODE)
    assert c["error"] is None and c["out_calls"] == [], c["out_calls"]
    gathers = [r["shape"] for r in c["colls"] if r["op"] == "all-gather"]
    assert not any(256 in shape for shape in gathers), gathers
    assert len(gathers) <= 1, gathers
    assert 4 * c["flops"] == pytest.approx(c["one"], rel=5e-2)


_DECODE_WORLD = r"""
import json
from torch.distributed.tensor import DTensor
from repro_torch import runtime as RT
from repro_torch.configs import get_reduced
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime import partitioning as SH
from repro_torch.train.loop import mesh_scope

cfg = get_reduced("chatglm3-6b", dtype="float32")
params = lm.init_params(torch.Generator().manual_seed(0), cfg)
rng = np.random.default_rng(3)
prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32))
tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32))
cache, _, t0 = lm.prefill(params, {"tokens": prompt}, cfg, 16)
want_cache = adamw.tree_map(lambda x: x.clone(), cache)
want, _ = lm.decode_step(params, want_cache, tok, t0, cfg)
res = {}
for shape in ((1, 2), (2, 1)):
    mesh = RT.make_mesh(shape, ("data", "model"), device="cpu")
    rules = SH.batch_rules(mesh, 4)
    put = lambda x, axes: SH.place(x, SH.resolve_spec(axes, tuple(x.shape), mesh, rules), mesh)
    placed = SH.place_tree(params, lm.param_axes(cfg), mesh, rules)
    pc = SH._map_with_axes(lambda x, axes: put(x.clone(), axes), cache, lm.cache_axes(cfg))
    with mesh_scope(mesh, rules):
        got, got_cache = lm.decode_step(placed, pc, put(tok, ("batch", None)), t0, cfg)
    got = got.full_tensor() if isinstance(got, DTensor) else got
    res["x".join(map(str, shape))] = dict(
        err=float((got - want).abs().max() / want.abs().max()),
        cache=max(float((a.full_tensor() - b).abs().max() / b.abs().max()) for a, b in
                  zip(adamw.leaves(got_cache), adamw.leaves(want_cache))),
        placements=sorted({str(a.placements) for a in adamw.leaves(got_cache)}))
if rank == 0:
    print(json.dumps(res))
"""


def test_decode_on_a_gloo_world_matches_one_rank(tmp_path):
    """The same step on a real 2-rank gloo world of CPU ranks, the cache cut
    on its batch (2x1) and on its kv heads (1x2), fp32: the logits equal the
    one-rank step's within 1e-5 of their largest, and every layer's cache
    after the step the one-rank cache within 1e-6 of its largest (slot t
    written on each rank's block; a rank projects k and v with its block of
    the weights, whose products may round apart from the whole matmul's)."""
    from test_torch_distributed import WORLD_PREAMBLE, run_world

    res = json.loads(run_world(WORLD_PREAMBLE + _DECODE_WORLD, 2, tmp_path)[0]
                     .strip().splitlines()[-1])
    assert set(res) == {"1x2", "2x1"}
    for shape, r in res.items():
        assert r["err"] <= 1e-5 and r["cache"] <= 1e-6, (shape, r)
    # the stacked caches (layers, B, S, Hkv, D): batch and kv heads cut
    assert all(r["placements"] == ["(Shard(dim=1), Shard(dim=3))"] for r in res.values())

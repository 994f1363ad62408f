"""The mesh branch's entry points and its sharding constraints, on the CPU:

  * the launcher as a process with ``--device cpu``: ``--debug-mesh 1x1``
    (one rank, no process group), ``1x2`` under ``default`` and ``2x2
    --rules fsdp`` (the launcher starts 2 and 4 gloo ranks): rank 0 alone
    prints JAX's three ``step N loss L (T ms)`` lines and ``done``, and the
    last checkpoint holds every leaf;
  * ``runtime.logical_constraint`` on DTensors, in a 4-rank world on a 2x2
    mesh under both presets: at every one of JAX's call sites
    (``models/layers.py`` q / k / v, ``transformer.py``'s residual stream,
    ``moe.py``'s slots, expert outputs and combine, ``ssm.py``'s Mamba
    ``xz``) the placements are those ``resolve_spec`` gives the call's
    logical axes on JAX's shape, and the values are unchanged;
  * on the same mesh, a train step's loss and gradients with remat on equal
    those with it off bit for bit (``torch.utils.checkpoint`` over
    DTensors), and every rank counts the same ``flash_attention``
    dispatches, as many as a mesh-less step does; ChatGLM3's KV padding
    (``kv_pad_to``: one stored KV head, whole on every rank, repeated to 4
    and cut over "model") with remat gives the mesh-less step's loss and
    gradients within 1e-5 (of each leaf's largest magnitude);
  * remat's recompute runs in the forward's mesh scope from another
    thread (on the card autograd runs the backward in its device thread,
    where the mesh and rules contextvars are unset), and scopes nest.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import runtime as RT
from repro_torch.checkpoint.manager import CheckpointManager

from test_torch_distributed import WORLD_PREAMBLE, run_world

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("flags", [["--debug-mesh", "1x1"], ["--debug-mesh", "1x2"],
                                   ["--debug-mesh", "2x2", "--rules", "fsdp"]])
def test_launcher_trains_on_a_debug_mesh(tmp_path, flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "chatglm3-6b",
         "--reduced", "--steps", "3", "--batch", "4", "--seq", "32", "--ckpt-every", "2",
         "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu", *flags],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert [ln.split()[:2] for ln in lines[:3]] == [["step", str(i)] for i in range(3)]
    assert all(" loss " in ln and ln.endswith(" ms)") for ln in lines[:3])
    assert lines[3:] == ["done"]  # rank 0 alone prints
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.all_steps() == [2, 3]
    manifest = json.loads((tmp_path / "ck" / "step_00000003" / "manifest.json").read_text())
    assert "params/blocks/0/mixer/wq" in manifest["keys"]
    assert manifest["axes"]["params/embed"] == ["vocab", "embed"]


def test_launcher_refuses_a_malformed_mesh(capsys):
    from repro_torch.launch import train as TLT

    with pytest.raises(SystemExit) as err:
        TLT.main(["--arch", "chatglm3-6b", "--reduced", "--device", "cpu",
                  "--debug-mesh", "2by2"])
    assert err.value.code == 2
    assert "DxM" in capsys.readouterr().err


B, S, H, HD, D, E, C, DI = 4, 8, 4, 8, 16, 4, 8, 32
# JAX's call sites: (name, logical axes, JAX's shape)
SITES = [
    ("layers.q", ("batch", "seq", "heads", None), (B, S, H, HD)),
    ("layers.kv", ("batch", "seq", "kv_heads", None), (B, S, H, HD)),
    ("transformer.residual", ("batch", "seq", None), (B, S, D)),
    ("moe.combine", ("batch", None, None), (B, S * 2, D)),
    ("ssm.xz", ("batch", "seq", None, "inner"), (B, S, 2, DI)),
]
MOE_SLOTS = ("moe_batch", "experts", None, None)  # on JAX's (B, E, C, D)

_CONSTRAINTS = WORLD_PREAMBLE + r"""
import dataclasses
import json
from torch.distributed.tensor import Replicate, distribute_tensor

from repro_torch import runtime as RT
from repro_torch.configs import get_reduced
from repro_torch.models import lm, moe
from repro_torch.obs.metrics import default_registry
from repro_torch.optim import adamw
from repro_torch.train.loop import loss_and_grads, mesh_scope

sites, out_path = json.loads(sys.argv[4]), sys.argv[5]
mesh = RT.make_debug_mesh(2, 2, device="cpu")
torch.manual_seed(0)
res = {}
for preset in ("default", "fsdp"):
    rules = (RT.fsdp_rules if preset == "fsdp" else RT.batch_rules)(mesh, 4)
    with mesh_scope(mesh, rules):
        for name, axes, shape in sites:
            x = torch.randn(shape)
            d = distribute_tensor(x, mesh.device_mesh, [Replicate(), Replicate()])
            y = RT.logical_constraint(d, tuple(axes))
            assert torch.equal(y.full_tensor(), x), name
            res[f"{preset}/{name}"] = [str(p) for p in y.placements]
        b, e, c, dd = 4, 4, 8, 16
        x = torch.randn(e, b * c, dd)
        d = distribute_tensor(x, mesh.device_mesh, [Replicate(), Replicate()])
        y = moe._lc_slots(d, b, c)
        assert torch.equal(y.full_tensor(), x)
        res[f"{preset}/moe.slots"] = [str(p) for p in y.placements]

# a step with remat on and off, and the flash census, on the 2x2 mesh
cfg = get_reduced("chatglm3-6b", dtype="float32")
rules = RT.batch_rules(mesh, 4)
params = lm.init_params(torch.Generator().manual_seed(0), cfg)
batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)}
census = lambda: default_registry().counter("kernels_dispatch_total").value(
    op="flash_attention", path="reference")
placed = RT.place_tree(params, lm.param_axes(cfg), mesh, rules)
outs = {}
for remat in (True, False):
    c0 = census()
    with mesh_scope(mesh, rules):
        loss, aux, grads = loss_and_grads(placed, RT.place_batch(batch, mesh, rules),
                                          dataclasses.replace(cfg, remat=remat))
    outs[remat] = (loss, [g.full_tensor() for g in adamw.leaves(grads)], census() - c0)
res["remat_equal"] = bool(torch.equal(outs[True][0], outs[False][0]) and all(
    torch.equal(a, b) for a, b in zip(outs[True][1], outs[False][1])))
# ChatGLM3's KV padding (kv_pad_to: wk's one stored head replicated, the 4
# repeated ones cut over "model") with remat, against the mesh-less step
kv = get_reduced("chatglm3-6b", dtype="float32", num_kv_heads=1, kv_pad_to=4, remat=True)
kv_params = lm.init_params(torch.Generator().manual_seed(2), kv)
kv_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
want = loss_and_grads(kv_params, kv_batch, kv)
with mesh_scope(mesh, rules):
    got = loss_and_grads(RT.place_tree(kv_params, lm.param_axes(kv), mesh, rules),
                         RT.place_batch(batch, mesh, rules), kv)
res["kv_pad"] = [abs(float(got[0]) - float(want[0])) / abs(float(want[0])), max(
    float((g.full_tensor() - w).abs().max() / w.abs().max())
    for g, w in zip(adamw.leaves(got[2]), adamw.leaves(want[2])))]
counts = [None] * world
dist.all_gather_object(counts, [outs[True][2], outs[False][2]])
res["census"] = counts  # every rank's (remat on, off)
if rank == 0:
    with open(out_path, "w") as f:
        json.dump(res, f)
"""


@pytest.fixture(scope="module")
def constraint_world(tmp_path_factory):
    wd = tmp_path_factory.mktemp("constraints")
    out = wd / "placements.json"
    run_world(_CONSTRAINTS, 4, wd, args=(json.dumps(SITES), out))
    return json.loads(out.read_text())


def _expected(axes, shape, preset):
    mesh = RT.Mesh({"data": 2, "model": 2}, "cpu")
    rules = (RT.fsdp_rules if preset == "fsdp" else RT.batch_rules)(mesh, B)
    return RT.resolve_spec(axes, shape, mesh, rules), mesh


@pytest.mark.parametrize("preset", ["default", "fsdp"])
@pytest.mark.parametrize("name,axes,shape", SITES)
def test_logical_constraint_places_dtensors_as_resolve_spec(constraint_world, preset,
                                                            name, axes, shape):
    spec, mesh = _expected(axes, shape, preset)
    assert constraint_world[f"{preset}/{name}"] == [str(p) for p in
                                                    RT.to_placements(spec, mesh)]


@pytest.mark.parametrize("preset", ["default", "fsdp"])
def test_moe_slots_take_jax_axes_on_the_expert_major_layout(constraint_world, preset):
    mb, ex, _, _ = _expected(MOE_SLOTS, (4, 4, 8, 16), preset)[0]
    mesh = RT.Mesh({"data": 2, "model": 2}, "cpu")
    want = RT.to_placements(RT.PartitionSpec(ex, mb, None), mesh)  # (E, B*C, D)
    assert constraint_world[f"{preset}/moe.slots"] == [str(p) for p in want]


def test_remat_on_a_mesh_is_bit_for_bit_and_every_rank_counts_flash(constraint_world):
    assert constraint_world["remat_equal"]
    layers = 4  # reduced ChatGLM3-6B: one flash call a layer, again in remat
    assert constraint_world["census"] == [[2 * layers, layers]] * 4


def test_kv_padding_with_remat_on_a_mesh_matches_the_meshless_step(constraint_world):
    loss_rel, grad_rel_of_max = constraint_world["kv_pad"]
    assert loss_rel <= 1e-5 and grad_rel_of_max <= 1e-5, constraint_world["kv_pad"]


def test_recompute_scope_reaches_another_thread_and_scopes_nest():
    import threading

    from torch.distributed.tensor import DTensor

    from repro_torch.runtime import partitioning as PT

    mesh = RT.Mesh({"data": 1, "model": 2}, "cpu")
    rules = RT.fsdp_rules(mesh, 4)
    seen = {}

    def probe():
        seen["mesh"], seen["rules"] = RT.get_active_mesh(), PT.current_rules()
        seen["implicit"] = DTensor._op_dispatcher._allow_implicit_replication

    with PT.mesh_scope(mesh, rules):
        fn = PT.in_this_scope(probe)
        fn()  # a scope inside the scope: the outer one's setting comes back
        assert DTensor._op_dispatcher._allow_implicit_replication
    assert not DTensor._op_dispatcher._allow_implicit_replication
    seen.clear()
    thread = threading.Thread(target=fn)
    thread.start()
    thread.join()
    assert seen == {"mesh": mesh, "rules": rules, "implicit": True}
    assert PT.in_this_scope(probe) is probe  # no mesh: the function itself

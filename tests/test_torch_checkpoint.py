"""The port's checkpoint manager (``repro_torch.checkpoint``) on the CPU:
counterparts of ``tests/test_checkpoint.py``'s roundtrip / retention,
async, no-partial and elastic-restore tests (a gloo world of 8 CPU ranks
saves a DTensor sharded on a 4x2 mesh, a world of 4 restores it on 2x2 by
its logical axes, values exact), and the on-disk format shared with the JAX
package's manager: a JAX-written checkpoint restores in the port and a
port-written one in JAX, bf16 leaves included, bit for bit both ways, and
the two managers write the same keys, dtypes and logical axes for one LM
state.
"""
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import params as JP
from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.configs import get_reduced as jget_reduced
from repro.models import lm as JLM
from repro.optim import adamw as JA
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.convert import from_jax_lm_params, from_jax_opt_state
from repro_torch.models import lm as TLM
from repro_torch.optim import adamw


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones((2, 2), dtype=torch.bfloat16) * 1.5,
                       "c": torch.tensor(3, dtype=torch.int32)},
            "blocks": [{"w": torch.randn((2, 3), generator=torch.Generator().manual_seed(0))}]}


def _same_bits(got, want):
    for g, w in zip(adamw.leaves(got), adamw.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16 else g,
                           w.view(torch.int16) if w.dtype == torch.bfloat16 else w)


def test_roundtrip_and_retention():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        t = _tree()
        for step in (1, 2, 3, 4):
            mgr.save(step, t, blocking=True)
        assert mgr.all_steps() == [3, 4]
        step, got = mgr.restore(template=t)
        assert step == 4
        _same_bits(got, t)
        assert mgr.restore(3, template=t)[0] == 3


def test_async_save_then_restore():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3)
        t = _tree()
        mgr.save(7, t, blocking=False)
        mgr.wait()
        step, got = mgr.restore(template=t)
        assert step == 7
        _same_bits(got, t)


def test_save_copies_before_the_caller_writes_on():
    """An async save holds the values of its call: the tensors are copied to
    the host before ``save`` returns, so the caller may update them in place
    (the train step does)."""
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t = _tree()
        want = {"a": t["a"].clone()}
        mgr.save(1, {"a": t["a"]})
        t["a"].add_(100.0)
        mgr.wait()
        _same_bits(mgr.restore(template={"a": t["a"]})[1], want)


def test_no_partial_checkpoint_visible():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        os.makedirs(os.path.join(d, "tmp.step_00000009"))
        assert mgr.latest_step() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore(template=_tree())
        mgr.save(1, _tree(), blocking=True)
        assert mgr.latest_step() == 1


def test_restore_refuses_another_tree():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, _tree(), blocking=True)
        with pytest.raises(ValueError, match="keys differ"):
            mgr.restore(template={"a": torch.zeros((3, 4))})


def _jax_tree():
    rng = np.random.default_rng(1)
    return {"a": jnp.asarray(rng.normal(size=(3, 4)), jnp.float32),
            "nested": {"b": jnp.asarray(rng.normal(size=(2, 5)), jnp.bfloat16),
                       "c": jnp.asarray(3, jnp.int32)},
            "blocks": [{"w": jnp.asarray(rng.normal(size=(2, 3)), jnp.bfloat16)}]}


def _jax_as_port(tree):
    """The port's tree of the same values (bf16 through float32, exact)."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree_util.tree_map(one, tree)


def test_jax_checkpoint_restores_in_the_port_bit_for_bit():
    with tempfile.TemporaryDirectory() as d:
        jt = _jax_tree()
        JaxManager(d).save(5, jt, blocking=True)
        template = jax.tree_util.tree_map(torch.zeros_like, _jax_as_port(jt))
        step, got = CheckpointManager(d).restore(template=template)
        assert step == 5
        _same_bits(got, _jax_as_port(jt))


def test_port_checkpoint_restores_in_jax_bit_for_bit():
    with tempfile.TemporaryDirectory() as d:
        jt = _jax_tree()
        CheckpointManager(d).save(6, _jax_as_port(jt), blocking=True)
        step, got = JaxManager(d).restore(template=jt)
        assert step == 6
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jt)):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_manifest_matches_jax_for_an_lm_state():
    """One reduced model's parameters and AdamW state, saved by both
    managers: the same keys in the same order, dtypes and logical axes."""
    cfg = jget_reduced("jamba-v0.1-52b", dtype="bfloat16")
    ptree = JLM.init_params(jax.random.PRNGKey(0), cfg)
    jp, jaxes = JP.values(ptree), JP.axes(ptree)
    jstate = {"params": jp, "opt": JA.init(jp)}
    host = jax.tree_util.tree_map(np.asarray, jstate)
    tstate = {"params": from_jax_lm_params(host["params"]),
              "opt": from_jax_opt_state(host["opt"])}
    taxes = TLM.param_axes(get_reduced("jamba-v0.1-52b", dtype="bfloat16"))
    with tempfile.TemporaryDirectory() as dj, tempfile.TemporaryDirectory() as dt:
        JaxManager(dj).save(1, jstate, axes_tree={"params": jaxes, "opt": None},
                            blocking=True)
        CheckpointManager(dt).save(1, tstate, axes_tree={"params": taxes, "opt": None},
                                   blocking=True)
        mj, mt = (json.load(open(os.path.join(d, "step_00000001", "manifest.json")))
                  for d in (dj, dt))
        assert mt["keys"] == mj["keys"]
        assert mt["dtypes"] == mj["dtypes"] and "bfloat16" in mt["dtypes"].values()
        assert mt["axes"] == mj["axes"]
        assert mt["treedef"] is None and mt["step"] == mj["step"] == 1
        _, got = CheckpointManager(dj).restore(template=tstate)
        _same_bits(got, tstate)


_ELASTIC = r"""
import os
from repro_torch import runtime as RT
from repro_torch.checkpoint.manager import CheckpointManager
from torch.distributed.tensor import DTensor

d = sys.argv[4]
mgr = CheckpointManager(d)
full = torch.arange(64, dtype=torch.float32).reshape(8, 8)
if world == 8:
    mesh = RT.make_mesh((4, 2), ("data", "model"), device="cpu")
    spec = RT.PartitionSpec("data", "model")
    blk = RT.compat.local_block(full, spec, mesh).clone()
    w = DTensor.from_local(blk, mesh.device_mesh, RT.to_placements(spec, mesh),
                           run_check=False)
    mgr.save(5, {"w": w, "b": torch.ones(3)}, axes_tree={"w": ("batch", "mlp")},
             blocking=True)
    print("SAVED", tuple(w.to_local().shape), flush=True)
else:
    # 'node failure': restart on a smaller (2, 2) mesh
    mesh = RT.make_mesh((2, 2), ("data", "model"), device="cpu")
    step, got = mgr.restore(template={"w": torch.zeros(8, 8), "b": torch.zeros(3)},
                            mesh=mesh)
    w2 = got["w"]
    ok = (step == 5 and isinstance(w2, DTensor)
          and torch.equal(w2.full_tensor(), full)
          and tuple(w2.to_local().shape) == (4, 4)
          and torch.equal(w2.to_local(), RT.compat.local_block(
              full, RT.PartitionSpec("data", "model"), mesh))
          and not isinstance(got["b"], DTensor) and torch.equal(got["b"], torch.ones(3)))
    print("RESHARD", "OK" if ok else "BAD", w2.placements, flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def test_elastic_restore_on_different_mesh(tmp_path):
    """Save on a 4x2 mesh (world 8), restore on 2x2 (world 4) by the
    manifest's logical axes: each rank's block and the whole value exact
    (``tests/test_checkpoint.py:55-95``)."""
    from test_torch_distributed import WORLD_PREAMBLE, run_world

    ckpt = tmp_path / "ckpt"
    outs = run_world(WORLD_PREAMBLE + _ELASTIC, 8, tmp_path / "save", args=(ckpt,))
    assert all("SAVED (2, 4)" in o for o in outs), outs
    assert sorted(os.listdir(ckpt)) == ["step_00000005"]
    with open(ckpt / "step_00000005" / "manifest.json") as f:
        assert json.load(f)["axes"] == {"w": ["batch", "mlp"]}
    outs = run_world(WORLD_PREAMBLE + _ELASTIC, 4, tmp_path / "restore", args=(ckpt,))
    assert all(o.startswith("RESHARD OK") for o in outs), outs

"""``repro_torch.runtime`` against ``repro.runtime`` on the CPU, in this
process (no process group):

* ``resolve_spec`` under the default rules and every preset
  (``batch_rules``, ``fsdp_rules``, ``gnn_rules``, ``zero1_rules``) and
  ``zero1_spec``, entry for entry equal to JAX's on one table of (axes,
  shape, mesh shape, rules), which holds the four cases of
  ``tests/test_distributed.py``; both resolve against a mesh that is only
  a shape (JAX's ``FakeMesh``, the port's ``Mesh`` with no process group);
* the rule tables themselves, and ``tree_specs`` on a reduced LM's
  parameter shapes with ``lm.param_axes`` against JAX's on ``Param``
  leaves of the same shapes and axes;
* ``use_mesh`` / ``get_active_mesh`` and ``logical_constraint``'s no-op
  without a mesh and on a 1-rank mesh, as ``tests/test_runtime_compat.py``
  holds them; ``to_placements``; ``row_shard`` of the GNN path.
"""
import numpy as np
import pytest
import torch

from repro import params as JP
from repro.runtime import partitioning as JPT
from repro_torch import runtime as RT
from repro_torch.configs import get_reduced
from repro_torch.models import lm
from repro_torch.runtime import compat
from repro_torch.runtime import partitioning as PT


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "4x2": {"data": 4, "model": 2},
    "flat8": {"data": 8},
    "graph8": {"graph": 8},
}


def _rules(name, mesh, jax_side: bool):
    mod = JPT if jax_side else PT
    if name is None:
        return None
    kind, _, arg = name.partition(":")
    if kind == "batch":
        return mod.batch_rules(mesh, int(arg))
    if kind == "batch_seq":
        return mod.batch_rules(mesh, int(arg), seq_shard=True)
    if kind == "fsdp":
        return mod.fsdp_rules(mesh, int(arg))
    if kind == "gnn":
        return mod.gnn_rules(mesh, axis=arg or "data")
    if kind == "zero1":
        return mod.zero1_rules(mod.fsdp_rules(mesh, 8))
    raise ValueError(name)


# (logical axes, shape, mesh, rules)
CASES = [
    # tests/test_distributed.py:95-132
    (("experts", "embed", "mlp"), (8, 1024, 14336), "16x16", None),
    (("experts", "embed", "mlp"), (128, 1024, 768), "16x16", None),
    (("batch", "seq"), (256, 4096), "2x16x16", None),
    (("batch", "seq"), (1, 4096), "2x16x16", None),
    # presets
    (("batch", "kv_seq", "kv_heads", "head_dim"), (1, 32768, 8, 128), "16x16", "batch:1"),
    (("batch", "kv_seq", "kv_heads", "head_dim"), (128, 32768, 8, 128), "16x16", "batch:128"),
    (("batch", "kv_seq", "kv_heads", "head_dim"), (128, 4096, 2, 128), "16x16", "batch_seq:128"),
    (("batch", "seq", "embed"), (256, 4096, 4096), "16x16", "fsdp:256"),
    (("embed", "mlp"), (4096, 13696), "16x16", "fsdp:256"),
    (("vocab", "embed"), (65024, 4096), "2x16x16", "fsdp:256"),
    (("moe_batch", "experts", "embed"), (512, 8, 4096), "2x16x16", "fsdp:512"),
    (("layers", "embed", "heads_flat"), (28, 4096, 4096), "4x2", "zero1:"),
    (("embed",), (4096,), "4x2", "zero1:"),
    (("nodes", None), (128, 100), "flat8", "gnn:"),
    (("nodes", None), (130, 100), "flat8", "gnn:"),
    ((None, "edges"), (2, 384), "flat8", "gnn:"),
    (("graphs", None), (4, 1), "flat8", "gnn:"),
    (("nodes",), (4096,), "graph8", "gnn:graph"),
    (("inner", "state"), (4096, 16), "4x2", None),
    (("q_lora", "heads", "head_dim"), (768, 40, 96), "16x16", None),
]


@pytest.mark.parametrize("axes,shape,mesh,rules", CASES,
                         ids=[f"{i}-{c[2]}-{c[3]}" for i, c in enumerate(CASES)])
def test_resolve_spec_matches_jax(axes, shape, mesh, rules):
    jmesh = FakeMesh(MESHES[mesh])
    pmesh = compat.Mesh(MESHES[mesh], "cpu")
    want = JPT.resolve_spec(axes, shape, jmesh, _rules(rules, jmesh, True))
    got = PT.resolve_spec(axes, shape, pmesh, _rules(rules, pmesh, False))
    assert isinstance(got, PT.PartitionSpec)
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("rules", [None, "batch:1", "batch:128", "fsdp:256",
                                   "gnn:", "zero1:"])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_rule_tables_match_jax(rules, mesh):
    jmesh = FakeMesh(MESHES[mesh])
    want = _rules(rules, jmesh, True) or JPT.DEFAULT_RULES
    got = _rules(rules, compat.Mesh(MESHES[mesh], "cpu"), False) or PT.DEFAULT_RULES
    assert got == want


@pytest.mark.parametrize("spec,shape,mesh", [
    ((None, "model"), (8, 1024), "4x2"),
    (("model", None), (8, 1024), "4x2"),
    ((None, None), (7, 1024), "4x2"),
    ((("pod", "data"), None), (64, 3), "2x16x16"),
    ((None, None), (64, 3), "graph8"),
])
def test_zero1_spec_matches_jax(spec, shape, mesh):
    from jax.sharding import PartitionSpec as JSpec

    want = JPT.zero1_spec(JSpec(*spec), shape, FakeMesh(MESHES[mesh]))
    got = PT.zero1_spec(PT.PartitionSpec(*spec), shape, compat.Mesh(MESHES[mesh], "cpu"))
    assert tuple(got) == tuple(want)


def test_gnn_rules_check_the_axis():
    with pytest.raises(ValueError, match="not on mesh"):
        PT.gnn_rules(compat.Mesh({"data": 2}, "cpu"), axis="graph")


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mixtral-8x7b"])
def test_tree_specs_match_jax(arch):
    """The port's axes tree beside plain tensors resolves as JAX's Param
    tree does."""
    cfg = get_reduced(arch)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    axes = lm.param_axes(cfg)
    mesh = MESHES["4x2"]

    def to_jax(tree, ax):
        if isinstance(tree, dict):
            return {k: to_jax(v, ax[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_jax(v, a) for v, a in zip(tree, ax)]
        return JP.Param(np.zeros(tuple(tree.shape), np.float32), ax)

    rules_j = JPT.fsdp_rules(FakeMesh(mesh), 8)
    want = JPT.tree_specs(to_jax(params, axes), FakeMesh(mesh), rules_j)
    pmesh = compat.Mesh(mesh, "cpu")
    got = PT.tree_specs(params, axes, pmesh, PT.fsdp_rules(pmesh, 8))

    def flat(tree, prefix=""):
        if isinstance(tree, (dict, list)):
            out = {}
            items = tree.items() if isinstance(tree, dict) else enumerate(tree)
            for k, v in items:
                out.update(flat(v, f"{prefix}/{k}"))
            return out
        return {prefix: tuple(tree)}

    assert flat(got) == flat(want)


def test_tree_shardings_are_the_specs_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = compat.Mesh({"data": 4, "model": 2}, "cpu")
    tree = {"w": torch.zeros(8, 6), "b": [torch.zeros(6)], "n": torch.zeros(3)}
    axes = {"w": ("batch", "mlp"), "b": [("mlp",)], "n": None}
    got = PT.tree_shardings(tree, axes, mesh)
    assert got == {"w": [Shard(0), Shard(1)], "b": [[Replicate(), Shard(0)]],
                   "n": [Replicate(), Replicate()]}


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = compat.Mesh({"pod": 2, "data": 4, "model": 2}, "cpu")
    got = PT.to_placements(PT.PartitionSpec(("pod", "data"), None, "model"), mesh)
    assert got == [Shard(0), Shard(0), Shard(2)]
    assert PT.to_placements(PT.PartitionSpec(None, None), mesh) == [Replicate()] * 3


def test_get_active_mesh_follows_use_mesh():
    assert RT.get_active_mesh() is None
    mesh = RT.make_mesh((1,), ("data",), device="cpu")
    assert dict(mesh.shape) == {"data": 1} and mesh.size == 1
    with RT.use_mesh(mesh):
        got = RT.get_active_mesh()
        assert got is mesh and dict(got.shape) == {"data": 1}
        inner = compat.Mesh({"graph": 1}, "cpu")
        with RT.use_mesh(inner):
            assert RT.get_active_mesh() is inner
        assert RT.get_active_mesh() is mesh
    assert RT.get_active_mesh() is None


def test_make_mesh_needs_a_process_group_past_one_rank():
    with pytest.raises(RuntimeError, match="process group"):
        RT.make_mesh((2,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        RT.make_mesh((1, 1), ("data",), device="cpu")


def test_logical_constraint_noop_without_mesh():
    x = torch.ones(4, 4)
    assert RT.logical_constraint(x, ("batch", None)) is x


def test_logical_constraint_noop_on_single_device_mesh():
    mesh = RT.make_mesh((1,), ("data",), device="cpu")
    x = torch.ones(4, 4)
    with RT.use_mesh(mesh):
        assert RT.logical_constraint(x, ("batch", None)) is x


def test_shard_map_on_one_rank_passes_blocks_whole():
    mesh = RT.make_mesh((1,), ("d",), device="cpu")
    fn = RT.shard_map(lambda x: x * 2.0, mesh, in_specs=RT.PartitionSpec("d"),
                      out_specs=RT.PartitionSpec("d"))
    np.testing.assert_array_equal(fn(torch.arange(4.0)).numpy(), np.arange(4.0) * 2)


def test_row_shard_only_under_a_sharding_mesh():
    assert PT.row_shard(128) is None
    with RT.use_mesh(RT.make_mesh((1,), ("data",), device="cpu")):
        assert PT.row_shard(128) is None


def test_flatten_and_production_shapes():
    flat = RT.flatten_mesh(compat.Mesh({"data": 1, "model": 1}, "cpu"), axis="graph")
    assert flat.shape == {"graph": 1}
    assert RT.mesh.PRODUCTION_SHAPES[True] == ((2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(RuntimeError, match="process group"):
        RT.make_production_mesh(device="cpu")

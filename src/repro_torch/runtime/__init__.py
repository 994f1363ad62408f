"""repro_torch.runtime: the multi-rank execution substrate on
``torch.distributed`` (port of ``repro.runtime``).

  * ``compat``       the mesh surface (make_mesh, shard_map, use_mesh,
                     get_active_mesh) over ``DeviceMesh``
  * ``mesh``         production / debug / flat mesh builders
  * ``partitioning`` logical-axis rules, PartitionSpec resolution,
                     logical_constraint, sharded message passing; and
                     the DTensor placing of a parameter tree and a
                     batch (``place_tree`` / ``place_batch``: JAX's
                     ``device_put`` by ``tree_shardings`` and its
                     global batch arrays, which need no name of their
                     own there)

JAX's facade also exports ``HAS_SERIALIZE_EXECUTABLE``,
``serialize_compiled``, ``deserialize_compiled`` and
``enable_compilation_cache``, which have no CUDA meaning (``compat``'s
docstring says what takes their place).
"""
from repro_torch.runtime import compat, mesh, partitioning
from repro_torch.runtime.compat import (
    Mesh,
    get_active_mesh,
    make_mesh,
    mesh_from_devices,
    shard_map,
    use_mesh,
)
from repro_torch.runtime.mesh import (
    flatten_mesh,
    make_debug_mesh,
    make_flat_mesh,
    make_production_mesh,
)
from repro_torch.runtime.partitioning import (
    DEFAULT_RULES,
    PartitionSpec,
    active_rules,
    allgather_mp_local,
    alltoall_mp_local,
    batch_rules,
    fsdp_rules,
    gnn_rules,
    logical_constraint,
    make_sharded_mp,
    place_batch,
    place_tree,
    resolve_spec,
    to_placements,
    tree_shardings,
    tree_specs,
    zero1_rules,
    zero1_spec,
)

__all__ = [
    "compat",
    "mesh",
    "partitioning",
    "Mesh",
    "get_active_mesh",
    "make_mesh",
    "mesh_from_devices",
    "shard_map",
    "use_mesh",
    "flatten_mesh",
    "make_debug_mesh",
    "make_flat_mesh",
    "make_production_mesh",
    "DEFAULT_RULES",
    "PartitionSpec",
    "active_rules",
    "allgather_mp_local",
    "alltoall_mp_local",
    "batch_rules",
    "fsdp_rules",
    "gnn_rules",
    "logical_constraint",
    "make_sharded_mp",
    "place_batch",
    "place_tree",
    "resolve_spec",
    "to_placements",
    "tree_shardings",
    "tree_specs",
    "zero1_rules",
    "zero1_spec",
]

"""Mesh construction (port of ``repro.runtime.mesh``).

Functions, not module-level constants, so importing this module touches
no process group.  Each builds a ``compat.Mesh`` over the ranks of the
default process group, which must have the mesh's size (a 1-rank mesh
needs none).

Single pod: 16x16 = 256 ranks (data x model).
Multi-pod:  2x16x16 = 512 ranks (pod x data x model).
``PRODUCTION_SHAPES`` keeps both as shapes for a dry run that resolves
specs without a process group of that size (``compat.Mesh`` built
directly).
"""
from __future__ import annotations

from repro_torch.runtime import compat

PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> compat.Mesh:
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return compat.make_mesh(shape, axes, device=device)


def make_debug_mesh(data: int = 2, model: int = 2, device="cuda") -> compat.Mesh:
    """Small (data, model) mesh for the distributed tests."""
    return compat.make_mesh((data, model), ("data", "model"), device=device)


def make_flat_mesh(n: int | None = None, axis: str = "data",
                   device="cuda") -> compat.Mesh:
    """One-axis mesh over ``n`` ranks (default: the whole world): the shape
    of the sharded GNN serving path, where one graph axis spans every
    rank."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    return compat.make_mesh((world if n is None else n,), (axis,), device=device)


def flatten_mesh(mesh: compat.Mesh, axis: str = "graph") -> compat.Mesh:
    """Collapse a multi-axis mesh into one named axis over the same ranks
    (e.g. production (data, model) -> one 'graph' axis)."""
    if mesh.device_mesh is None:
        return compat.Mesh({axis: mesh.size}, mesh.device_type)
    return compat.mesh_from_devices(mesh.device_mesh.mesh.reshape(-1), (axis,),
                                    device=mesh.device_type)

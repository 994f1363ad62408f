"""The mesh surface of the port on ``torch.distributed`` (port of
``repro.runtime.compat``).

JAX runs a mesh in one process over several devices; PyTorch runs one
process per rank.  A :class:`Mesh` here names the axes of a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, and every function that takes a mesh runs on each
rank for that rank's part:

  * ``make_mesh`` / ``mesh_from_devices`` build a mesh over the ranks
    (``init_device_mesh`` / ``DeviceMesh``); a 1-rank mesh needs no
    process group, a larger one raises without one;
  * ``use_mesh`` / ``get_active_mesh`` keep the active mesh in a
    contextvar (JAX's ``jax.set_mesh`` / ``get_abstract_mesh``), ``None``
    outside any ``use_mesh``;
  * ``shard_map(body, mesh, in_specs, out_specs)`` takes global tensors,
    cuts each rank's block by ``in_specs``, runs ``body`` on the blocks
    and all-gathers its outputs by ``out_specs``, so a caller (a test)
    feeds and reads global tensors, as JAX's callers do;
  * ``local_block`` / ``gather_blocks`` are those two cuts, which
    ``partitioning.logical_constraint`` shares.

A spec entry is ``None``, an axis name or a tuple of axis names; a dim
sharded over a tuple is cut major to minor in the tuple's order (JAX's
rule).

Not ported: JAX's version detection (``HAS_*``), because one API serves
every PyTorch this port runs on; ``serialize_compiled`` /
``deserialize_compiled`` and ``enable_compilation_cache``, which have no
CUDA meaning: the port's ``serve/aot.py`` cache of kernel libraries takes
their place (a CUDA graph cannot be serialized).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist


class Mesh:
    """Named axes over ranks.  ``shape`` maps each axis to its size, in
    mesh order (JAX's ``Mesh.shape``); ``device_mesh`` is the
    ``DeviceMesh`` behind it, ``None`` for a 1-rank mesh built without a
    process group (it has no collective to run); ``device_type`` is where
    the ranks keep their tensors ("cuda" or "cpu")."""

    def __init__(self, shape: Dict[str, int], device_type: str,
                 device_mesh=None):
        self.shape = dict(shape)
        self.device_type = device_type
        self.device_mesh = device_mesh

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def empty(self) -> bool:
        return self.size == 0

    def group(self, axis: str):
        """The process group along ``axis`` (None on a 1-rank mesh)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    @property
    def backend(self) -> str:
        """The collective backend ("gloo", "nccl") or "none" for a 1-rank
        mesh without a process group."""
        if self.device_mesh is None:
            return "none"
        return str(dist.get_backend(self.device_mesh.get_group(0)))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, {self.device_type!r}, "
                f"backend={self.backend!r})")


def _device_type(device) -> str:
    return torch.device(device).type


def make_mesh(axis_shapes, axis_names, *, device="cuda") -> Mesh:
    """A mesh of ``axis_shapes`` named ``axis_names`` over the ranks of the
    default process group (``init_device_mesh``), whose size must be the
    mesh's.  A 1-rank mesh needs no process group; a larger one raises
    without one (``torch.distributed.init_process_group`` first)."""
    shape = dict(zip(tuple(axis_names), (int(s) for s in axis_shapes)))
    if len(shape) != len(tuple(axis_shapes)):
        raise ValueError(f"axis names {axis_names} do not match {axis_shapes}")
    dtype = _device_type(device)
    size = math.prod(shape.values())
    if not dist.is_initialized():
        if size == 1:
            return Mesh(shape, dtype)
        raise RuntimeError(
            f"a mesh of {size} ranks needs a process group: call "
            "torch.distributed.init_process_group first"
        )
    world = dist.get_world_size()
    if size != world:
        raise ValueError(f"mesh {shape} has {size} ranks, the world {world}")
    _gloo_cuda_all_gather(dtype)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dtype, tuple(shape.values()),
                          mesh_dim_names=tuple(shape))
    return Mesh(shape, dtype, dm)


def mesh_from_devices(ranks, axis_names, *, device="cuda") -> Mesh:
    """A mesh over an explicit array of ranks (e.g. another mesh's ranks
    reshaped), JAX's ``Mesh(devices, axis_names)``."""
    ranks = torch.as_tensor(ranks, dtype=torch.int64)
    names = tuple(axis_names)
    shape = dict(zip(names, ranks.shape))
    dtype = _device_type(device)
    if not dist.is_initialized():
        if ranks.numel() == 1:
            return Mesh(shape, dtype)
        raise RuntimeError("a mesh of several ranks needs a process group")
    from torch.distributed.device_mesh import DeviceMesh

    _gloo_cuda_all_gather(dtype)
    return Mesh(shape, dtype, DeviceMesh(dtype, ranks, mesh_dim_names=names))


_GLOO_CUDA_LIB = []  # the library that holds the override, once made


def _gloo_cuda_all_gather(device_type: str) -> None:
    """DTensor's collectives are PyTorch's native functional ones.  On a
    gloo group with CUDA tensors the functional all-gather
    (``_c10d_functional::all_gather_into_tensor``) crashes the process in
    its ``wait_tensor`` (torch 2.11 with CUDA 12.8: a segfault; the
    functional all-reduce, reduce-scatter and all-to-all, and gloo's own
    ``all_gather_into_tensor``, run).  Under a gloo default group on CUDA
    its CUDA kernel is replaced, once a process, by gloo's all-gather,
    which returns when the gathered tensor is whole (the op's ``wait_tensor``
    then finds no work to wait for)."""
    if (device_type != "cuda" or _GLOO_CUDA_LIB
            or dist.get_backend() != "gloo"):
        return
    from torch.distributed import distributed_c10d as c10d

    def all_gather_into_tensor(inp, group_size, group_name):
        group = (c10d._resolve_process_group(group_name)
                 if isinstance(group_name, str) else group_name)
        out = inp.new_empty((inp.shape[0] * group_size,) + tuple(inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(), group=group)
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather_into_tensor, "CUDA")
    _GLOO_CUDA_LIB.append(lib)


# ------------------------------------------------------------ active mesh

_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_runtime_mesh", default=None
)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Install ``mesh`` as the active mesh for the dynamic extent."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def get_active_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``use_mesh``, or None."""
    return _ACTIVE_MESH.get()


# ----------------------------------------------------------- block cuts


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _block_index(axes: tuple, mesh: Mesh) -> tuple:
    """(this rank's block, the number of blocks) of a dim cut over
    ``axes``, major to minor."""
    idx, count = 0, 1
    for ax in axes:
        idx = idx * mesh.shape[ax] + mesh.coordinate(ax)
        count *= mesh.shape[ax]
    return idx, count


def local_block(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec`` (a view;
    every sharded dim must divide evenly)."""
    out = x
    for d, entry in enumerate(tuple(spec)):
        axes = _axes(entry)
        if not axes:
            continue
        idx, count = _block_index(axes, mesh)
        size = x.shape[d]
        if size % count:
            raise ValueError(f"dim {d} of size {size} does not divide over "
                             f"{axes} ({count} blocks)")
        step = size // count
        out = out.narrow(d, idx * step, step)
    return out


def gather_blocks(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """Inverse of :func:`local_block`: the global tensor from every rank's
    block (all-gathers along each sharded dim, minor axis first)."""
    out = x
    for d, entry in enumerate(tuple(spec)):
        for ax in reversed(_axes(entry)):
            group = mesh.group(ax)
            if group is None or mesh.shape[ax] == 1:
                continue
            moved = out.movedim(d, 0).contiguous()
            full = moved.new_empty((moved.shape[0] * mesh.shape[ax],)
                                   + tuple(moved.shape[1:]))
            dist.all_gather_into_tensor(full, moved, group=group)
            out = full.movedim(0, d)
    return out.contiguous()


def _as_specs(specs, n: int) -> tuple:
    """A single spec (a ``PartitionSpec`` or None) for every one of ``n``
    values, or the given sequence of specs."""
    from repro_torch.runtime.partitioning import PartitionSpec

    if specs is None or isinstance(specs, PartitionSpec):
        return (specs,) * n
    specs = tuple(specs)
    if len(specs) != n:
        raise ValueError(f"{len(specs)} specs for {n} values")
    return specs


def shard_map(f: Callable, mesh: Mesh, in_specs, out_specs) -> Callable:
    """``fn(*global_tensors)``: each rank runs ``f`` on its blocks (cut by
    ``in_specs``; a None spec passes the value whole) and gets the global
    outputs back (all-gathered by ``out_specs``; a None spec returns the
    rank's own output, unchecked against the other ranks', as JAX's
    ``check_replication=False``).  ``f`` runs its own collectives over
    ``mesh.group(axis)``."""

    def fn(*args):
        specs = _as_specs(in_specs, len(args))
        local = [a if s is None or not isinstance(a, torch.Tensor)
                 else local_block(a, s, mesh) for a, s in zip(args, specs)]
        out = f(*local)
        single = isinstance(out, torch.Tensor)
        outs = (out,) if single else tuple(out)
        ospecs = _as_specs(out_specs, len(outs))
        outs = tuple(o if s is None else gather_blocks(o, s, mesh)
                     for o, s in zip(outs, ospecs))
        return outs[0] if single else outs

    return fn


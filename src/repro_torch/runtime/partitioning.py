"""Logical-axis -> mesh-axis resolution, sharding rules, and the sharded
message-passing collectives (port of ``repro.runtime.partitioning``).

Model code names every parameter / cache / activation dimension with a
*logical* axis.  ``resolve_spec`` turns those names into a
``PartitionSpec`` for a mesh through a rules table, as JAX does:

  * a mesh axis is used at most once per tensor,
  * a dim is only sharded if its size divides evenly,
  * multi-axis rules (("pod", "data") for batch) use the largest prefix
    that divides.

A ``PartitionSpec`` here is a tuple of ``None`` / axis name / tuple of
axis names, equal to JAX's entry for entry.  ``to_placements`` turns one
into DTensor ``Shard`` / ``Replicate`` placements.

``logical_constraint`` is JAX's sharding constraint: without a mesh, or
on a 1-rank mesh, it returns its input; under a mesh it redistributes a
DTensor to the resolved spec's placements (the LM's train step) and
cuts a plain global tensor to this rank's block (the sharded GNN path);
a dim whose size does not divide stays whole (JAX's divisibility
fallback).  ``place_tree`` / ``place_batch`` put global parameters and
batches on a mesh as DTensors, ``mesh_scope`` is a step's context on a
mesh, and ``local_blocks`` runs what DTensor has no strategy for on each
rank's blocks.

The sharded message passing of the paper's large-graph extension (§4.6)
runs over a ``ProcessGroup``: ``allgather_mp_local`` (all-gather the
node rows, aggregate the local edges into the global frame,
reduce-scatter the rows back to their owners) and ``alltoall_mp_local``
(GenGNN's merged scatter-gather lifted to ranks: messages packed into
per-destination-rank capacity slots by ``core.scatter_gather.
dispatch_to_slots``, one ``all_to_all_single``, folded into the local
rows).  ``make_sharded_mp`` wraps either in ``compat.shard_map``.  Both
ran on the card over gloo (two ranks on one card) and over NCCL (one
rank) with torch 2.11: every collective here takes CUDA tensors on both.

The serving path's sharded GNN layer (``core/message_passing.py``) owns
destination rows instead of edges and gathers its source rows through
``all_gather_rows``; ``collective_bytes`` counts what each rank receives
through these helpers, by collective.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.runtime import compat

# Candidate mesh axes per logical axis, in priority order (JAX's table).
DEFAULT_RULES: Dict[Optional[str], tuple] = {
    "batch": ("pod", "data"),
    "seq": (),
    "kv_seq": (),  # overridden to ("data",) for seq-sharded long decode
    "vocab": ("model",),
    "embed": (),
    "embed_out": (),
    "heads": ("model",),
    "heads_flat": ("model",),
    "kv_heads": ("model",),
    # head_dim stays unsharded: a KV projection narrower than the model
    # axis is replicated (Megatron convention)
    "head_dim": (),
    "mlp": ("model",),
    "experts": ("model",),
    "moe_batch": ("pod", "data"),
    "inner": ("model",),  # mamba d_inner
    "state": (),
    "q_lora": (),
    "kv_lora": (),
    "layers": (),
    # GNN serving: padded node / edge / graph rows (see gnn_rules)
    "nodes": (),
    "edges": (),
    "graphs": (),
    None: (),
}

# bytes of the other ranks' blocks that each rank receives through the
# helpers below, by collective: the logical exchange (an all-gather's
# P - 1 foreign blocks, a reduce-scatter's or all-reduce's P - 1 partial
# results), not what the backend's protocol puts on the wire
collective_bytes: Dict[str, int] = {"all_gather": 0, "reduce_scatter": 0,
                                    "all_to_all": 0, "all_reduce": 0}


def reset_collective_bytes() -> None:
    for k in collective_bytes:
        collective_bytes[k] = 0


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def resolve_spec(
    axes: Tuple[Optional[str], ...],
    shape: Tuple[int, ...],
    mesh,
    rules: Dict[Optional[str], tuple] | None = None,
) -> PartitionSpec:
    """Map one tensor's logical axes to a PartitionSpec under ``mesh``
    (anything with a ``shape`` mapping of axis sizes)."""
    rules = rules or DEFAULT_RULES
    used: set = set()
    spec = []
    for dim, name in zip(shape, axes):
        cands = rules.get(name, ())
        chosen: list = []
        prod = 1
        for ax in cands:
            if ax not in mesh.shape or ax in used:
                continue
            nx = mesh.shape[ax]
            if dim % (prod * nx) == 0:
                chosen.append(ax)
                prod *= nx
        if chosen:
            used.update(chosen)
            spec.append(tuple(chosen) if len(chosen) > 1 else chosen[0])
        else:
            spec.append(None)
    return PartitionSpec(*spec)


def to_placements(spec, mesh: compat.Mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that cuts tensor dim ``d``, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.axis_names
    out = [Replicate() for _ in names]
    for d, entry in enumerate(tuple(spec)):
        for ax in compat._axes(entry):
            out[names.index(ax)] = Shard(d)
    return out


def _map_with_axes(fn, tree, axes_tree):
    """``fn(leaf, axes)`` over a tree of tensors and its axes tree (leaves
    tuples; a None subtree for leaves without axes)."""
    if isinstance(tree, dict):
        return {k: _map_with_axes(fn, v, None if axes_tree is None else axes_tree.get(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(axes_tree, tuple):
        return type(tree)(_map_with_axes(fn, v, None if axes_tree is None else axes_tree[i])
                          for i, v in enumerate(tree))
    return fn(tree, axes_tree)


def _leaf_spec(leaf, axes, mesh, rules) -> PartitionSpec:
    if axes is None:
        return PartitionSpec(*([None] * leaf.dim()))
    return resolve_spec(axes, tuple(leaf.shape), mesh, rules)


def tree_specs(param_tree, axes_tree, mesh, rules=None):
    """Param tree (+ its logical axes, ``models.lm.param_axes``) -> tree of
    PartitionSpecs.  JAX's trees carry the axes on their ``Param``
    leaves; the port's parameters are plain tensors, so the axes come as a
    tree beside them.  A leaf without axes is replicated."""
    return _map_with_axes(lambda leaf, axes: _leaf_spec(leaf, axes, mesh, rules),
                          param_tree, axes_tree)


def tree_shardings(param_tree, axes_tree, mesh: compat.Mesh, rules=None):
    """Param tree -> matching tree of DTensor placements (JAX's
    ``NamedSharding`` tree)."""
    return _map_with_axes(
        lambda leaf, axes: to_placements(_leaf_spec(leaf, axes, mesh, rules), mesh),
        param_tree, axes_tree)


def batch_rules(mesh, batch: int, seq_shard: bool = False) -> dict:
    """Shape-aware rules for activations / caches: when the global batch
    cannot cover the data axis (long-context decode, batch=1), shard the
    KV-cache sequence dimension over data instead."""
    rules = dict(DEFAULT_RULES)
    dp = 1
    for a in ("pod", "data"):
        dp *= mesh.shape.get(a, 1)
    if batch % dp != 0 or seq_shard:
        rules["batch"] = ()
        rules["kv_seq"] = ("data",)
    return rules


def fsdp_rules(mesh, batch: int) -> dict:
    """FSDP-style preset: data parallelism over every mesh axis, weight
    matrices sharded over the model axis on their embed dim."""
    rules = dict(DEFAULT_RULES)
    rules["batch"] = ("pod", "data", "model")
    rules["moe_batch"] = ("pod", "data", "model")
    rules["embed"] = ("model",)
    rules["kv_seq"] = ()
    return rules


def gnn_rules(mesh=None, axis: str = "data") -> dict:
    """GNN serving preset: padded node / edge rows and the per-graph pool
    axis shard over ``axis``; a bucket whose padded sizes do not divide
    the axis stays replicated.  ``mesh`` (optional) validates that
    ``axis`` exists on it."""
    if mesh is not None and axis not in mesh.shape:
        raise ValueError(f"axis {axis!r} not on mesh (axes: {tuple(mesh.shape)})")
    rules = dict(DEFAULT_RULES)
    rules["nodes"] = (axis,)
    rules["edges"] = (axis,)
    rules["graphs"] = (axis,)
    return rules


def zero1_spec(spec, shape, mesh, axis: str = "data") -> PartitionSpec:
    """ZeRO-1: shard an optimizer-moment tensor over ``axis`` on its first
    dim that is unsharded and divisible, on top of the parameter's own
    sharding."""
    if axis not in mesh.shape:
        return PartitionSpec(*spec)
    used = set()
    for s in spec:
        used.update(compat._axes(s))
    if axis in used:
        return PartitionSpec(*spec)
    n = mesh.shape[axis]
    out = list(spec)
    for i, (dim, s) in enumerate(zip(shape, spec)):
        if s is None and dim % n == 0:
            out[i] = axis
            return PartitionSpec(*out)
    return PartitionSpec(*spec)


def zero1_rules(base_rules: dict) -> dict:
    """ZeRO-1-style optimizer-state rules: moments additionally shard
    their embed / layers dims over the data axis."""
    rules = dict(base_rules)
    for name in ("embed", "layers"):
        if not rules.get(name):
            rules[name] = ("data",)
    return rules


_ACTIVE_RULES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sharding_rules", default=None
)


@contextlib.contextmanager
def active_rules(rules: dict):
    """Install shape-aware rules for :func:`logical_constraint` (set by
    launchers and the executor together with ``compat.use_mesh``)."""
    token = _ACTIVE_RULES.set(rules)
    try:
        yield
    finally:
        _ACTIVE_RULES.reset(token)


def current_rules() -> dict:
    return _ACTIVE_RULES.get() or DEFAULT_RULES


@contextlib.contextmanager
def mesh_scope(mesh, rules: dict | None = None):
    """A step on a mesh of DTensors: JAX's ``use_mesh`` + ``active_rules``
    (``rules`` or ``DEFAULT_RULES``), with plain tensors (constants, RoPE
    angles, masks) taken as replicated DTensors (DTensor's implicit
    replication, its previous setting restored on exit, so scopes nest);
    nothing without a mesh."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    implicit = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        with compat.use_mesh(mesh), active_rules(rules if rules is not None
                                                 else DEFAULT_RULES):
            yield
    finally:
        dispatcher._allow_implicit_replication = implicit


def in_this_scope(fn: Callable) -> Callable:
    """``fn`` made to run in the :func:`mesh_scope` active now, from any
    thread: remat's recompute runs inside the backward pass, which on the
    card runs in autograd's device thread, where the mesh and rules
    contextvars are unset.  ``fn`` itself outside a mesh."""
    mesh, rules = compat.get_active_mesh(), _ACTIVE_RULES.get()
    if mesh is None:
        return fn

    def run(*args, **kwargs):
        with mesh_scope(mesh, rules):
            return fn(*args, **kwargs)

    return run


def logical_constraint(x: torch.Tensor, axes: Tuple[Optional[str], ...]) -> torch.Tensor:
    """JAX's sharding constraint by logical axes under the active mesh and
    rules: a DTensor is redistributed to the placements the axes resolve
    to (JAX's ``with_sharding_constraint``); a plain tensor, taken as the
    global value every rank holds, gives this rank's block of it.  ``x``
    itself without a mesh or on a 1-rank mesh."""
    mesh = compat.get_active_mesh()
    if mesh is None or mesh.empty or mesh.size == 1:
        return x
    return constrain(x, resolve_spec(axes, tuple(x.shape), mesh, current_rules()), mesh)


def constrain(x: torch.Tensor, spec, mesh: compat.Mesh) -> torch.Tensor:
    """``x`` under an already resolved ``spec``: a DTensor redistributed to
    its placements, a plain (global) tensor cut to this rank's block."""
    if _is_dtensor(x):
        placements = to_placements(spec, mesh)
        if list(x.placements) == placements:
            return x
        if not any(p.is_partial() for p in x.placements):
            return x.redistribute(mesh.device_mesh, placements)
        return _Constrain.apply(x, placements)
    return compat.local_block(x, spec, mesh)


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements``; on a mesh dim where it was
    a partial sum its gradient keeps the output's placement (JAX's
    transpose of a constraint: the gradient of a sum is whole), on every
    other dim it goes back to the input's, as DTensor's own backward moves
    it.  DTensor's backward would make a whole gradient partial again
    where the forward summed, and the next contraction's backward would
    all-reduce it once more."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = [out if inp.is_partial() else inp
                          for inp, out in zip(x.placements, placements)]
        return x.redistribute(placements=placements)

    @staticmethod
    def backward(ctx, grad):
        if list(grad.placements) != ctx.placements:
            grad = grad.redistribute(placements=ctx.placements)
        return grad, None


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def place(x: torch.Tensor, spec, mesh: compat.Mesh) -> torch.Tensor:
    """The global tensor ``x`` (every rank holds the same) as a DTensor on
    ``mesh`` under ``spec``: each rank keeps its own block, nothing is
    exchanged.  ``x`` itself on a mesh without a process group (1 rank).
    On a CUDA mesh the block goes to this rank's card."""
    if mesh.device_mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    local = compat.local_block(x, spec, mesh).contiguous()
    if mesh.device_type == "cuda":
        local = local.to(torch.device("cuda", torch.cuda.current_device()))
    return DTensor.from_local(local, mesh.device_mesh, to_placements(spec, mesh),
                              run_check=False, shape=x.shape, stride=x.stride())


def place_tree(tree, axes_tree, mesh: compat.Mesh, rules=None):
    """A tree of global tensors (parameters, moments) as DTensors placed by
    ``tree_specs`` (JAX's ``device_put(values, tree_shardings(...))``); a
    leaf without axes is replicated.  The tree itself without a mesh or on
    a mesh without a process group."""
    if mesh is None or mesh.device_mesh is None:
        return tree
    return _map_with_axes(lambda leaf, axes: place(leaf, _leaf_spec(leaf, axes, mesh, rules),
                                                   mesh), tree, axes_tree)


def reduce_over_world(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The reduction (``op`` "sum" or "max") of each rank's plain tensor
    ``x`` over every rank of the world (a train step's mesh spans it:
    ``make_mesh``), as a new plain tensor: the norm and the scales of a
    sharded train step, each batched into one vector, one all-reduce."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
    return out


def mesh_world_group(device_mesh):
    """The process group of every rank of ``device_mesh``: the default
    group, which a train step's mesh spans (``make_mesh``)."""
    if device_mesh.size() != dist.get_world_size():
        raise ValueError(f"a mesh of {device_mesh.size()} ranks in a world of "
                         f"{dist.get_world_size()}: a step's mesh spans the world")
    return dist.group.WORLD


# a bucket's bytes at most (one parameter larger than this is a bucket alone)
GRAD_BUCKET_BYTES = 256 << 20


def _grad_plan(grad, param):
    """What reduces DTensor ``grad`` to ``param``'s placements: a tuple with
    one entry per mesh dim, None (nothing to do), ("ar",) (a partial sum
    made whole), ("rs", d) (a partial sum cut on tensor dim d) or ("cut",
    d) (a whole value cut on d); None for any other move (left to
    DTensor)."""
    plan = []
    for i, (g, p) in enumerate(zip(grad.placements, param.placements)):
        summed = g.is_partial() and getattr(g, "reduce_op", "sum") == "sum"
        even = p.is_shard() and param.shape[p.dim] % param.device_mesh.size(i) == 0
        if g == p:
            plan.append(None)
        elif summed and p.is_replicate():
            plan.append(("ar",))
        elif summed and even:
            plan.append(("rs", p.dim))
        elif g.is_replicate() and even:
            plan.append(("cut", p.dim))
        else:
            return None
    return tuple(plan)


def _reduce_scatter_bucket(ts: list, dims: list, group, n: int, rank: int) -> list:
    """Each tensor of ``ts`` summed over ``group``'s ``n`` ranks and cut in
    ``n`` along its dim of ``dims``: one reduce-scatter of a flat buffer
    laid out rank by rank (rank r's blocks of every tensor together)."""
    pieces = [t.chunk(n, d) for t, d in zip(ts, dims)]
    flat = torch.cat([p[r].reshape(-1) for r in range(n) for p in pieces])
    out = flat.new_empty(flat.numel() // n)
    dist.reduce_scatter_tensor(out, flat, group=group)
    res, a = [], 0
    for p in pieces:
        shape = p[rank].shape
        res.append(out[a:a + p[rank].numel()].view(shape))
        a += p[rank].numel()
    return res


def _all_reduce_bucket(ts: list, group) -> list:
    """Each tensor of ``ts`` summed over ``group``: one all-reduce of their
    concatenation."""
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, group=group)
    res, a = [], 0
    for t in ts:
        res.append(flat[a:a + t.numel()].view(t.shape))
        a += t.numel()
    return res


def reduce_gradients(grads: list, params: list) -> list:
    """``grads`` (DTensors, partial sums where autograd left them) at their
    ``params``' placements, in a few flat buckets (DDP's and FSDP's, XLA's
    combined all-reduces): the gradients that need the same collectives
    (dtype, and on each mesh dim the same move) go into buckets of up to
    ``GRAD_BUCKET_BYTES``, and each bucket takes one collective a mesh
    dim: a reduce-scatter where the parameter is cut on that dim, then an
    all-reduce over the dims where it is whole (one over the world when
    that is every dim).  A whole gradient is cut locally.  A gradient
    already at its placements, or a plain one, is returned as it is; any
    other move is left to DTensor's ``redistribute``."""
    from torch.distributed.tensor import DTensor

    out = list(grads)
    groups: Dict[tuple, list] = {}
    for i, (g, p) in enumerate(zip(grads, params)):
        if not (isinstance(g, DTensor) and isinstance(p, DTensor)):
            continue
        if tuple(g.placements) == tuple(p.placements):
            continue
        plan = _grad_plan(g, p)
        if plan is None:
            out[i] = g.redistribute(p.device_mesh, p.placements)
            continue
        groups.setdefault((g.dtype, tuple(op[0] if op else None for op in plan)), []).append(
            (i, plan))
    for (_, kinds), members in groups.items():
        buckets, size = [[]], 0
        for i, plan in members:
            nbytes = grads[i].to_local().numel() * grads[i].element_size()
            if buckets[-1] and size + nbytes > GRAD_BUCKET_BYTES:
                buckets.append([])
                size = 0
            buckets[-1].append((i, plan))
            size += nbytes
        for bucket in buckets:
            _reduce_bucket(bucket, kinds, grads, params, out)
    return out


def _reduce_bucket(bucket: list, kinds: tuple, grads: list, params: list, out: list) -> None:
    from torch.distributed.tensor import DTensor

    mesh = params[bucket[0][0]].device_mesh
    ts = [grads[i].to_local() for i, _ in bucket]
    for dim, kind in enumerate(kinds):
        n, rank = mesh.size(dim), mesh.get_local_rank(dim)
        if kind == "cut":
            ts = [t.chunk(n, plan[dim][1])[rank] for t, (_, plan) in zip(ts, bucket)]
        elif kind == "rs":
            ts = _reduce_scatter_bucket(ts, [plan[dim][1] for _, plan in bucket],
                                        mesh.get_group(dim), n, rank)
    ar = [dim for dim, kind in enumerate(kinds) if kind == "ar"]
    if len(ar) == mesh.ndim and len(ar) > 1:
        ts = _all_reduce_bucket(ts, mesh_world_group(mesh))
    else:
        for dim in ar:
            ts = _all_reduce_bucket(ts, mesh.get_group(dim))
    for t, (i, _) in zip(ts, bucket):
        p = params[i]
        out[i] = DTensor.from_local(t, mesh, p.placements, run_check=False,
                                    shape=p.shape, stride=p.stride())


def local_blocks(fn: Callable, like, dims: tuple, args: tuple, in_dims: tuple,
                 out_dims: tuple):
    """``fn(*args)`` under ``local_map`` on each rank's block of the tensor
    dims ``fn`` is independent in (``dims`` of DTensor ``like``: the rows
    of an MoE dispatch, the batch and channels of a recurrence), as they
    are cut in ``like``; whole on every other mesh dim.  ``in_dims`` /
    ``out_dims`` give each argument's / output's dims in the order of
    ``dims`` (None: a non-tensor argument).  An input cut on fewer of them
    than ``like`` (Mamba's c, shared by the channels) gets a partial
    gradient on the mesh dims it misses."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    cut = [next((i for i, d in enumerate(dims) if pl == Shard(d)), None)
           for pl in like.placements]

    def at(tdims, grad=False):
        if tdims is None:
            return None
        return [Shard(tdims[c]) if c is not None and c < len(tdims)
                else Partial() if grad and c is not None else Replicate() for c in cut]

    return local_map(fn, out_placements=tuple(at(d) for d in out_dims),
                     in_placements=tuple(at(d) for d in in_dims),
                     in_grad_placements=tuple(at(d, grad=True) for d in in_dims),
                     device_mesh=like.device_mesh, redistribute_inputs=True)(*args)


# logical axes of a training batch's entries (JAX's ``_device_batch`` makes
# each a global array; under the mesh its constraints shard it so)
BATCH_AXES = {"tokens": ("batch", "seq"), "patches": ("batch", None, None),
              "frames": ("batch", None, None)}


def place_batch(batch: dict, mesh: compat.Mesh, rules=None) -> dict:
    """A numpy (or tensor) batch, the same global batch on every rank, as
    DTensors placed by ``BATCH_AXES`` on ``mesh`` (a mesh of several ranks;
    JAX's ``_device_batch`` makes global arrays too)."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
        out[k] = place(t, resolve_spec(BATCH_AXES[k], tuple(t.shape), mesh, rules), mesh)
    return out


# ---------------------------------------------------------------------------
# collectives over a ProcessGroup, counted by the bytes each rank receives
# ---------------------------------------------------------------------------


def _alone(num_shards: int) -> bool:
    """A 1-rank mesh without a process group: nothing to exchange.  With
    one, even a 1-rank group runs the collective (its backend's call path
    runs)."""
    return num_shards == 1 and not dist.is_initialized()


def _count(kind: str, t: torch.Tensor, share: float) -> None:
    collective_bytes[kind] += int(t.numel() * t.element_size() * share)


def all_gather_rows(x: torch.Tensor, group, num_shards: int) -> torch.Tensor:
    """(n, ...) on each rank -> (num_shards * n, ...) in rank order."""
    x = x.contiguous()
    if _alone(num_shards):
        return x
    out = x.new_empty((x.shape[0] * num_shards,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    _count("all_gather", out, (num_shards - 1) / num_shards)
    return out


def reduce_scatter_rows(x: torch.Tensor, group, num_shards: int) -> torch.Tensor:
    """(num_shards * n, ...) on each rank -> this rank's (n, ...) block of
    the sum over ranks."""
    x = x.contiguous()
    if _alone(num_shards):
        return x
    out = x.new_empty((x.shape[0] // num_shards,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    _count("reduce_scatter", out, num_shards - 1)
    return out


def all_to_all_rows(x: torch.Tensor, group, num_shards: int) -> torch.Tensor:
    """Block p of dim 0 goes to rank p; block p of the result came from it."""
    x = x.contiguous()
    if _alone(num_shards):
        return x
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    _count("all_to_all", out, (num_shards - 1) / num_shards)
    return out


def all_reduce(x: torch.Tensor, group, num_shards: int,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of ``x`` over ranks (a new tensor)."""
    out = x.contiguous().clone()
    if _alone(num_shards):
        return out
    dist.all_reduce(out, op=op, group=group)
    _count("all_reduce", out, num_shards - 1)
    return out


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's even block of a padded row axis of ``n`` rows: rows
    ``[row0, row0 + n_local)``, block ``index`` of ``num_shards`` on
    ``group``."""

    group: object
    num_shards: int
    index: int
    n: int

    @property
    def n_local(self) -> int:
        return self.n // self.num_shards

    @property
    def row0(self) -> int:
        return self.index * self.n_local

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global (n, ...) tensor."""
        return x.narrow(0, self.row0, self.n_local)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's (n_local, ...) rows -> the global (n, ...) tensor."""
        return all_gather_rows(x, self.group, self.num_shards)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks."""
        return all_reduce(x, self.group, self.num_shards)


def row_shard(n: int, axis: Optional[str] = "nodes") -> Optional[RowShard]:
    """The shard of a padded row axis of ``n`` rows (logical name ``axis``)
    under the active mesh and rules; None when it stays whole: no mesh, a
    1-rank mesh, or rules that resolve it to no mesh axis (a size that
    does not divide: JAX's replicated fallback)."""
    mesh = compat.get_active_mesh()
    if mesh is None or mesh.size <= 1:
        return None
    spec = resolve_spec((axis,), (n,), mesh, current_rules())
    axes = compat._axes(spec[0])
    if not axes:
        return None
    if len(axes) > 1:
        raise NotImplementedError(
            f"rows of {axis!r} resolve to several mesh axes {axes}; the "
            "sharded GNN path takes one (gnn_rules, or flatten_mesh first)")
    ax = axes[0]
    return RowShard(group=mesh.group(ax), num_shards=mesh.shape[ax],
                    index=mesh.coordinate(ax), n=n)


# ---------------------------------------------------------------------------
# multi-rank sharded message passing (the large-graph extension, §4.6)
# ---------------------------------------------------------------------------


def _resolve_num_shards(num_shards: int | None, group) -> int:
    """The shard count: given, or the size of ``group`` (None: the default
    group; 1 without a process group)."""
    if num_shards is not None:
        return int(num_shards)
    return dist.get_world_size(group) if dist.is_initialized() else 1


def allgather_mp_local(
    x_local: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    edge_mask: torch.Tensor,
    phi: Callable[[torch.Tensor], torch.Tensor],
    group=None,
    num_shards: int | None = None,
) -> torch.Tensor:
    """Per-rank body: all-gather x, aggregate messages for local dst rows.

    x_local: (N/P, F).  src / dst: (E/P,) *global* node ids of this rank's
    edges, which may be any edges.  Returns (N/P, F') aggregated messages
    for this rank's nodes."""
    from repro_torch.core import scatter_gather as sg

    p = _resolve_num_shards(num_shards, group)
    n_local = x_local.shape[0]
    x_global = all_gather_rows(x_local, group, p)
    msgs = phi(x_global[src.long()])
    msgs = torch.where(edge_mask[:, None], msgs, torch.zeros_like(msgs))
    # each edge lives on one rank, its destination anywhere: reduce into
    # the global frame, then reduce-scatter the rows to their owners
    agg_global = sg.segment_reduce(msgs, dst, n_local * p, "sum")
    return reduce_scatter_rows(agg_global, group, p)


def alltoall_mp_local(
    x_local: torch.Tensor,
    src_local: torch.Tensor,
    dst: torch.Tensor,
    edge_mask: torch.Tensor,
    phi: Callable[[torch.Tensor], torch.Tensor],
    group=None,
    capacity: int = 0,
    num_shards: int | None = None,
) -> torch.Tensor:
    """Per-rank body of the all-to-all exchange: edges live on the rank
    that owns their *source* (``src_local`` local row ids, ``dst`` global
    ids).  ``capacity`` bounds the messages one (source rank ->
    destination rank) pair carries per layer; overflow drops (GShard
    semantics), as in JAX."""
    from repro_torch.core import scatter_gather as sg

    p = _resolve_num_shards(num_shards, group)
    n_local = x_local.shape[0]
    msgs = phi(x_local[src_local.long()])
    msgs = torch.where(edge_mask[:, None], msgs, torch.zeros_like(msgs))
    dst = dst.long()
    dst_shard = dst // n_local
    # the destination-local row rides beside the payload, so the receiver
    # folds messages into its O(N/P) rows (merged scatter-gather)
    payload = torch.cat([msgs, (dst % n_local).to(msgs.dtype)[:, None]], dim=-1)
    slots, _, _ = sg.dispatch_to_slots(payload, dst_shard, p, capacity,
                                       valid=edge_mask)  # (P, capacity, F+1)
    received = all_to_all_rows(slots, group, p)
    rmsg = received[..., :-1].reshape(p * capacity, -1)
    rdst = received[..., -1].reshape(p * capacity).to(torch.int64)
    # empty slots carry zeros and fold harmlessly into row 0
    return sg.segment_reduce(rmsg, rdst, n_local, "sum")


def make_sharded_mp(mesh: compat.Mesh, axis: str, phi: Callable,
                    strategy: str = "allgather", capacity: int = 0):
    """A ``compat.shard_map``-wrapped aggregate step: ``fn(x, src, dst,
    edge_mask) -> (N, F')`` on global tensors, x and the edges cut along
    dim 0 over ``axis`` (ownership: 'allgather' any rank, 'alltoall' the
    source's rank, with src given rank-locally)."""
    num_shards = int(mesh.shape[axis])
    group = mesh.group(axis)
    if strategy == "allgather":
        body = partial(allgather_mp_local, phi=phi, group=group,
                       num_shards=num_shards)
    elif strategy == "alltoall":
        if capacity <= 0:
            raise ValueError("alltoall strategy requires capacity > 0")
        body = partial(alltoall_mp_local, phi=phi, group=group,
                       capacity=capacity, num_shards=num_shards)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    in_specs = (PartitionSpec(axis, None), PartitionSpec(axis),
                PartitionSpec(axis), PartitionSpec(axis))
    return compat.shard_map(body, mesh, in_specs=in_specs,
                            out_specs=PartitionSpec(axis, None))

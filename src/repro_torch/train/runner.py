"""A training step's runner: one step a call, over a tree of state tensors
that stay the same tensors for the whole run.

JAX jits its train step (``repro.train.loop``: ``jax.jit(step,
donate_argnums=(0, 1, 2))``, the launcher and ``examples/train_gin_molhiv.py``
likewise) and runs one compiled program a step.  On the card the port's
counterpart is a CUDA graph: :class:`CapturedStep` runs its first step
eagerly on a side stream (the warm, a real training step: cuBLAS, NCCL and
autograd set up there) and captures the next, which every later call
replays.  Where a graph cannot be captured, on the CPU and on a gloo mesh
(gloo's collectives do not capture), :class:`EagerStep` runs the step op by
op.  :func:`runner` picks one by :func:`captures`, a rule of the device and
the backend; nothing falls back from one to the other, and a graph that
fails to capture or to replay raises :class:`StepGraphError`.

A step is ``fn(state, batch) -> (new_state, out)``.  ``state`` is a tree of
tensors (dicts, lists, tuples; None for an empty subtree); ``new_state`` has
its structure, each leaf either the state's own tensor (updated in place,
as ``adamw.update`` does) or a new one (AdamW's step count, the error
buffer), which the runner copies into the state's.  A graph holds the
addresses of the state's tensors, so they stay the same tensors: ``load``
copies a tree (a restored checkpoint) into them and ``zero`` zeroes
subtrees (an optimizer started again), and the graph is kept.  ``batch`` is
a nest of tensors (dicts, lists, tuples, dataclasses such as ``Graph``); the
captured runner copies each call's into the buffers it captured, which it
holds to the same shapes, dtypes and other fields.  DTensors are copied
through their local blocks, at equal placements.  ``out`` (the metrics) is
the graph's own tensors after a replay: read it before the next call.

``capture_count`` and ``replay_count`` count the graphs captured and their
replays in this process, as the kernel wrappers count their launches.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

capture_count = 0
replay_count = 0


class StepGraphError(RuntimeError):
    """A step's CUDA graph failed to capture or to replay.  It is no node
    failure: the training loop does not retry it, and nothing runs the step
    eagerly instead."""


def captures(device, backend: str = "none") -> bool:
    """Whether a step on ``device`` whose mesh runs ``backend``'s collectives
    runs as a CUDA graph: on the card with no collective ("none": no mesh,
    or a 1-rank mesh without a process group) or NCCL's; gloo runs eagerly
    (its collectives cannot be captured), and so does the CPU."""
    return torch.device(device).type == "cuda" and backend in ("none", "nccl")


def runner(fn: Callable, state, device, mesh=None):
    """The runner of ``fn`` over ``state`` on ``device`` (and ``mesh``, a
    ``runtime.Mesh``): :class:`CapturedStep` where :func:`captures`, else
    :class:`EagerStep`.  Every rank of a mesh takes the same one."""
    backend = "none" if mesh is None else mesh.backend
    return (CapturedStep if captures(device, backend) else EagerStep)(fn, state)


class EagerStep:
    """The step op by op (the CPU, gloo ranks)."""

    def __init__(self, fn: Callable, state):
        self.fn = fn
        self.state = state

    def __call__(self, batch):
        new, out = self.fn(self.state, batch)
        with torch.no_grad():
            for dst, src in _pairs(self.state, new):
                if dst is not src:
                    _copy(dst, src)
        return out

    def load(self, tree: dict) -> None:
        """Copy ``tree`` (a dict of some of the state's subtrees, such as a
        restored checkpoint's) into the state's tensors."""
        with torch.no_grad():
            for key, sub in tree.items():
                for dst, src in _pairs(self.state[key], sub):
                    _copy(dst, src)

    def zero(self, *keys: str) -> None:
        """Zero the state's subtrees ``keys`` in place."""
        with torch.no_grad():
            for key in keys:
                for t in _flat(self.state[key]):
                    _local(t).zero_()

    def close(self) -> None:
        """Free what the runner holds beside the state (a graph, its pool)."""


class CapturedStep(EagerStep):
    """The step as one CUDA graph: the first call warms (a real step, eager,
    on a side stream) and captures; every later call copies its batch into
    the captured buffers and replays.  On a mesh the caller runs the calls
    inside the step's ``partitioning.mesh_scope``."""

    def __init__(self, fn: Callable, state):
        super().__init__(fn, state)
        self.graph = None
        self.batch = None
        self.out = None

    def __call__(self, batch):
        global replay_count
        if self.graph is None:
            return self._first(batch)
        with torch.no_grad():
            for dst, src in _pairs(self.batch, batch, "batch"):
                _copy(dst, src)
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise StepGraphError(f"a replay of the captured step failed: {e}") from e
        replay_count += 1
        return self.out

    def _first(self, batch):
        global capture_count
        self.batch = _map(lambda t: t.clone(), batch)
        with _side_stream():
            warm = super().__call__(self.batch)
        try:
            self.graph, self.out = _capture(
                lambda: super(CapturedStep, self).__call__(self.batch), self.state)
        except Exception as e:  # noqa: BLE001 — any capture failure is the graph's
            self.graph = None
            raise StepGraphError(f"the step could not be captured: {e}") from e
        capture_count += 1
        return warm

    def close(self) -> None:
        self.graph = self.batch = self.out = None
        torch.cuda.empty_cache()


@contextlib.contextmanager
def _side_stream():
    """Work on a side stream of the card, joined (and the card idle) at the
    end."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        yield
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _capture(body: Callable, state) -> tuple:
    """(graph, what ``body`` returned) of ``body`` captured once.  A capture
    runs nothing: ``state``, the tensors ``body`` writes, keeps its values."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body()
    return graph, out


def _flat(tree) -> list:
    """The leaves of a nest of dicts (sorted keys), lists, tuples and
    dataclasses; None has none."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _flat(getattr(tree, f.name))]
    return [tree]


def _map(fn: Callable, tree):
    """The nest with ``fn`` applied to every tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def _pairs(dst, src, what: str = "state") -> list:
    """(dst leaf, src leaf) of two nests of one structure: tensors paired,
    any other leaves equal."""
    a, b = _flat(dst), _flat(src)
    if len(a) != len(b):
        raise ValueError(f"the {what} has {len(a)} leaves, the tree given {len(b)}")
    out = []
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor) or (
                not isinstance(x, torch.Tensor) and x != y):
            raise ValueError(f"the {what}'s leaf {x!r} cannot take {y!r}")
        if isinstance(x, torch.Tensor):
            out.append((x, y))
    return out


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if _is_dtensor(t) else t


def _copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``src`` into ``dst``: the same shape and dtype, and for DTensors the
    same placements (each rank copies its own block)."""
    if tuple(dst.shape) != tuple(src.shape) or dst.dtype != src.dtype:
        raise ValueError(f"cannot copy a {src.dtype} {tuple(src.shape)} tensor into a "
                         f"{dst.dtype} {tuple(dst.shape)} one")
    if _is_dtensor(dst) or _is_dtensor(src):
        if not (_is_dtensor(dst) and _is_dtensor(src)
                and tuple(dst.placements) == tuple(src.placements)):
            raise ValueError(f"cannot copy placements {getattr(src, 'placements', None)} "
                             f"into {getattr(dst, 'placements', None)}")
    _local(dst).copy_(_local(src))

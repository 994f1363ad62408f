"""Fault-tolerant checkpointing: atomic and asynchronous (port of
``repro.checkpoint.manager``).

  * **atomic**: a checkpoint is either whole or absent.  Its files go to
    ``<dir>/tmp.step_N``, which is renamed to ``step_N`` (atomic on POSIX)
    only after an fsync'd manifest has landed.
  * **async**: the tensors are copied to the host at ``save``; writing the
    files happens on a background thread, which ``wait()`` joins (every
    ``save`` waits for the previous one).
  * **keep-N**: the newest ``keep`` checkpoints are kept.

The on-disk format is JAX's, so checkpoints move both ways between the two
packages: one ``.npy`` per leaf, named by its path of dict keys and list
indices (``params/blocks/0/mixer/wq`` in ``params__blocks__0__mixer__wq.npy``,
dict keys in sorted order), bf16 stored as its uint16 bit pattern with
"bfloat16" in the manifest's ``dtypes``; the manifest also holds the step,
the keys and the parameters' logical axes (``axes_tree``).  JAX's manifest
holds its tree structure as a serialized proto (``treedef``); the port
writes null there, and both packages restore by a template tree, which
JAX's ``restore`` needs as well.  ``restore`` puts each leaf on its
template leaf's device (or ``device``).

Elastic restore (JAX's): with ``mesh=`` (a ``runtime.Mesh``, any shape)
and the logical axes in the manifest, each leaf with axes is placed by
``runtime.partitioning.resolve_spec`` under ``rules`` as a DTensor on the
new mesh: every rank reads the file and keeps its own block
(``DTensor.from_local``, no exchange); a leaf without axes stays a plain
tensor.  On several ranks ``save`` takes DTensor leaves too (each is
all-gathered whole: every rank must call ``save``) and only rank 0 writes.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

_MANIFEST = "manifest.json"


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """{"a/b/0/c": leaf} in JAX's flattening order (sorted dict keys, list
    order); a None subtree has no leaves."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten_like(template, flat: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_like(v, flat, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(template))
    return flat[prefix]


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _writer() -> bool:
    """Whether this process writes the files: rank 0 of a process group,
    or the only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as numpy (the caller may write the tensor on while
    the files are written), bf16 as its uint16 bit pattern (numpy has no
    bf16); a DTensor is all-gathered whole first."""
    if _is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(arr: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    arr = np.require(arr, requirements="C")  # keeps a 0-d leaf 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, axes_tree: Any = None, blocking: bool = False):
        """Save a tree of tensors.  ``axes_tree`` (the same structure, leaves
        logical-axes tuples, a None subtree for leaves without) goes into
        the manifest.  On several ranks every rank calls it (DTensor leaves
        are gathered) and rank 0 writes."""
        self.wait()
        host = {key: (_to_host(leaf), leaf.dtype == torch.bfloat16)
                for key, leaf in _flatten_with_paths(tree).items()}
        if not _writer():
            return

        def work():
            tmp = os.path.join(self.dir, f"tmp.step_{step:08d}")
            final = os.path.join(self.dir, f"step_{step:08d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            dtypes = {}
            for key, (arr, bf16) in host.items():
                dtypes[key] = "bfloat16" if bf16 else str(arr.dtype)
                np.save(os.path.join(tmp, key.replace("/", "__") + ".npy"), arr)
            manifest = {
                "step": step,
                "keys": list(host),
                "dtypes": dtypes,
                "treedef": None,
                "axes": _axes_manifest(axes_tree) if axes_tree is not None else None,
            }
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._retain()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _retain(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.dir, name, _MANIFEST)
            ):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, template: Any = None,
                device=None, mesh=None, rules=None) -> tuple:
        """Returns (step, tree): the tree has ``template``'s structure (a
        tree of tensors, or of anything with their paths), each leaf in its
        stored dtype on ``device`` or, with ``device`` None, on its template
        leaf's device (the CPU for a leaf that is not a tensor).  With
        ``mesh`` and logical axes in the manifest, a leaf with axes comes
        back as a DTensor placed by them (elastic restore)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        if template is None:
            raise ValueError("restore requires a template tree")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", {})
        flat_template = _flatten_with_paths(template)
        if set(flat_template) != set(manifest["keys"]):
            raise ValueError("checkpoint keys differ from the template's: "
                             f"{sorted(set(flat_template) ^ set(manifest['keys']))[:5]}")
        flat = {}
        for key, like in flat_template.items():
            arr = np.load(os.path.join(d, key.replace("/", "__") + ".npy"))
            dev = device if device is not None else getattr(like, "device", "cpu")
            flat[key] = _from_host(arr, dtypes.get(key)).to(dev)
        if mesh is not None and manifest.get("axes"):
            flat = {key: _place(t, manifest["axes"].get(key), mesh, rules)
                    for key, t in flat.items()}
        return step, _unflatten_like(template, flat)


def _place(t: torch.Tensor, axes, mesh, rules):
    """``t`` as a DTensor on ``mesh`` under the spec its logical ``axes``
    resolve to (``partitioning.place``: this rank's block of the whole
    tensor every rank read); ``t`` itself without axes or on a mesh
    without a process group."""
    if axes is None or mesh.device_mesh is None:
        return t
    from repro_torch.runtime import partitioning as PT

    return PT.place(t, PT.resolve_spec(tuple(axes), tuple(t.shape), mesh, rules), mesh)


def _axes_manifest(axes_tree) -> dict:
    """{"params/embed": ["vocab", "embed"], ...}: a tuple is a leaf, a None
    subtree has none (JAX's ``_axes_manifest``)."""
    def walk(tree, prefix):
        if tree is None:
            return {}
        if isinstance(tree, tuple):
            return {prefix: list(tree)}
        items = (sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree))
        out = {}
        for k, v in items:
            out.update(walk(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return walk(axes_tree, "")

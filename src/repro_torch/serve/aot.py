"""Persistent, fingerprinted cache of the port's compiled kernel libraries
(port of ``repro.serve.aot``).

JAX persists each serving program's XLA executable, so a restarted server
deserializes finished machine code instead of tracing and compiling again.
The port's programs are CUDA graphs, which cannot be serialized: every
process captures its own (``Executor.lowered_count`` counts them, and a
restart cannot make it 0).  What a restart can skip is ``nvcc``: the
kernels' shared libraries (``kernels/_build.py``) are this cache's
entries, and a warm cache serves a process without one compiler run.

* :func:`environment_fingerprint` is the invalidation key: a library is
  machine code for one (torch, CUDA runtime, ``nvcc`` release, driver,
  GPU and compute capability, device count, ``nvcc`` flag set).  Every
  entry embeds the fingerprint of the environment that built it; a load
  under another fingerprint is ``stale`` (not a ``miss``), and the library
  is rebuilt and overwritten in place.  Computing it starts no process
  but ``nvidia-smi`` (for the driver): never ``nvcc``.
* :class:`AOTCache` keeps two files per entry under its root, both named
  by the SHA-256 of the logical key (source name, source hash, ``-D``
  defines): ``<digest>.so``, the library, and ``<digest>.aotx``, a JSON
  record ``{schema, key, fingerprint, sha256, size}``.  Writes are atomic
  (tempfile + rename, the library first, so a record never names a
  library not yet in place).  A record that does not parse, names another
  key (a collision) or whose library is missing, truncated or altered
  (size or SHA-256) is a ``miss``: the caller builds and the write-back
  heals the entry.  Nothing on the load path raises for a bad entry.

``XlaFlagConfig`` and JAX's flag table are not ported: they have no CUDA
meaning.  The fingerprint's ``flags`` field hashes ``_build.NVCC_FLAGS``
instead.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = ["AOTCache", "environment_fingerprint", "flags_hash", "model_label"]

_SCHEMA = "repro-torch-aot/v1"
ENTRY_SUFFIX = ".aotx"
LIBRARY_SUFFIX = ".so"


# ---------------------------------------------------------------------------
# fingerprinting
# ---------------------------------------------------------------------------


def flags_hash(flags) -> str:
    """Canonical short hash of one compiler flag set (a sequence of
    arguments, order kept)."""
    blob = json.dumps(list(flags or ()))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def nvcc_release() -> str:
    """The ``nvcc`` release, read without running it: ``cuda_nvcc`` in the
    toolkit's ``version.json`` beside ``bin/nvcc``, else the SHA-256 of the
    compiler's file; "none" where there is no ``nvcc``."""
    from repro_torch.kernels import _build

    try:
        nvcc = Path(_build.nvcc_path())
    except RuntimeError:
        return "none"
    meta = nvcc.resolve().parent.parent / "version.json"
    try:
        return "nvcc " + json.loads(meta.read_text())["cuda_nvcc"]["version"]
    except (OSError, ValueError, KeyError, TypeError):
        return "sha256:" + _sha256_file(nvcc)[:16]


def driver_version() -> str:
    """The NVIDIA driver's version as ``nvidia-smi`` reports it; "none"
    where there is no ``nvidia-smi``."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "none"
    out = subprocess.run([smi, "--query-gpu=driver_version",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False)
    lines = out.stdout.split()
    return lines[0] if out.returncode == 0 and lines else "none"


def environment_fingerprint() -> dict:
    """Everything a built library is valid only under: the schema, torch
    and its CUDA runtime, the ``nvcc`` release, the driver, the first
    device's name and compute capability, the device count, and the hash
    of the ``nvcc`` flags.  Deterministic and JSON-able; equality is the
    cache's validity test.  Without CUDA the device fields read "none"."""
    import torch

    from repro_torch.kernels import _build

    cuda = torch.cuda.is_available()
    return {
        "schema": _SCHEMA,
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "nvcc": nvcc_release(),
        "driver": driver_version(),
        "device_name": torch.cuda.get_device_name(0) if cuda else "none",
        "capability": ("%d.%d" % torch.cuda.get_device_capability(0)
                       if cuda else "none"),
        "num_devices": torch.cuda.device_count() if cuda else 0,
        "flags": flags_hash(_build.NVCC_FLAGS),
    }


def model_label(cfg) -> str:
    """The name of one model config: ``gin_vn`` is another program than
    ``gin`` (``cfg.model`` alone would conflate them)."""
    return cfg.model + ("_vn" if getattr(cfg, "virtual_node", False) else "")


# ---------------------------------------------------------------------------
# the persistent library cache
# ---------------------------------------------------------------------------


class AOTCache:
    """Disk cache of built kernel libraries, keyed by logical identity and
    guarded by the environment fingerprint.

    ``stats`` tallies ``hit`` (the library is served from the cache),
    ``miss`` (absent, unreadable, colliding or corrupt: build, write back)
    and ``stale`` (another fingerprint: build, overwrite).  ``last_result``
    is the latest lookup's outcome and ``log`` every lookup's ``(key,
    result)``, in order; the executor mirrors new lookups into
    ``serve_aot_cache_total{result}`` and ``aot_load`` trace events."""

    def __init__(self, root):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.stats: Dict[str, int] = {"hit": 0, "miss": 0, "stale": 0}
        self.last_result: str = ""
        self.log: List[Tuple[tuple, str]] = []

    # ------------------------------------------------------------ paths

    def _digest(self, key: tuple) -> str:
        return hashlib.sha256(repr(key).encode()).hexdigest()

    def entry_path(self, key: tuple) -> str:
        """The record of ``key``: ``<root>/<sha256(repr(key))>.aotx``."""
        return os.path.join(self.root, self._digest(key) + ENTRY_SUFFIX)

    def library_path(self, key: tuple) -> str:
        """The library the record of ``key`` vouches for."""
        return os.path.join(self.root, self._digest(key) + LIBRARY_SUFFIX)

    def entries(self) -> list:
        """Record files on disk, sorted."""
        return sorted(f for f in os.listdir(self.root) if f.endswith(ENTRY_SUFFIX))

    # ------------------------------------------------------------- load

    def load(self, key: tuple, fingerprint: dict) -> Optional[str]:
        """The cached library's path for ``key`` under ``fingerprint``, or
        ``None`` (recorded as a miss or stale).  A bad entry is a miss,
        never an exception."""
        try:
            with open(self.entry_path(key)) as f:
                rec = json.load(f)
            if not isinstance(rec, dict) or rec.get("schema") != _SCHEMA:
                raise ValueError("bad record schema")
        except (OSError, ValueError):  # absent, truncated or not a record
            return self._outcome(key, "miss")
        if rec.get("key") != repr(key):  # a hash collision or a tampered file
            return self._outcome(key, "miss")
        if rec.get("fingerprint") != fingerprint:
            return self._outcome(key, "stale")
        lib = Path(self.library_path(key))
        try:
            intact = (lib.stat().st_size == rec.get("size")
                      and _sha256_file(lib) == rec.get("sha256"))
        except OSError:
            intact = False
        if not intact:
            return self._outcome(key, "miss")
        self._outcome(key, "hit")
        return str(lib)

    def _outcome(self, key: tuple, result: str) -> None:
        self.stats[result] += 1
        self.last_result = result
        self.log.append((key, result))
        return None

    # ------------------------------------------------------------ store

    def store(self, key: tuple, fingerprint: dict, built) -> str:
        """Move the freshly built library ``built`` (a file under the root:
        the rename is atomic there) into place as the entry of ``key``,
        then write its record atomically.  Returns the cached library's
        path."""
        lib = self.library_path(key)
        os.replace(built, lib)
        rec = {"schema": _SCHEMA, "key": repr(key), "fingerprint": fingerprint,
               "sha256": _sha256_file(Path(lib)), "size": os.path.getsize(lib)}
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(rec, f, sort_keys=True)
            os.replace(tmp, self.entry_path(key))
        except BaseException:
            Path(tmp).unlink(missing_ok=True)
            raise
        return lib

"""Build the port's CUDA kernels and load them through ``ctypes``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  Libraries are built at first use; :func:`build` compiles
several sources in parallel, one ``nvcc`` each.  ``defines`` (``-D``
names, e.g. ``FUSED_MP_PHASES`` for the phase marks of
``kernels/fused_mp_phases.py``) build a separate library of a source.
A failed build raises with the compiler's output — there is no fallback.

Where a library lives:

* by default in ``build/repro_torch/`` at the repository root, named by a
  hash of the source and the flags;
* with a cache set (:func:`use_cache`: a ``serve.aot.AOTCache`` and the
  environment fingerprint, as ``Executor(aot_cache=...)`` sets them) in
  the cache, keyed by (source name, source hash, defines) and checked
  against the fingerprint: a hit runs no ``nvcc``, a miss or a stale
  entry builds and writes back.  :data:`nvcc_runs` counts the compiler
  processes this process started.

:func:`ensure_library` makes the file exist and :func:`load` opens it with
``ctypes``; loaded libraries are per process (the first load of a source
decides which file serves it).

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("node_mlp", "fused_mp", "segment_reduce", "edge_softmax",
           "quant_mlp", "flash_attention", "latency_probe")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[tuple, ctypes.CDLL] = {}
# (AOTCache, fingerprint) that builds and loads go through, or None
_cache: Optional[tuple] = None
nvcc_runs = 0  # compiler processes started by this process


def use_cache(cache, fingerprint: Optional[dict] = None) -> None:
    """Route later builds and loads through ``cache`` (a
    ``serve.aot.AOTCache``) under ``fingerprint``
    (``serve.aot.environment_fingerprint()``); ``None`` restores the
    default ``build/repro_torch/``.  Libraries already loaded stay."""
    global _cache
    _cache = None if cache is None else (cache, fingerprint)


def device_scope(device):
    """Make CUDA ``device`` current for a launch; a no-op context when it
    already is (the common case, which then costs no device switch)."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(kernel: str, name: str, t, device, dtype, shape) -> None:
    """Raise unless operand ``name`` of ``kernel`` is a contiguous ``dtype``
    tensor on ``device`` whose shape matches ``shape`` (None entries match
    any size)."""
    if t is None:
        raise ValueError(f"{kernel}: operand {name} is required")
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        s is not None and s != got for s, got in zip(shape, t.shape)
    ):
        raise ValueError(
            f"{kernel}: {name} has shape {tuple(t.shape)}, expected {shape}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels build only on a machine with the CUDA toolkit"
        )
    return found


def _flags(defines: Iterable[str]) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: Iterable[str] = ()) -> Path:
    """The library's file in ``build/repro_torch/`` (no cache set)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(defines)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def cache_key(name: str, defines: Iterable[str] = ()) -> tuple:
    """The logical key of a library in an ``AOTCache``: (source name,
    source SHA-256, defines).  The flags are in the fingerprint."""
    src = CSRC / f"{name}.cu"
    return (name, hashlib.sha256(src.read_bytes()).hexdigest(), tuple(defines))


def nvcc_command(name: str, out: Path, defines: Iterable[str] = ()) -> list:
    return [nvcc_path(), *_flags(defines), "-o", str(out), str(CSRC / f"{name}.cu")]


def _library_file(name: str, defines: tuple) -> Path:
    """Where the library of ``name`` lives: in the cache when one is set,
    else in ``build/repro_torch/``."""
    if _cache is None:
        return library_path(name, defines)
    return Path(_cache[0].library_path(cache_key(name, defines)))


def _present(name: str, defines: tuple) -> bool:
    """Whether the library is there to load: the file in
    ``build/repro_torch/``, or a cache hit (each call is one lookup)."""
    if _cache is None:
        return library_path(name, defines).exists()
    cache, fingerprint = _cache
    return cache.load(cache_key(name, defines), fingerprint) is not None


def build(names: Iterable[str] = SOURCES, defines: Iterable[str] = ()) -> Dict[str, str]:
    """Make every library of ``names`` exist, compiling the missing ones in
    parallel; returns ``{name: compiler output}`` for the sources built in
    this call (``-Xptxas -v`` reports registers, shared memory and spills).
    With a cache set every name is looked up there first (hit, miss or
    stale: ``AOTCache.stats``) and each build is written back."""
    global nvcc_runs
    defines = tuple(defines)
    if _cache is None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if _present(name, defines):
            continue
        out = _library_file(name, defines)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, out, subprocess.Popen(
            nvcc_command(name, tmp, defines), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
        nvcc_runs += 1
    logs, failed = {}, []
    for name, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        elif _cache is None:
            os.replace(tmp, out)
        else:
            cache, fingerprint = _cache
            cache.store(cache_key(name, defines), fingerprint, tmp)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def ensure_library(name: str, defines: Iterable[str] = ()) -> Path:
    """The file of the library ``csrc/<name>.cu`` built with ``defines``,
    built first if it is missing (in the cache when one is set)."""
    defines = tuple(defines)
    build([name], defines)
    return _library_file(name, defines)


def load(name: str, signatures: Dict[str, tuple],
         defines: Iterable[str] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` built with ``defines``
    (built if missing), with ``signatures`` ``{function: (restype,
    argtypes)}`` declared on it."""
    defines = tuple(defines)
    lib = _loaded.get((name, defines))
    if lib is None:
        lib = ctypes.CDLL(str(ensure_library(name, defines)))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = list(argtypes)
        _loaded[(name, defines)] = lib
    return lib

"""The port's kernel-library cache (``repro_torch.serve.aot`` through
``repro_torch.kernels._build``) on the CPU, driven by a stand-in compiler.

``$CUDA_HOME/bin/nvcc`` is a small script that writes the output file
(bytes derived from the source's name and the flags) and logs each call,
so the cache's every path runs here without ``nvcc``:

* a miss builds and writes back; the next lookup is a hit and the compiler
  runs zero times; with no cache set the library goes to the build
  directory as before;
* a changed fingerprint field (the driver; the toolkit's ``version.json``
  for the ``nvcc`` release) is ``stale``: rebuilt and overwritten in place;
* a garbage, truncated or colliding record, and a truncated or altered
  library, are misses, and the write-back heals them;
* an interrupted record write leaves no partial file, and the entry reads
  as a miss, never as the wrong library;
* a failed build raises with the compiler's output and writes nothing;
* a restarted process, given only the cache directory, runs the compiler
  zero times;
* the fingerprint is deterministic and JSON-able; the executor mirrors
  lookups into ``serve_aot_cache_total{result}`` and ``aot_load`` events;
  the facade refuses ``aot_cache`` beside an explicit executor.

The real ``nvcc`` build through the cache, and a restarted process on the
card, are in ``tests/test_torch_on_card.py``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.gengnn_models import get_gnn_config
from repro_torch.gnn import init
from repro_torch.kernels import _build
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serve import aot
from repro_torch.serve.aot import AOTCache, environment_fingerprint
from repro_torch.serve.clock import VirtualClock
from repro_torch.serve.executor import Executor
from repro_torch.serve.gnn_engine import GNNEngine

ROOT = Path(__file__).resolve().parent.parent
NAMES = ("node_mlp", "edge_softmax")

STANDIN = """#!{python}
import os, sys
from pathlib import Path
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
if os.environ.get("STANDIN_FAIL"):
    print("stand-in: error: " + os.environ["STANDIN_FAIL"])
    sys.exit(2)
out = Path(args[args.index("-o") + 1])
call = len(open({log!r}).read().splitlines())  # each build's bytes differ
out.write_bytes(("library of " + Path(args[-1]).name + " build " + str(call)
                 + " " + " ".join(args[:-3])).encode())
print("ptxas info    : stand-in for " + Path(args[-1]).name)
"""


class StandIn:
    """A toolkit directory whose ``bin/nvcc`` is the stand-in; ``calls``
    reads its log."""

    def __init__(self, root: Path):
        self.home = root / "cuda"
        (self.home / "bin").mkdir(parents=True)
        self.log = root / "nvcc.log"
        self.log.write_text("")
        nvcc = self.home / "bin" / "nvcc"
        nvcc.write_text(STANDIN.format(python=sys.executable, log=str(self.log)))
        nvcc.chmod(0o755)

    @property
    def calls(self) -> int:
        return len(self.log.read_text().splitlines())

    def set_release(self, version: str) -> None:
        (self.home / "version.json").write_text(
            json.dumps({"cuda_nvcc": {"version": version}}))


@pytest.fixture
def standin(tmp_path, monkeypatch):
    s = StandIn(tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(s.home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_cache", None)
    monkeypatch.setattr(_build, "nvcc_runs", 0)
    return s


def _cached(tmp_path, name="aot"):
    cache = AOTCache(tmp_path / name)
    fp = environment_fingerprint()
    _build.use_cache(cache, fp)
    return cache, fp


def test_fingerprint_is_deterministic_and_jsonable(standin, monkeypatch):
    a, b = environment_fingerprint(), environment_fingerprint()
    assert a == b and json.loads(json.dumps(a)) == a
    assert set(a) == {"schema", "torch", "cuda", "nvcc", "driver", "device_name",
                      "capability", "num_devices", "flags"}
    assert a["torch"] == torch.__version__
    assert a["flags"] == aot.flags_hash(_build.NVCC_FLAGS)
    assert a["nvcc"].startswith("sha256:")  # no version.json: the file's hash
    standin.set_release("12.9.41")
    assert environment_fingerprint()["nvcc"] == "nvcc 12.9.41"
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert environment_fingerprint()["flags"] != a["flags"]
    assert standin.calls == 0  # the fingerprint never runs the compiler


def test_without_a_cache_the_build_directory_is_used(standin):
    logs = _build.build(NAMES)
    assert set(logs) == set(NAMES) and "stand-in" in logs["node_mlp"]
    assert standin.calls == 2 and _build.nvcc_runs == 2
    assert _build.ensure_library("node_mlp") == _build.library_path("node_mlp")
    assert _build.library_path("node_mlp").is_file()
    assert _build.build(NAMES) == {} and standin.calls == 2


def test_miss_writes_back_then_hit_runs_no_compiler(standin, tmp_path):
    cache, fp = _cached(tmp_path)
    logs = _build.build(NAMES)
    assert set(logs) == set(NAMES) and standin.calls == 2
    assert cache.stats == {"hit": 0, "miss": 2, "stale": 0}
    assert len(cache.entries()) == 2
    assert not list(Path(cache.root).glob("*.tmp"))
    assert _build.build(NAMES) == {}
    assert cache.stats == {"hit": 2, "miss": 2, "stale": 0} and standin.calls == 2
    lib = _build.ensure_library("node_mlp")
    key = _build.cache_key("node_mlp")
    assert str(lib) == cache.library_path(key) and cache.last_result == "hit"
    assert lib.read_bytes().startswith(b"library of node_mlp.cu")
    rec = json.loads(Path(cache.entry_path(key)).read_text())
    assert rec["key"] == repr(key) and rec["fingerprint"] == fp
    assert [r for _, r in cache.log] == ["miss", "miss", "hit", "hit", "hit"]
    # defines make another entry of the same source
    _build.build(["node_mlp"], defines=("PHASES",))
    assert standin.calls == 3 and len(cache.entries()) == 3


@pytest.mark.parametrize("field", ["driver", "nvcc"])
def test_changed_fingerprint_field_is_stale_and_overwrites(standin, tmp_path, field):
    cache, fp = _cached(tmp_path)
    _build.build(["node_mlp"])
    if field == "nvcc":  # a new toolkit release beside the same compiler
        standin.set_release("13.0.0")
        fp2 = environment_fingerprint()
    else:
        fp2 = dict(fp, driver="999.99")
    assert fp2 != fp and {k for k in fp if fp[k] != fp2[k]} == {field}
    _build.use_cache(cache, fp2)
    _build.build(["node_mlp"])
    assert cache.stats == {"hit": 0, "miss": 1, "stale": 1} and standin.calls == 2
    key = _build.cache_key("node_mlp")
    assert json.loads(Path(cache.entry_path(key)).read_text())["fingerprint"] == fp2
    assert len(cache.entries()) == 1  # overwritten in place
    _build.build(["node_mlp"])
    assert cache.last_result == "hit" and standin.calls == 2
    _build.use_cache(cache, fp)  # the old environment: stale again
    _build.build(["node_mlp"])
    assert cache.stats["stale"] == 2 and standin.calls == 3


def _corrupt(cache, how):
    key = _build.cache_key("node_mlp")
    rec_path, lib_path = Path(cache.entry_path(key)), Path(cache.library_path(key))
    if how == "record_garbage":
        rec_path.write_bytes(b"\x00\xffnot json")
    elif how == "record_truncated":
        rec_path.write_bytes(rec_path.read_bytes()[:20])
    elif how == "record_schema":
        rec = json.loads(rec_path.read_text())
        rec_path.write_text(json.dumps(dict(rec, schema="other/v0")))
    elif how == "collision":  # a valid record of another key at this path
        other = Path(cache.entry_path(_build.cache_key("edge_softmax")))
        rec_path.write_bytes(other.read_bytes())
    elif how == "library_truncated":
        lib_path.write_bytes(lib_path.read_bytes()[:5])
    elif how == "library_altered":  # same size, other bytes
        data = bytearray(lib_path.read_bytes())
        data[0] ^= 0xFF
        lib_path.write_bytes(bytes(data))
    elif how == "library_missing":
        lib_path.unlink()


@pytest.mark.parametrize("how", ["record_garbage", "record_truncated", "record_schema",
                                 "collision", "library_truncated", "library_altered",
                                 "library_missing"])
def test_bad_entry_is_a_miss_and_heals(standin, tmp_path, how):
    cache, _ = _cached(tmp_path)
    _build.build(NAMES)
    _corrupt(cache, how)
    assert set(_build.build(NAMES)) == {"node_mlp"}
    assert cache.stats == {"hit": 1, "miss": 3, "stale": 0} and standin.calls == 3
    _build.build(NAMES)
    assert cache.stats["hit"] == 3 and standin.calls == 3  # healed


def test_interrupted_record_write_leaves_no_partial_entry(standin, tmp_path,
                                                          monkeypatch):
    cache, fp = _cached(tmp_path)
    _build.build(["node_mlp"])
    key = _build.cache_key("node_mlp")
    before = Path(cache.entry_path(key)).read_bytes()
    real_dump = json.dump

    def broken(obj, f, **kw):
        f.write('{"schema": "repro-torch-aot/v1", "key"')  # half a record
        raise OSError("disk full")

    monkeypatch.setattr(aot.json, "dump", broken)
    _build.use_cache(cache, dict(fp, driver="other"))  # stale: rebuild, store
    with pytest.raises(OSError, match="disk full"):
        _build.build(["node_mlp"])
    monkeypatch.setattr(aot.json, "dump", real_dump)
    assert Path(cache.entry_path(key)).read_bytes() == before  # never partial
    assert not list(Path(cache.root).glob("*.tmp"))
    _build.use_cache(cache, fp)
    # the library was replaced before the record: the old record no longer
    # vouches for it, so the entry is a miss, never the wrong library
    _build.build(["node_mlp"])
    assert cache.last_result == "miss" and standin.calls == 3
    _build.build(["node_mlp"])
    assert cache.last_result == "hit" and standin.calls == 3


def test_failed_build_raises_with_the_compiler_output(standin, tmp_path, monkeypatch):
    cache, _ = _cached(tmp_path)
    monkeypatch.setenv("STANDIN_FAIL", "expected a ';'")
    with pytest.raises(RuntimeError, match="expected a ';'") as err:
        _build.build(["node_mlp"])
    assert "node_mlp.cu (exit 2)" in str(err.value)
    assert cache.entries() == [] and not list(Path(cache.root).iterdir())
    monkeypatch.delenv("STANDIN_FAIL")
    _build.build(["node_mlp"])
    assert len(cache.entries()) == 1


def test_restarted_process_runs_the_compiler_zero_times(standin, tmp_path):
    cache, _ = _cached(tmp_path)
    _build.build(_build.SOURCES)
    assert standin.calls == len(_build.SOURCES)
    child = textwrap.dedent(f"""
        from repro_torch.kernels import _build
        from repro_torch.serve.aot import AOTCache, environment_fingerprint

        cache = AOTCache({cache.root!r})
        _build.use_cache(cache, environment_fingerprint())
        assert _build.build(_build.SOURCES) == {{}}
        paths = [_build.ensure_library(n) for n in _build.SOURCES]
        assert all(str(p).startswith(cache.root) for p in paths)
        print("RESTART hits=%d misses=%d stale=%d nvcc_runs=%d" % (
            cache.stats["hit"], cache.stats["miss"], cache.stats["stale"],
            _build.nvcc_runs))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                       env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n = len(_build.SOURCES)
    assert f"RESTART hits={2 * n} misses=0 stale=0 nvcc_runs=0" in r.stdout
    assert standin.calls == n


def _gin():
    cfg = get_gnn_config("gin", num_layers=2, hidden=16)
    return cfg, init(torch.Generator().manual_seed(0), cfg)


def test_executor_reports_library_lookups(standin, tmp_path):
    cache = AOTCache(tmp_path / "aot")
    reg, tracer = MetricsRegistry(), Tracer(VirtualClock())
    ex = Executor(buckets=((16, 32),), device="cpu", aot_cache=cache,
                  metrics=reg, tracer=tracer)
    assert _build._cache[0] is cache and _build._cache[1] == ex._fingerprint()
    cfg, params = _gin()
    ex.register("m", cfg, params)
    rng = np.random.default_rng(0)
    g = (rng.integers(0, 6, 10).astype(np.int32), rng.integers(0, 6, 10).astype(np.int32),
         rng.normal(size=(6, 9)).astype(np.float32), rng.normal(size=(10, 3)).astype(np.float32))
    # the card's warm loads the libraries inside its eager forward; the
    # CPU forward loads none, so load two here before the warm
    _build.build(NAMES)
    ex.warm(ex.prepare_stream(g))
    _build.build(NAMES)
    ex.run(ex.prepare_stream(g))  # already warm: reports at the next warm
    assert ex.aot_stats() == {"hit": 2, "miss": 2, "stale": 0} == cache.stats
    series = reg.get("serve_aot_cache_total").series()
    assert {k: int(v) for k, v in series.items()} == {("miss",): 2}
    events = [s for s in tracer.spans if s.name == "aot_load"]
    attrs = [dict(e.attrs) for e in events]
    assert sorted(a["library"] for a in attrs) == sorted(NAMES)
    assert all(a["result"] == "miss" and a["tenant"] == "m" for a in attrs)
    ex.warm(ex.prepare_batched([g], 1, 16, 32))
    series = reg.get("serve_aot_cache_total").series()
    assert {k: int(v) for k, v in series.items()} == {("miss",): 2, ("hit",): 2}
    plain = Executor(device="cpu")
    assert plain.aot_stats() == {"hit": 0, "miss": 0, "stale": 0}


def test_facade_refuses_aot_cache_beside_an_executor(standin, tmp_path):
    cfg, params = _gin()
    ex = Executor(device="cpu")
    with pytest.raises(ValueError, match="belong to the executor"):
        GNNEngine(cfg, params, executor=ex, aot_cache=AOTCache(tmp_path / "c"))
    eng = GNNEngine(cfg, params, device="cpu", aot_cache=AOTCache(tmp_path / "c"))
    assert eng.executor.aot is not None and eng.executor.aot_stats()["hit"] == 0


def test_model_label():
    assert aot.model_label(get_gnn_config("gin")) == "gin"
    assert aot.model_label(get_gnn_config("gin_vn")) == "gin_vn"
    assert aot.model_label(get_gnn_config("pna")) == "pna"

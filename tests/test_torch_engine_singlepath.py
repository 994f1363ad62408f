"""Single-path hygiene of the port's serving stack, modelled on
``tools/check_engine_singlepath.py``: an AST walk of every module under
``src/repro_torch/serve/`` and ``src/repro_torch/obs/`` holds two rules.

* ``time`` (any import of it, any reference to its clocks) only in
  ``serve/clock.py`` and ``serve/executor.py``: everything else reads time
  through an injected ``Clock``, so a ``VirtualClock`` run repeats bit for
  bit.
* ``threading`` / ``_thread`` / ``concurrent`` (``concurrent.futures``
  included) only in ``serve/pipeline.py``: its prepare worker is the one
  thread; the scheduler, executor, clock and telemetry stay
  single-threaded.

Each rule has a failing fixture, so the guard cannot pass by checking
nothing.
"""
import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
TIME_ALLOWED = {"serve/clock.py", "serve/executor.py"}
THREADING_ALLOWED = {"serve/pipeline.py"}
THREADING_MODULES = {"threading", "_thread", "concurrent"}


def violations(source: str, rel: str) -> list:
    """``rel: line: what`` for every reference that breaks a rule in the
    module ``rel`` (its path under ``src/repro_torch``)."""
    tree = ast.parse(source, filename=rel)
    time_names = set()  # names bound to the time module or its members
    out = []
    for node in ast.walk(tree):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
            time_names |= {a.asname or a.name for a in node.names
                           if a.name.split(".")[0] == "time"}
        elif isinstance(node, ast.ImportFrom) and node.module is not None:
            mods = [node.module]
            if node.module.split(".")[0] == "time":
                time_names |= {a.asname or a.name for a in node.names}
        for mod in mods:
            root = mod.split(".")[0]
            if root == "time" and rel not in TIME_ALLOWED:
                out.append(f"{rel}:{node.lineno}: import of {mod}")
            if root in THREADING_MODULES and rel not in THREADING_ALLOWED:
                out.append(f"{rel}:{node.lineno}: import of {mod}")
    if rel not in TIME_ALLOWED:
        for node in ast.walk(tree):
            if isinstance(node, ast.Name) and node.id in time_names:
                out.append(f"{rel}:{node.lineno}: reference to {node.id}")
    return out


def walk() -> tuple:
    """(violations, modules checked) over serve/ and obs/."""
    found, checked = [], 0
    for sub in ("serve", "obs"):
        for path in sorted((PORT / sub).glob("*.py")):
            checked += 1
            found += violations(path.read_text(), f"{sub}/{path.name}")
    return found, checked


def test_port_serving_stack_keeps_time_and_threads_single_path():
    found, checked = walk()
    assert found == []
    assert checked >= 9  # serve/{clock,engine,executor,gnn_engine,pipeline,scheduler} + obs/


def test_guard_flags_time_outside_the_clock_and_executor():
    rogue = ("import time as t\n"
             "from time import perf_counter, monotonic as mono\n"
             "def stamp():\n"
             "    return t.time(), perf_counter(), mono()\n")
    found = violations(rogue, "serve/scheduler.py")
    assert sum("import of time" in v for v in found) == 2
    assert {v.split(": ")[-1] for v in found if "reference" in v} == {
        "reference to t", "reference to perf_counter", "reference to mono"}
    assert violations(rogue, "serve/clock.py") == []
    assert violations(rogue, "serve/executor.py") == []
    assert violations(rogue, "obs/trace.py")  # telemetry gets no allowance


def test_guard_flags_threads_outside_the_pipeline():
    rogue = ("import threading\n"
             "import concurrent.futures as cf\n"
             "from _thread import start_new_thread\n"
             "def spawn(fn):\n"
             "    return threading.Thread(target=fn), cf, start_new_thread\n")
    found = violations(rogue, "serve/executor.py")
    assert len(found) == 3 and all("import of" in v for v in found)
    assert violations(rogue, "serve/pipeline.py") == []
    assert len(violations(rogue, "obs/metrics.py")) == 3

"""The port's launcher flags for telemetry, layout and cold start on the CPU
(``repro_torch.launch.serve``), and the artifact checker
(``repro_torch.obs.check_artifacts``).

* A ``--stream`` run with ``--metrics-json``, ``--trace-out``,
  ``--no-share-layout``, ``--aot-cache`` and ``--prewarm-persist`` writes
  both artifacts, which pass the checker; the metrics carry
  ``serve_cold_start_seconds``; the cold-start line has JAX's fields (on
  the CPU no library loads and nothing is captured: all 0).
* The per-call stream serves the same outputs as the shared one (the
  scheduler's report is captured from the run).
* ``--models`` takes the same flags.
* The checker exits 1 with the validator's message on an uncatalogued
  metric name and on a malformed trace, 2 with nothing to check.
* ``--gnn-mesh 2`` serves on two gloo ranks that the launcher starts,
  rank 0 printing the latency line with the mesh and its backend, batched
  and as a stream with arrivals (``--stream``, ``--stream --pipeline`` and
  ``--models``); it takes no ``--arch``; ``--xla-flags-file`` is not
  taken.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.launch import serve as TS
from repro_torch.obs import check_artifacts
from repro_torch.serve import scheduler as TSched

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def no_cache_left(monkeypatch):
    """``--aot-cache`` routes the process's library loads: undo it."""
    monkeypatch.setattr(_build, "_cache", None)


def _artifacts(tmp_path):
    return tmp_path / "metrics.json", tmp_path / "trace.json"


def _run(argv, capsys):
    TS.main(argv)
    return capsys.readouterr().out


def _cold_start(out: str) -> dict:
    line = next(l for l in out.splitlines() if l.startswith("cold_start_s="))
    return {k: float(v) for k, v in (f.split("=") for f in line.split())}


@pytest.mark.parametrize("share", [True, False])
def test_stream_run_writes_artifacts_the_checker_passes(tmp_path, capsys, share):
    metrics, trace = _artifacts(tmp_path)
    argv = ["--gnn", "gin", "--fused", "--stream", "--n-graphs", "12",
            "--device", "cpu", "--aot-cache", str(tmp_path / "aot"),
            "--prewarm-persist", "--metrics-json", str(metrics),
            "--trace-out", str(trace)] + ([] if share else ["--no-share-layout"])
    out = _run(argv, capsys)
    cold = _cold_start(out)
    assert cold["cold_start_s"] > 0
    assert {k: cold[k] for k in ("aot_hit", "aot_miss", "aot_stale", "lowered",
                                 "nvcc_runs")} == dict.fromkeys(
        ("aot_hit", "aot_miss", "aot_stale", "lowered", "nvcc_runs"), 0.0)
    assert "12 graphs" in out and f"metrics-json -> {metrics}" in out
    assert check_artifacts.main(["--metrics-json", str(metrics),
                                 "--trace-out", str(trace)]) == 0
    assert "metrics OK" in capsys.readouterr().out
    doc = json.loads(metrics.read_text())["metrics"]
    gauge = doc["serve_cold_start_seconds"]["series"]
    assert len(gauge) == 1 and gauge[0]["value"] == pytest.approx(cold["cold_start_s"],
                                                                   abs=1e-3)
    assert doc["serve_served_total"]["series"][0]["value"] == 12
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"warm", "executor_run"} <= names
    assert os.path.isdir(tmp_path / "aot")


def test_percall_stream_serves_the_shared_outputs(monkeypatch, capsys):
    reports = []
    run = TSched.StreamScheduler.run

    def spy(self, *args, **kw):
        rep = run(self, *args, **kw)
        reports.append((self.executor.tenant().share_layout, rep))
        return rep

    monkeypatch.setattr(TSched.StreamScheduler, "run", spy)
    argv = ["--gnn", "gat", "--stream", "--qps", "0", "--n-graphs", "10",
            "--device", "cpu"]
    _run(argv, capsys)
    _run(argv + ["--no-share-layout"], capsys)
    (s_shared, shared), (s_percall, percall) = reports
    assert s_shared and not s_percall
    for a, b in zip(shared.outputs, percall.outputs):
        np.testing.assert_array_equal(a, b)


def test_multitenant_takes_the_flags(tmp_path, capsys):
    metrics, trace = _artifacts(tmp_path)
    out = _run(["--models", "gcn:int8,gat:fp32", "--n-graphs", "8", "--device", "cpu",
                "--no-share-layout", "--aot-cache", str(tmp_path / "aot"),
                "--prewarm-persist", "--metrics-json", str(metrics),
                "--trace-out", str(trace)], capsys)
    assert _cold_start(out)["lowered"] == 0
    assert "multi-tenant stream" in out
    assert check_artifacts.main(["--metrics-json", str(metrics),
                                 "--trace-out", str(trace)]) == 0


def test_non_stream_run_prints_the_cache_tally(tmp_path, capsys):
    out = _run(["--gnn", "gcn", "--n-graphs", "4", "--device", "cpu",
                "--aot-cache", str(tmp_path / "aot")], capsys)
    assert "aot: hit 0 miss 0 stale 0; 0 captures" in out


def test_checker_rejects_uncatalogued_metrics_and_bad_traces(tmp_path, capsys):
    metrics, trace = _artifacts(tmp_path)
    _run(["--gnn", "gin", "--stream", "--n-graphs", "4", "--device", "cpu",
          "--metrics-json", str(metrics), "--trace-out", str(trace)], capsys)
    doc = json.loads(metrics.read_text())
    doc["metrics"]["serve_made_up_total"] = doc["metrics"]["serve_warms_total"]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    assert check_artifacts.main(["--metrics-json", str(bad)]) == 1
    out = capsys.readouterr().out
    assert "ERROR: metrics" in out and "serve_made_up_total" in out
    events = json.loads(trace.read_text())
    events["traceEvents"].append({"name": "x", "ph": "Q", "pid": 0, "tid": 0})
    trace.write_text(json.dumps(events))
    assert check_artifacts.main(["--trace-out", str(trace)]) == 1
    assert "unsupported ph 'Q'" in capsys.readouterr().out
    assert check_artifacts.main(["--metrics-json", str(tmp_path / "none.json")]) == 1
    with pytest.raises(SystemExit) as err:
        check_artifacts.main([])
    assert err.value.code == 2


def test_xla_flags_file_is_not_taken(capsys):
    with pytest.raises(SystemExit) as err:
        TS.main(["--gnn", "gin", "--device", "cpu", "--xla-flags-file", "f.json"])
    assert err.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_gnn_mesh_serves_on_two_cpu_ranks(capfd):
    """``--gnn-mesh 2`` starts two gloo ranks and serves batched; rank 0
    alone prints the latency line, with the mesh, its backend and whether
    it captured (gloo: eager)."""
    TS.main(["--gnn", "gin", "--batched", "--gnn-mesh", "2", "--n-graphs", "8",
             "--batch", "4", "--device", "cpu"])
    out = capfd.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("gin batched(bs=4)")]
    assert len(lines) == 1, out
    assert "8 graphs" in lines[0] and lines[0].endswith("mesh=2 backend=gloo captured=False")


@pytest.mark.parametrize("argv", [
    ["--gnn", "gin", "--fused", "--stream", "--max-wait-ms", "0.5", "--slo-ms", "2"],
    ["--models", "gcn:int8,gat:fp32", "--fused"],
    ["--gnn", "gin", "--fused", "--stream", "--pipeline", "--max-wait-ms", "0.5",
     "--slo-ms", "2"],
], ids=["stream", "models", "pipeline"])
def test_gnn_mesh_serves_a_stream_with_arrivals_on_two_cpu_ranks(capfd, argv):
    """With arrivals (qps > 0) the two ranks' schedulers take one schedule
    (each flush's time, and under ``--pipeline`` each flush's host pack
    time, is the slowest rank's), so the stream ends; rank 0 alone prints
    its line, with the mesh and its backend."""
    TS.main(argv + ["--qps", "4000", "--n-graphs", "12", "--gnn-mesh", "2",
                    "--device", "cpu"])
    out = capfd.readouterr().out
    lines = [ln for ln in out.splitlines() if "12 graphs in" in ln]
    assert len(lines) == 1, out
    assert "mesh=2 backend=gloo" in lines[0]


@pytest.mark.parametrize("flag", [
    (["--arch", "chatglm3-6b", "--reduced", "--gnn-mesh", "2"], "not --arch"),
    (["--arch", "chatglm3-6b", "--reduced", "--xla-flags-file", "f.json"],
     "unrecognized arguments"),
])
def test_mesh_and_xla_flags_are_not_taken(flag, capsys):
    """``--gnn-mesh`` on the LM path (it shards GNN forwards), and
    ``--xla-flags-file`` on the LM path."""
    argv, said = flag
    with pytest.raises(SystemExit) as err:
        TS.main(argv + ["--device", "cpu"])
    assert err.value.code == 2
    assert said in capsys.readouterr().err


def test_launcher_and_checker_as_processes(tmp_path):
    """The commands the README gives, as separate processes."""
    metrics, trace = _artifacts(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--gnn", "gin", "--fused",
         "--stream", "--n-graphs", "6", "--device", "cpu", "--aot-cache",
         str(tmp_path / "aot"), "--prewarm-persist", "--metrics-json", str(metrics),
         "--trace-out", str(trace)], capture_output=True, text=True, env=env,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "cold_start_s=" in r.stdout
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.check_artifacts", "--metrics-json",
         str(metrics), "--trace-out", str(trace)], capture_output=True, text=True,
        env=env, timeout=120)
    assert r.returncode == 0 and "trace OK" in r.stdout, r.stdout + r.stderr

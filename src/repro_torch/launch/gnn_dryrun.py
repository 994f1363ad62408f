"""GNN large-graph dry-run (port of ``repro.launch.gnn_dryrun``): the
paper's §4.6 extension at pod scale.

Runs the multi-rank sharded message-passing step
(``runtime.make_sharded_mp``, all-gather strategy) once for a web-scale
graph (2^27 nodes, 2^31 edges, F=256, bf16: ~1000x PubMed) with nodes and
edges cut over every rank of the production mesh flattened to one "graph"
axis, on fake tensors in a fake world of 256 (16x16) or 512 (2x16x16)
ranks, as ``launch/dryrun.py`` runs an LM cell: the graph does not fit a
pod of cards without sharding.  The record is JAX's, its terms the H100's
(``roofline``); ``trace_s`` stands for ``compile_s``.

Two differences from JAX's program, both counted as they happen: the
port's ``shard_map`` returns the global output (one more all-gather, of
the aggregated rows), where JAX's keeps it sharded; and the compute term
counts matmul-class ops only (``roofline.FlopCounter``), of which this
step has none (JAX's cost analysis also counts its elementwise ops).

  PYTHONPATH=src python -m repro_torch.launch.gnn_dryrun [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from repro_torch import roofline as R
from repro_torch.launch import dryrun as DR
from repro_torch.runtime import compat as RTC
from repro_torch.runtime import make_sharded_mp
from repro_torch.runtime.mesh import PRODUCTION_SHAPES, flatten_mesh, make_production_mesh

OUT_DIR = DR.OUT_DIR


def run(multi_pod: bool, log_nodes: int = 27, log_edges: int = 31, feat: int = 256,
        world: int | None = None) -> dict:
    """One record.  ``world`` (default: the production mesh's 256 or 512
    ranks) sets the size of the fake world and of the flat "graph" axis."""
    if world is None:
        shape, _ = PRODUCTION_SHAPES[multi_pod]
        DR.fake_world(math.prod(shape))
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    else:
        DR.fake_world(world)
        mesh = RTC.make_mesh((world,), ("graph",), device="cpu")
    n_ranks = mesh.size
    n, e = 2**log_nodes, 2**log_edges
    # one flat "graph" axis over every rank (nodes and edges sharded)
    flat = flatten_mesh(mesh, "graph")

    def phi(m):  # message transform: one dense layer's worth of work
        return torch.clamp_min(m, 0.0)

    fn = make_sharded_mp(flat, "graph", phi, strategy="allgather")
    flops, colls, mem = R.FlopCounter(), R.CollectiveRecorder(), R.StorageTracker()
    with DR.fake_mode(), DR._dtensor_as_on_cards():
        x = torch.empty((n, feat), dtype=torch.bfloat16)
        src = torch.empty((e,), dtype=torch.int32)
        dst = torch.empty((e,), dtype=torch.int32)
        msk = torch.empty((e,), dtype=torch.bool)
        # a rank's arguments: its block of the node rows and of the edges
        arg_bytes = sum(t.numel() * t.element_size() for t in (x, src, dst, msk)) // n_ranks
        t0 = time.time()
        with torch.no_grad(), flops, colls, mem:
            out = fn(x, src, dst, msk)
        trace_s = round(time.time() - t0, 2)
        out_bytes = out.numel() * out.element_size() // n_ranks  # a rank's rows
        new_out = mem.alive_bytes([out])
    rec = {
        "arch": "gengnn-large-graph",
        "shape": f"n2^{log_nodes}_e2^{log_edges}_f{feat}",
        "mesh": "2x16x16" if multi_pod else "16x16",
        "multi_pod": multi_pod,
        "kind": "gnn_mp_layer",
        "tag": "gnn",
        "trace_s": trace_s,
        "flops_per_device": float(flops.flops),
        "bytes_per_device": float(flops.bytes_accessed),
        "memory": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(max(mem.peak - new_out, 0)),
        },
        "collectives": colls.records,
        "collective_summary": R.summarize_collectives(colls.records),
    }
    if world is not None:
        rec["mesh"] = str(world)
    m = rec["memory"]
    rec["roofline"] = {
        "compute_s": rec["flops_per_device"] / R.PEAK_FLOPS,
        "memory_s": (m["argument_bytes"] + m["output_bytes"] + 2 * m["temp_bytes"]) / R.HBM_BW,
        "collective_s": R.collective_seconds(colls.records),
    }
    return rec


def record_path(rec: dict) -> str:
    mesh = "multi" if rec["multi_pod"] else "single"
    return os.path.join(OUT_DIR, f"gengnn-large__{rec['shape']}__{mesh}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(OUT_DIR, exist_ok=True)
    rec = run(args.multi_pod)
    with open(record_path(rec), "w") as f:
        json.dump(rec, f, indent=1)
    rf = rec["roofline"]
    print(
        f"[ok] gengnn large-graph {rec['mesh']}: trace={rec['trace_s']}s "
        f"args/dev={rec['memory']['argument_bytes']/1e9:.2f}G "
        f"terms(c/m/n)=({rf['compute_s']:.4f},{rf['memory_s']:.4f},{rf['collective_s']:.4f})s "
        f"colls={ {k: v['count'] for k, v in rec['collective_summary'].items()} }"
    )


if __name__ == "__main__":
    main()

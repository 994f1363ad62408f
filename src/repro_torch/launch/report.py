"""Regenerate the dry-run and roofline tables of ``docs/DRYRUN_TORCH.md``
from the port's cached dry-run records (port of ``repro.launch.report``;
JAX's points at an ``EXPERIMENTS.md`` the repository does not hold).

  PYTHONPATH=src python -m repro_torch.launch.report

Each table replaces what follows its marker (``<!-- DRYRUN_TABLE -->``,
``<!-- ROOFLINE_TABLE -->``) up to the next ``## `` heading.  The HBM
column names the H100's 80 GB; ``trace_s`` (the step's one run on fake
tensors) stands where JAX's table has ``compile_s``.
"""
from __future__ import annotations

import glob
import json
import os
import re

from repro_torch.launch.dryrun import CAPACITY_KEY, OUT_DIR

EXP_MD = os.path.join(os.path.dirname(__file__), "../../../docs/DRYRUN_TORCH.md")

SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def load(tag=""):
    recs = []
    for p in sorted(glob.glob(os.path.join(OUT_DIR, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        if r.get("tag", "") == tag:
            recs.append(r)
    recs.sort(key=lambda r: (r["arch"], SHAPE_ORDER.get(r["shape"], 9), r.get("mesh", "")))
    return recs


def _fmt_bytes(b):
    if b >= 1e9:
        return f"{b/1e9:.2f}G"
    if b >= 1e6:
        return f"{b/1e6:.1f}M"
    return f"{b/1e3:.0f}K"


def dryrun_table(recs):
    lines = [
        "| arch | shape | mesh | trace_s | FLOPs/dev | bytes/dev (args/temp) | collectives (count, wire/dev) | HBM est (fits 80G?) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("error"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r.get('mesh','?')} | ERROR | | | {r['error'][:60]} | |")
            continue
        if r.get("skipped"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r.get('mesh','?')} | skip | | | {r['skipped'][:60]} | |")
            continue
        m = r["memory"]
        cs = r["collective_summary"]
        coll = "; ".join(f"{op}×{v['count']} {_fmt_bytes(v['wire_bytes'])}" for op, v in sorted(cs.items()))
        hbm = r.get("hbm_estimate", {})
        fits = f"{_fmt_bytes(hbm.get('total', 0))} ({'yes' if hbm.get(CAPACITY_KEY) else 'NO'})"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['trace_s']} "
            f"| {r['flops_per_device']:.2e} | {_fmt_bytes(m['argument_bytes'])}/{_fmt_bytes(m['temp_bytes'])} "
            f"| {coll or '—'} | {fits} |"
        )
    return "\n".join(lines)


def roofline_table(recs):
    lines = [
        "| arch | shape | mesh | compute_s | memory_s | collective_s | bound | step LB (s) | useful-FLOPs ratio | what would move the bound |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("error") or r.get("skipped"):
            continue
        if r.get("mesh") != "16x16":
            continue  # the roofline table is the single pod's
        rf = r["roofline"]
        note = _bound_note(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {rf['compute_s']:.4f} | {rf['memory_s']:.4f} "
            f"| {rf['collective_s']:.4f} | **{rf['bound']}** | {rf['step_lower_bound_s']:.4f} "
            f"| {rf.get('useful_flops_ratio', 0):.3f} | {note} |"
        )
    return "\n".join(lines)


def _bound_note(r):
    rf = r["roofline"]
    if rf["bound"] == "collective":
        return "reduce TP activation all-reduce (seq-parallel / FSDP-style rules / bf16 grads)"
    if rf["bound"] == "memory" and r["kind"] == "decode":
        return "decode is weight+cache streaming: batch up / quantize cache"
    if rf["bound"] == "memory":
        return "shard the replicated attention or cut remat traffic"
    return "already compute-bound: fuse/overlap remaining collectives"


def fill(md: str, recs) -> str:
    """``md`` with both tables written after their markers."""
    for marker, table in (("<!-- DRYRUN_TABLE -->", dryrun_table(recs)),
                          ("<!-- ROOFLINE_TABLE -->", roofline_table(recs))):
        md = re.sub(re.escape(marker) + r".*?(?=\n## |\Z)",
                    lambda _m, mk=marker, t=table: mk + "\n\n" + t + "\n\n", md, flags=re.S)
    return md


def main(argv=None):
    recs = load()
    with open(EXP_MD) as f:
        md = f.read()
    with open(EXP_MD, "w") as f:
        f.write(fill(md, recs))
    print(f"updated {EXP_MD} with {len(recs)} records")


if __name__ == "__main__":
    main()

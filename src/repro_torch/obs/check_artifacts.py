"""Validate the telemetry artifacts a stream run of the port's launcher wrote
(the port's counterpart of ``tools/check_telemetry_artifacts.py``).

Loads the ``--metrics-json`` snapshot and/or the ``--trace-out``
trace-event JSON and checks them with the port's validators
(``obs/export.py``): the metrics document must be ``repro-metrics/v1``
with every metric name in the closed catalog (``obs.metrics.CATALOG``; an
unregistered name fails: the metric surface is an API), and the trace
document must be well-formed Chrome/Perfetto trace events.  Exits 1 with
the validator's message on any defect.

  PYTHONPATH=src python -m repro_torch.obs.check_artifacts \\
      --metrics-json /tmp/metrics.json --trace-out /tmp/trace.json
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.obs import export


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--metrics-json", help="repro-metrics/v1 snapshot to check")
    ap.add_argument("--trace-out", help="Chrome trace-event JSON to check")
    args = ap.parse_args(argv)
    if not args.metrics_json and not args.trace_out:
        ap.error("nothing to check: pass --metrics-json and/or --trace-out")

    failures = 0
    checks = ((args.metrics_json, "metrics", export.validate_metrics_snapshot,
               "catalog metrics"),
              (args.trace_out, "trace", export.validate_trace_events, "events"))
    for path, what, validate, unit in checks:
        if not path:
            continue
        try:
            n = validate(json.loads(Path(path).read_text()))
            print(f"{what} OK: {path} ({n} {unit})")
        except (OSError, ValueError) as err:
            print(f"ERROR: {what} {path}: {err}")
            failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

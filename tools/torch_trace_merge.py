#!/usr/bin/env python
"""Merge per-rank mxtel journals into one clock-aligned timeline.

The port's copy of ``tools/trace_merge.py``, over the port's journals:
a multi-process job writes one journal per rank
(``MXNET_TELEMETRY_JOURNAL`` with ``{rank}`` templating); this tool stitches
them together using the clock-offset estimates embedded in each
journal's coordinator-RPC ``clock`` records, attributes each rank's
epochs to barrier-wait vs compute (naming the straggler the group was
rendezvousing on — or the killed rank whose journal truncates), and
optionally exports a Chrome trace-event JSON loadable in Perfetto
(https://ui.perfetto.dev).

Usage::

    python tools/torch_trace_merge.py run-0.jsonl run-1.jsonl \\
        run-2.jsonl run-3.jsonl --chrome merged.json

    # then: open https://ui.perfetto.dev and load merged.json

The merge machinery lives in ``mxnet_tpu_torch/telemetry/merge.py`` (a
byte copy of the JAX package's, shared with
tools/torch_telemetry_report.py's cross-rank section); it is loaded by
file path so this tool never imports torch just to read JSONL.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_merge_module():
    """The telemetry.merge module, loaded standalone by file path —
    journal post-processing must not pay (or require) the full
    framework import. Falls back to the package import for installed
    wheels, where the source tree layout is absent."""
    path = os.path.join(REPO, "mxnet_tpu_torch", "telemetry", "merge.py")
    if os.path.exists(path):
        spec = importlib.util.spec_from_file_location("_mxtel_merge", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    from mxnet_tpu_torch.telemetry import merge as mod  # installed wheel

    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="merge per-rank mxtel journals into one clock-aligned "
                    "timeline (straggler attribution + Perfetto export)")
    ap.add_argument("journals", nargs="+",
                    help="per-rank JSONL journals (MXNET_TELEMETRY_JOURNAL "
                         "with {rank} templating)")
    ap.add_argument("--chrome", metavar="OUT.json",
                    help="write the merged timeline as Chrome trace-event "
                         "JSON (load in https://ui.perfetto.dev)")
    ap.add_argument("--json", action="store_true",
                    help="emit the attribution report as JSON instead of "
                         "the text summary")
    args = ap.parse_args(argv)

    m = load_merge_module()
    merged = m.merge(args.journals)
    if not merged["spans"]:
        print("torch_trace_merge: no spans in %d journal(s) — was "
              "MXNET_TELEMETRY=1 + MXNET_TELEMETRY_JOURNAL set?"
              % len(args.journals), file=sys.stderr)
        return 1
    if args.json:
        rows = m.epoch_rows(merged)
        print(json.dumps({
            "ranks": m.cross_rank_rows(merged),
            "epochs": rows,
            "report": m.straggler_report(merged, rows),
        }, indent=1))
    else:
        print("\n".join(m.render_summary(merged)))
    if args.chrome:
        trace = m.chrome_trace(merged)
        with open(args.chrome, "w", encoding="utf-8") as f:
            json.dump(trace, f)
        print("torch_trace_merge: wrote %d trace events to %s (open in "
              "https://ui.perfetto.dev)"
              % (len(trace["traceEvents"]), args.chrome), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

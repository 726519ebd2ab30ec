#!/usr/bin/env python
"""Render an mxtel run journal of the port: throughput timeline, top
spans, percentile tables.

The port's copy of ``tools/telemetry_report.py``. The journal
(MXNET_TELEMETRY=1 + MXNET_TELEMETRY_JOURNAL=<path>) is JSONL: ``span`` records for every
finished trace scope and ``metrics`` records snapshotting the counter/
gauge/histogram registry. This tool turns one into the three views a
run post-mortem starts from:

1. throughput timeline — train.samples_per_sec across the run's metric
   snapshots (an ASCII bar per snapshot; spots warmup, stalls, decay);
2. top spans by total time — where the wall clock actually went,
   with count / total / mean / max per span name;
3. percentile tables — p50/p95/p99/max for every histogram in the final
   snapshot (per-task engine latency, batch fetch, step time, ...),
   plus the final counter and gauge values.

Journals carrying serving or control-plane activity additionally get a
serving section (tokens/s timeline, TTFT percentiles) and an mxctl
section: the controller's decision journal rendered as a timeline —
rule fired -> action taken -> outcome -> recovery, trace ids linking
each firing to the affected replica's spans. Journals with live
weight-sync records get a wsync section: the version timeline
(published -> staged -> applied / rejected / aborted / rolled back,
one trace id per transaction) plus the final wsync.* counters.

Given SEVERAL journals (one per rank of an elastic job), a cross-rank
section is prepended: per-rank step-time / barrier-wait table plus the
straggler attribution, sharing tools/torch_trace_merge.py's merge
machinery (clock offsets from coordinator-RPC clock records).

Journals with mxprof records (MXNET_PROF=1) get a profiling section:
the step-time decomposition per path with its bound verdict, the top
programs by device time with their analytic FLOPs, the device memory
peak and the derived MFU.

Usage::

    python tools/torch_telemetry_report.py run.jsonl
    python tools/torch_telemetry_report.py run.jsonl --top 20
    python tools/torch_telemetry_report.py run-{0,1,2,3}.jsonl   # cross-rank
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_trace_merge import load_merge_module  # noqa: E402

THROUGHPUT_GAUGE = "train.samples_per_sec"
BAR_WIDTH = 40


def load(path):
    """Parse a journal into a list of records (bad lines are counted,
    not fatal: a run killed mid-write leaves a torn last line)."""
    records, bad = [], 0
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                bad += 1
    if bad:
        print("torch_telemetry_report: skipped %d unparseable line(s) in %s"
              % (bad, path), file=sys.stderr)
    return records


def span_table(records, top=10):
    """Aggregate span records: name -> count/total/mean/max, ranked by
    total time."""
    agg = {}
    for r in records:
        if r.get("kind") != "span":
            continue
        a = agg.setdefault(r["name"], [0, 0.0, 0.0])
        a[0] += 1
        a[1] += r.get("dur", 0.0)
        a[2] = max(a[2], r.get("dur", 0.0))
    ranked = sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]
    return [
        {"name": name, "count": c, "total": t, "mean": t / c, "max": mx}
        for name, (c, t, mx) in ranked
    ]


def metrics_records(records):
    return [r for r in records if r.get("kind") == "metrics"]


def final_metrics(records):
    """The last metrics snapshot — counters are cumulative, so the
    newest record carries the run's final values."""
    ms = metrics_records(records)
    return ms[-1] if ms else None


def throughput_timeline(records):
    """[(t, samples_per_sec)] across metric snapshots that carry the
    throughput gauge."""
    out = []
    for r in metrics_records(records):
        v = r.get("gauges", {}).get(THROUGHPUT_GAUGE)
        if v is not None:
            out.append((r.get("t", 0.0), float(v)))
    return out


def comm_compression(records):
    """(wire_bytes, logical_bytes) from the final snapshot's kvstore
    byte counters, or None when the run had no accounted gradient
    traffic. wire < logical means the low-precision codec
    (MXNET_KV_QUANTIZE) was shrinking the TCP bytes."""
    final = final_metrics(records)
    if final is None:
        return None
    counters = final.get("counters", {})
    logical = counters.get("kvstore.logical_bytes_total", 0)
    if not logical:
        return None
    return counters.get("kvstore.wire_bytes_total", 0), logical


def serving_timeline(records):
    """[(t, serving.tokens_per_s)] across metric snapshots — the served
    throughput over the run (bench_serve.py journals; spots admission
    stalls, eviction storms, drain phases)."""
    out = []
    for r in metrics_records(records):
        v = r.get("gauges", {}).get("serving.tokens_per_s")
        if v is not None:
            out.append((r.get("t", 0.0), float(v)))
    return out


def serving_section(records):
    """Rendered lines for the serving engine, or [] when the journal
    has no serving.* metrics."""
    final = final_metrics(records)
    if final is None:
        return []
    counters = final.get("counters", {})
    gauges = final.get("gauges", {})
    hists = final.get("histograms", {})
    has = any(k.startswith("serving.")
              for d in (counters, gauges, hists) for k in d)
    if not has:
        return []
    lines = ["", "-- serving engine (mxserve) --"]
    timeline = serving_timeline(records)
    if timeline:
        t0 = timeline[0][0]
        vmax = max(v for _, v in timeline)
        lines.append("  tokens/s timeline:")
        for t, v in timeline:
            lines.append("    t+%8.1fs %12.2f %s" % (t - t0, v,
                                                     _bar(v, vmax)))
    lat_rows = [("ttft", "serving.ttft_s"),
                ("per-token", "serving.token_latency_s")]
    have_lat = [r for r in lat_rows if r[1] in hists]
    if have_lat:
        lines.append("  %-12s %8s %10s %10s %10s %10s" % (
            "latency", "count", "p50_s", "p95_s", "p99_s", "max_s"))
        for label, name in have_lat:
            s = hists[name]
            lines.append("  %-12s %8d %10.6g %10.6g %10.6g %10.6g" % (
                label, s.get("count", 0), s.get("p50") or 0,
                s.get("p95") or 0, s.get("p99") or 0, s.get("max") or 0))
    util = gauges.get("serving.kv_pool_utilization")
    if util is not None:
        lines.append("  kv pool: %.1f%% utilized (hwm %g blocks)"
                     % (100.0 * util,
                        gauges.get("serving.kv_pool_hwm_blocks", 0)))
    reqs = sorted((k, v) for k, v in counters.items()
                  if k.startswith("serving.requests_"))
    if reqs:
        lines.append("  requests: " + "  ".join(
            "%s=%d" % (k.split("requests_")[-1], v) for k, v in reqs))
    drafted = counters.get("serving.spec_tokens_drafted")
    if drafted:
        acc = counters.get("serving.spec_tokens_accepted", 0)
        spec_h = hists.get("serving.spec_accepted_tokens", {})
        lines.append(
            "  speculative: %d turns, accept rate %.3f "
            "(%d/%d drafts), accepted/turn p50 %g"
            % (counters.get("serving.spec_turns", 0),
               acc / float(drafted), acc, drafted,
               spec_h.get("p50") or 0))
    return lines


def prof_records(records):
    return [r for r in records if r.get("kind") == "prof"]


def profiling_section(records):
    """Rendered lines for the mxprof attribution layer (MXNET_PROF=1),
    or [] when the journal carries no ``prof`` records: step-time
    decomposition per path (host / dispatch / device / d2h shares + the
    input-vs-compute-vs-host-bound verdict), top programs by accumulated
    device time with their analytic flops/bytes, and the device memory
    peak line."""
    profs = prof_records(records)
    if not profs:
        return []
    lines = ["", "-- profiling (mxprof) --"]
    # step-breakdown table: the shared fold (merge.fold_breakdowns —
    # same implementation the cross-rank prof_rows uses)
    paths = load_merge_module().fold_breakdowns(profs)
    dev_by_key = {}
    for r in profs:
        if r.get("event") != "step_breakdown" or not r.get("key"):
            continue
        d = dev_by_key.setdefault(r["key"], [0, 0.0])
        d[0] += 1
        d[1] += (r.get("phases") or {}).get("device", 0.0)
    if paths:
        phase_names = ("host", "dispatch", "device", "d2h", "update")
        lines.append("  %-14s %6s %8s %10s" % ("path", "steps", "batches",
                                               "total_s")
                     + "".join(" %9s" % ("%s%%" % p) for p in phase_names)
                     + "  bound")
        for path in sorted(paths):
            st = paths[path]
            tot = st["total"] or 1e-12
            verdict = max(st["bound"], key=lambda b: st["bound"][b]) \
                if st["bound"] else "?"
            lines.append(
                "  %-14s %6d %8d %10.3f" % (path, st["count"],
                                            st["batches"], st["total"])
                + "".join(" %8.1f%%"
                          % (100.0 * st["phases"].get(p, 0.0) / tot)
                          for p in phase_names)
                + "  %s-bound" % verdict)
    # top programs by device time (program records carry the static
    # cost; the step records above carry the measured device seconds)
    progs = {r["key"]: r for r in profs
             if r.get("event") == "program" and r.get("key")}
    if progs:
        ranked = sorted(
            progs.values(),
            key=lambda r: -dev_by_key.get(r["key"], [0, 0.0])[1])
        lines.append("  top programs by device time:")
        lines.append("  %-24s %6s %12s %14s %14s" % (
            "site", "calls", "device_s", "flops", "bytes_accessed"))
        for r in ranked[:10]:
            calls, dev = dev_by_key.get(r["key"], [0, 0.0])
            lines.append("  %-24s %6d %12.4f %14.6g %14.6g" % (
                r.get("site", "?"), calls, dev, r.get("flops") or 0,
                r.get("bytes_accessed") or 0))
    hbm_peaks = [s.get("gauges", {}).get("prof.hbm_peak_bytes")
                 for s in metrics_records(records)]
    hbm_peaks = [v for v in hbm_peaks if v]
    firsts = [((r.get("memory") or {}).get("first_call_peak_bytes") or 0)
              for r in progs.values()]
    if hbm_peaks:
        lines.append("  device memory peak: %s (allocator)"
                     % _human_bytes(max(hbm_peaks)))
    elif any(firsts):
        lines.append("  device memory peak: %s (largest program's first "
                     "call)" % _human_bytes(max(firsts)))
    final = final_metrics(records)
    gauges = (final or {}).get("gauges", {})
    if gauges.get("prof.mfu") is not None:
        lines.append("  derived: MFU %.4f%s" % (
            gauges["prof.mfu"],
            ("  roofline %.1f%%" % gauges["prof.roofline_pct"])
            if gauges.get("prof.roofline_pct") is not None else ""))
    return lines


def controller_section(records):
    """Rendered lines for the mxctl decision journal, or [] when the
    journal has no control-plane records: the detect->decide->act->
    recover timeline (rule fired -> action taken -> outcome), with each
    firing's trace id — the same id the affected replica's own spans
    can be grepped for."""
    events = [r for r in records
              if r.get("kind") == "span"
              and str(r.get("name", "")).startswith("mxctl.")
              and r.get("name") != "mxctl.probe_error"]
    final = final_metrics(records)
    counters = (final or {}).get("counters", {})
    mx_counters = {k: v for k, v in sorted(counters.items())
                   if k.startswith("mxctl.")}
    if not events and not mx_counters:
        return []
    lines = ["", "-- control plane (mxctl) --"]
    events.sort(key=lambda r: r.get("t", 0.0))
    t0 = events[0].get("t", 0.0) if events else 0.0
    for e in events:
        dt = e.get("t", 0.0) - t0
        name = e["name"]
        if name == "mxctl.rule":
            lines.append(
                "  t+%7.1fs RULE    %s on %-8s %s=%.4g (threshold %s%g)"
                "  [trace %s]"
                % (dt, e.get("rule", "?"), e.get("target", "?"),
                   e.get("metric", "?"), e.get("value", float("nan")),
                   e.get("op", "?"), e.get("threshold", float("nan")),
                   e.get("trace")))
        elif name == "mxctl.action":
            extra = ""
            if e.get("pid"):
                extra = " pid %s->%s" % (e.get("old_pid"), e.get("pid"))
            if e.get("error"):
                extra += " (%s)" % e["error"]
            lines.append(
                "  t+%7.1fs ACTION  %s on %-8s -> %s in %.2fs%s"
                % (dt, e.get("action", "?"), e.get("target", "?"),
                   e.get("outcome", "?"), e.get("dur", 0.0), extra))
        elif name == "mxctl.recovery":
            lines.append(
                "  t+%7.1fs RECOVER %-8s healthy %.1fs after %s"
                "  [trace %s]"
                % (dt, e.get("target", "?"), e.get("dur", 0.0),
                   e.get("action", "the action"), e.get("trace")))
        else:
            lines.append("  t+%7.1fs %s %s"
                         % (dt, name, e.get("target", "")))
    if mx_counters:
        lines.append("  counters: " + "  ".join(
            "%s=%d" % (k.split("mxctl.")[-1], v)
            for k, v in mx_counters.items()))
    return lines


def wsync_section(records):
    """Rendered lines for the live weight-sync layer, or [] when the
    journal has no ``{"kind": "wsync"}`` records: the version timeline
    (published -> staged -> applied / rejected / aborted, plus
    rollbacks), one line per transition with the transaction's trace id
    — the same id every record of one sync transaction shares — and
    the final wsync.* counters."""
    events = [r for r in records if r.get("kind") == "wsync"]
    final = final_metrics(records)
    counters = {k: v
                for k, v in sorted(((final or {}).get("counters",
                                                      {})).items())
                if k.startswith("wsync.")}
    if not events and not counters:
        return []
    lines = ["", "-- weight sync (wsync) --"]
    events.sort(key=lambda r: r.get("t", 0.0))
    t0 = events[0].get("t", 0.0) if events else 0.0
    lines.append("  version timeline:")
    for e in events:
        dt = e.get("t", 0.0) - t0
        ev = e.get("event", "?")
        v = e.get("version")
        if ev == "published":
            detail = "%d tensors, %s%s" % (
                e.get("tensors", 0), _human_bytes(e.get("bytes", 0)),
                ", +draft" if e.get("draft") else "")
        elif ev == "staged":
            detail = "%d/%d tensors fetched (%s; rest delta-skipped)" % (
                e.get("fetched", 0), e.get("tensors", 0),
                _human_bytes(e.get("bytes", 0)))
        elif ev == "applied":
            detail = "ring depth %d%s" % (
                e.get("ring", 0), ", +draft" if e.get("draft") else "")
        elif ev in ("rejected", "aborted"):
            detail = e.get("reason", "?")
            if ev == "aborted":
                detail += " (after %d tensors)" % e.get("fetched", 0)
        elif ev == "rolled_back":
            detail = "from version %s" % (e.get("from_version"),)
        elif ev == "ack":
            detail = "rank %s -> %s" % (e.get("rank"), e.get("outcome"))
        else:
            detail = ""
        trace = e.get("trace")
        lines.append("  t+%7.1fs %-11s v%-5s %s%s" % (
            dt, ev.upper(), v if v is not None else "-", detail,
            ("  [trace %s]" % trace) if trace else ""))
    gauges = (final or {}).get("gauges", {})
    cur = gauges.get("wsync.current_version")
    pub = gauges.get("wsync.published_version")
    if cur is not None or pub is not None:
        lines.append("  final: engine on v%s, publisher at v%s" % (
            int(cur) if cur is not None else "?",
            int(pub) if pub is not None else "?"))
    if counters:
        lines.append("  counters: " + "  ".join(
            "%s=%d" % (k.split("wsync.")[-1], v)
            for k, v in counters.items()))
    hists = (final or {}).get("histograms", {})
    s = hists.get("serving.ttft_sync_s")
    if s:
        lines.append("  TTFT inside sync windows: count %d p50 %.6g "
                     "p99 %.6g max %.6g (perf_gate ttft_sync_p99_s)"
                     % (s.get("count", 0), s.get("p50") or 0,
                        s.get("p99") or 0, s.get("max") or 0))
    return lines


def _human_bytes(n):
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024.0 or unit == "GB":
            return "%.1f%s" % (n, unit) if unit != "B" else "%dB" % n
        n /= 1024.0


def _bar(v, vmax):
    if vmax <= 0:
        return ""
    return "#" * max(1, int(round(BAR_WIDTH * v / vmax)))


def render_report(records, top=10):
    lines = ["=== mxtel run report ==="]
    n_spans = sum(1 for r in records if r.get("kind") == "span")
    lines.append("records: %d (%d spans, %d metric snapshots)"
                 % (len(records), n_spans, len(metrics_records(records))))

    timeline = throughput_timeline(records)
    lines.append("")
    lines.append("-- throughput timeline (%s) --" % THROUGHPUT_GAUGE)
    if timeline:
        t0 = timeline[0][0]
        vmax = max(v for _, v in timeline)
        for t, v in timeline:
            lines.append("  t+%8.1fs %12.2f %s" % (t - t0, v, _bar(v, vmax)))
    else:
        lines.append("  (no throughput samples in journal)")

    comm = comm_compression(records)
    if comm is not None:
        lines.append("")
        lines.append("-- gradient wire compression (MXNET_KV_QUANTIZE) --")
        wire, logical = comm
        lines.append(
            "  wire %s / logical %s = %.3fx on the wire (%.1fx "
            "compression)"
            % (_human_bytes(wire), _human_bytes(logical),
               wire / logical, logical / wire if wire else float("inf")))

    lines.extend(profiling_section(records))
    lines.extend(serving_section(records))
    lines.extend(wsync_section(records))
    lines.extend(controller_section(records))

    lines.append("")
    lines.append("-- top spans by total time --")
    spans = span_table(records, top=top)
    if spans:
        lines.append("  %-30s %8s %12s %12s %12s" % (
            "span", "count", "total_s", "mean_s", "max_s"))
        for s in spans:
            lines.append("  %-30s %8d %12.6g %12.6g %12.6g" % (
                s["name"], s["count"], s["total"], s["mean"], s["max"]))
    else:
        lines.append("  (no spans in journal)")

    lines.append("")
    lines.append("-- percentile tables (final snapshot) --")
    final = final_metrics(records)
    if final is None:
        lines.append("  (no metrics snapshot in journal)")
        return "\n".join(lines)
    hists = final.get("histograms", {})
    if hists:
        lines.append("  %-42s %8s %10s %10s %10s %10s" % (
            "histogram", "count", "p50", "p95", "p99", "max"))
        for name in sorted(hists):
            s = hists[name]
            lines.append("  %-42s %8d %10.6g %10.6g %10.6g %10.6g" % (
                name, s.get("count", 0), s.get("p50") or 0,
                s.get("p95") or 0, s.get("p99") or 0, s.get("max") or 0))
    else:
        lines.append("  (no histograms)")
    counters = final.get("counters", {})
    if counters:
        lines.append("")
        lines.append("-- counters (final) --")
        for name in sorted(counters):
            lines.append("  %-42s %d" % (name, counters[name]))
    gauges = final.get("gauges", {})
    if gauges:
        lines.append("")
        lines.append("-- gauges (final) --")
        for name in sorted(gauges):
            lines.append("  %-42s %g" % (name, gauges[name]))
    return "\n".join(lines)


def cross_rank_section(journals):
    """Rendered lines for the multi-journal (per-rank) view: step-time/
    barrier-wait table + straggler attribution via the trace_merge
    machinery."""
    m = load_merge_module()
    merged = m.merge(journals)
    lines = ["", "-- cross-rank (%d journals) --" % len(journals)]
    lines.append("  %-5s %10s %8s %8s %12s %12s %8s" % (
        "rank", "offset_s", "epochs", "batches", "step_p50_s",
        "wait_total_s", "spans"))
    for r in m.cross_rank_rows(merged):
        lines.append("  %-5d %+10.3f %8d %8d %12s %12.3f %8d" % (
            r["rank"], r["offset_s"], r["epochs"], r["batches"],
            ("%.6g" % r["step_p50_s"]) if r["step_p50_s"] is not None
            else "-", r["wait_s"], r["spans"]))
    rep = m.straggler_report(merged)
    if rep["truncated"]:
        lines.append("  truncated journals (killed rank?): %s"
                     % rep["truncated"])
    if rep["straggler"] is not None:
        lines.append("  straggler: rank %d" % rep["straggler"])
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="render an mxtel run journal (JSONL)")
    ap.add_argument("journals", nargs="+", metavar="journal",
                    help="path(s) written via MXNET_TELEMETRY_JOURNAL — "
                         "several journals add the cross-rank section")
    ap.add_argument("--top", type=int, default=10,
                    help="span rows in the top-spans table (default 10)")
    args = ap.parse_args(argv)
    # single-rank body from the first NON-empty journal: in a chaos run
    # one rank's journal may be empty (SIGKILLed before its first
    # flush) and the cross-rank view over the healthy journals is
    # exactly what diagnoses it
    records, base = None, None
    for j in args.journals:
        recs = load(j)
        if recs:
            records, base = recs, j
            break
    if records is None:
        print("torch_telemetry_report: no records in %s"
              % ", ".join(args.journals), file=sys.stderr)
        return 1
    out = render_report(records, top=args.top)
    if len(args.journals) > 1:
        lines = out.split("\n")
        out = "\n".join([lines[0] + "  (single-rank body: %s)" % base]
                        + cross_rank_section(args.journals) + lines[1:])
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

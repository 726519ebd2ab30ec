"""Multi-rank journal merging: clock alignment, straggler attribution,
Chrome trace export.

Each rank of an elastic job writes its own JSONL journal (per-rank
``{rank}`` templating in tools/launch.py); this module stitches N of
them into ONE timeline:

1. **Clock alignment.** Every rank's wall clock drifts independently;
   naively overlaying journals misorders events across ranks. The
   elastic client journals ``clock`` records for fast coordinator RPCs
   — ``(t0, t1, srv_t)`` where t0/t1 bracket the round trip on the
   caller's clock and srv_t is the coordinator's clock at reply time.
   Each sample bounds the offset to ``srv_t - (t0+t1)/2`` within half
   the RTT (the classic NTP estimate); the per-rank offset is the
   median over all samples, and every rank maps onto the
   *coordinator's* clock: ``t_aligned = t + offset``.

2. **Barrier-wait vs compute attribution.** The elastic kvstore wraps
   its blocked-on-peers time in ``kvstore.round_wait`` /
   ``kvstore.barrier_wait`` spans (WAIT_SPANS). Summing those inside
   each rank's ``epoch`` span splits the epoch into wait and compute —
   the rank everyone else waits ON shows the *least* wait (it is the
   straggler); a killed rank's journal simply stops (truncation is the
   strongest straggler signal of all).

3. **Chrome trace-event export.** ``chrome_trace()`` renders the merged
   timeline as Chrome trace-event JSON (one "process" per rank, one
   "thread" per journal thread), loadable directly in Perfetto
   (https://ui.perfetto.dev) — the workflow documented in
   docs/how_to/observability.md.

Pure stdlib (json/math) so tools/trace_merge.py and
tools/telemetry_report.py can import it without the jax stack.
"""
from __future__ import annotations

import json
import os
import re

__all__ = ["WAIT_SPANS", "load_journal", "clock_offset", "merge",
           "epoch_rows", "straggler_report", "cross_rank_rows",
           "prof_rows", "chrome_trace", "render_summary"]

#: span names that mean "blocked waiting on peers" (not computing)
WAIT_SPANS = ("kvstore.round_wait", "kvstore.barrier_wait")

_RANK_RE = re.compile(r"(\d+)\.jsonl$")


def load_journal(path):
    """One journal -> {"path", "rank", "records"}. Bad lines (a rank
    SIGKILLed mid-write leaves a torn tail) are skipped, not fatal; a
    missing file is an empty journal (the killed-before-first-flush
    case). Rank comes from the journal's own ``meta`` record, falling
    back to a trailing ``<digits>.jsonl`` in the file name."""
    records = []
    if os.path.exists(path):
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    pass
    rank = None
    for r in records:
        if r.get("kind") == "meta" and "rank" in r:
            rank = int(r["rank"])
            break
    if rank is None:
        m = _RANK_RE.search(os.path.basename(path))
        if m:
            rank = int(m.group(1))
    return {"path": path, "rank": rank, "records": records}


def clock_offset(records):
    """(median offset to the coordinator clock, sample count). Offset
    0.0 with no samples — single-host runs share a clock anyway."""
    offs = sorted(
        r["srv_t"] - (r["t0"] + r["t1"]) / 2.0
        for r in records
        if r.get("kind") == "clock" and "srv_t" in r)
    if not offs:
        return 0.0, 0
    n = len(offs)
    mid = n // 2
    med = offs[mid] if n % 2 else (offs[mid - 1] + offs[mid]) / 2.0
    return med, n


def merge(paths):
    """Merge journals into one clock-aligned timeline.

    Returns ``{"ranks": {rank: info}, "spans": [...]}`` where each span
    record gains ``rank`` and ``t_aligned`` (coordinator-clock start)
    and the merged list is sorted by aligned start time. ``info`` per
    rank: path, offset, clock_samples, spans, records, last_t (aligned
    time of the journal's final record — the truncation signal)."""
    ranks = {}
    for i, path in enumerate(paths):
        j = load_journal(path)
        rank = j["rank"] if j["rank"] is not None else i
        while rank in ranks:  # duplicate/unknown ranks never clobber
            rank += len(paths)
        off, n = clock_offset(j["records"])
        spans = []
        last_t = None
        for r in j["records"]:
            t = r.get("t") or r.get("t1")
            if t is not None:
                at = t + off
                last_t = at if last_t is None else max(last_t, at)
            if r.get("kind") == "span":
                s = dict(r)
                s["rank"] = rank
                s["t_aligned"] = r["t"] + off
                spans.append(s)
        ranks[rank] = {
            "path": path, "offset": off, "clock_samples": n,
            "spans": spans, "records": j["records"], "last_t": last_t,
        }
    merged = sorted((s for info in ranks.values() for s in info["spans"]),
                    key=lambda s: s["t_aligned"])
    return {"ranks": ranks, "spans": merged}


def epoch_rows(merged):
    """Per (rank, epoch-index) attribution rows: each rank's n-th
    ``epoch`` span split into barrier-wait (WAIT_SPANS inside the epoch
    window) and compute."""
    rows = []
    for rank in sorted(merged["ranks"]):
        spans = merged["ranks"][rank]["spans"]
        epochs = sorted((s for s in spans if s["name"] == "epoch"),
                        key=lambda s: s["t_aligned"])
        waits = [s for s in spans if s["name"] in WAIT_SPANS]
        batches = [s for s in spans if s["name"] in ("batch", "chunk")]
        for i, ep in enumerate(epochs):
            lo, hi = ep["t_aligned"], ep["t_aligned"] + ep["dur"]
            wait = sum(s["dur"] for s in waits
                       if lo <= s["t_aligned"] <= hi)
            nb = sum(1 for s in batches if lo <= s["t_aligned"] <= hi)
            rows.append({
                "rank": rank, "epoch": i, "start": lo, "dur": ep["dur"],
                "wait_s": wait, "compute_s": max(0.0, ep["dur"] - wait),
                "wait_frac": (wait / ep["dur"]) if ep["dur"] > 0 else 0.0,
                "batches": nb,
            })
    return rows


def straggler_report(merged, rows=None):
    """Who was everyone waiting on?

    Three signals, strongest first:

    - **truncation** — a rank whose journal stops well before the
      merged horizon was killed (or wedged): the ultimate straggler;
    - **incomplete epochs** — a rank that closed fewer ``epoch`` spans
      than its peers dropped out mid-run (an epoch span only lands on
      exit, so a killed rank's final epoch never closes);
    - **least wait** — per epoch, the rank with the smallest
      barrier-wait total is the one its peers rendezvoused on.

    Returns {"straggler": rank|None, "truncated": [...],
    "incomplete": [...],
    "per_epoch": [{"epoch", "straggler", "waits": {rank: s}}]}.
    """
    rows = epoch_rows(merged) if rows is None else rows
    last = {r: info["last_t"] for r, info in merged["ranks"].items()
            if info["last_t"] is not None}
    truncated = []
    if last:
        horizon = max(last.values())
        starts = [s["t_aligned"] for s in merged["spans"]]
        length = (horizon - min(starts)) if starts else 0.0
        gate = max(2.0, 0.2 * length)
        truncated = sorted(r for r, t in last.items()
                           if horizon - t > gate)
    epochs_per_rank = {r: 0 for r in merged["ranks"]}
    for row in rows:
        epochs_per_rank[row["rank"]] = max(
            epochs_per_rank.get(row["rank"], 0), row["epoch"] + 1)
    incomplete = []
    if epochs_per_rank and len(set(epochs_per_rank.values())) > 1:
        most = max(epochs_per_rank.values())
        incomplete = sorted(r for r, n in epochs_per_rank.items()
                            if n < most)
    per_epoch = []
    by_epoch = {}
    for row in rows:
        by_epoch.setdefault(row["epoch"], {})[row["rank"]] = row
    for ep in sorted(by_epoch):
        waits = {r: row["wait_s"] for r, row in by_epoch[ep].items()}
        if len(waits) < 2:
            continue
        straggler = min(waits, key=lambda r: (waits[r], r))
        per_epoch.append({"epoch": ep, "straggler": straggler,
                          "waits": waits})
    overall = None
    if truncated:
        overall = truncated[0]
    elif incomplete:
        overall = incomplete[0]
    elif per_epoch:
        votes = {}
        for e in per_epoch:
            votes[e["straggler"]] = votes.get(e["straggler"], 0) + 1
        overall = max(sorted(votes), key=lambda r: votes[r])
    # boundedness labels from the mxprof step-breakdown rows
    # (MXNET_PROF=1): an *input*-bound "straggler" is input starvation
    # — the fix is the data plane (shards, credits, prefetch), not
    # evict-replace — so the attribution carries the distinction
    # instead of letting a stalled input pipeline read as a slow rank.
    # Verdicts are weighted by each path's total seconds: a rank's few
    # host-bound eval steps must not outvote its dominant training path.
    votes = {}
    for row in prof_rows(merged):
        b = row.get("bound")
        if b:
            w = votes.setdefault(row["rank"], {})
            w[b] = w.get(b, 0.0) + float(row.get("total_s") or 0.0) \
                + 1e-12
    bounds = {rank: max(sorted(w), key=lambda b: w[b])
              for rank, w in votes.items()}
    return {"straggler": overall, "truncated": truncated,
            "incomplete": incomplete, "per_epoch": per_epoch,
            "bounds": bounds,
            "straggler_bound": bounds.get(overall)}


def cross_rank_rows(merged):
    """Per-rank summary for telemetry_report's cross-rank section:
    span/batch counts, epoch count, total barrier wait, and the final
    snapshot's ``train.step_secs`` p50."""
    out = []
    for rank in sorted(merged["ranks"]):
        info = merged["ranks"][rank]
        spans = info["spans"]
        final = None
        for r in info["records"]:
            if r.get("kind") == "metrics":
                final = r
        step_p50 = None
        if final:
            h = final.get("histograms", {}).get("train.step_secs")
            if h:
                step_p50 = h.get("p50")
        out.append({
            "rank": rank, "path": info["path"],
            "offset_s": info["offset"],
            "clock_samples": info["clock_samples"],
            "spans": len(spans),
            "batches": sum(1 for s in spans
                           if s["name"] in ("batch", "chunk")),
            "epochs": sum(1 for s in spans if s["name"] == "epoch"),
            "wait_s": sum(s["dur"] for s in spans
                          if s["name"] in WAIT_SPANS),
            "step_p50_s": step_p50,
            "last_t": info["last_t"],
        })
    return out


def fold_breakdowns(records):
    """Fold ``prof.step_breakdown`` journal records (MXNET_PROF=1,
    docs/how_to/profiling.md) into per-path aggregates:
    ``{path: {count, batches, total, phases: {p: secs},
    bound: {verdict: votes}}}``. THE one implementation of this fold —
    telemetry_report's profiling section and the cross-rank
    :func:`prof_rows` both consume it, so the single-journal and merged
    reports can never disagree about the same records."""
    per_path = {}
    for r in records:
        if r.get("kind") != "prof" or r.get("event") != "step_breakdown":
            continue
        st = per_path.setdefault(r.get("path", "?"), {
            "count": 0, "batches": 0, "total": 0.0, "phases": {},
            "bound": {}})
        st["count"] += 1
        st["batches"] += r.get("batches", 1)
        st["total"] += r.get("total_s", 0.0)
        for p, v in (r.get("phases") or {}).items():
            st["phases"][p] = st["phases"].get(p, 0.0) + v
        b = r.get("bound", "?")
        st["bound"][b] = st["bound"].get(b, 0) + 1
    return per_path


def prof_rows(merged):
    """Per-(rank, path) mxprof step-breakdown attribution rows — the
    cross-rank form of the ``prof.step_breakdown`` journal records.
    Each row: phase-share percentages plus the majority
    input/compute/host-bound verdict, so a merged timeline says not
    just WHO straggled but what kind of bound each rank ran at."""
    rows = []
    for rank in sorted(merged["ranks"]):
        per_path = fold_breakdowns(merged["ranks"][rank]["records"])
        for path in sorted(per_path):
            st = per_path[path]
            tot = st["total"] or 1e-12
            rows.append({
                "rank": rank, "path": path, "steps": st["count"],
                "batches": st["batches"], "total_s": st["total"],
                "phase_share": {p: v / tot
                                for p, v in st["phases"].items()},
                "bound": max(st["bound"], key=lambda b: st["bound"][b])
                if st["bound"] else None,
            })
    return rows


def chrome_trace(merged):
    """Chrome trace-event JSON (Perfetto-loadable): one process per
    rank, one thread per journal thread, one complete ("X") event per
    span with the trace id in args."""
    spans = merged["spans"]
    t0 = min((s["t_aligned"] for s in spans), default=0.0)
    events = []
    tids = {}
    for rank in sorted(merged["ranks"]):
        events.append({"ph": "M", "name": "process_name", "pid": rank,
                       "tid": 0, "args": {"name": "rank %d" % rank}})
    for s in spans:
        key = (s["rank"], s.get("thread", "MainThread"))
        tid = tids.get(key)
        if tid is None:
            tid = tids[key] = sum(1 for k in tids if k[0] == s["rank"])
            events.append({"ph": "M", "name": "thread_name",
                           "pid": s["rank"], "tid": tid,
                           "args": {"name": key[1]}})
        args = {"trace": s.get("trace"), "id": s.get("id")}
        if s.get("parent") is not None:
            args["parent"] = s["parent"]
        if s.get("remote_parent") is not None:
            args["remote_parent"] = s["remote_parent"]
        events.append({
            "ph": "X", "name": s["name"], "pid": s["rank"], "tid": tid,
            "ts": (s["t_aligned"] - t0) * 1e6,
            "dur": max(0.0, s.get("dur", 0.0)) * 1e6,
            "cat": s["name"].split(".")[0],
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def render_summary(merged, top_traces=5):
    """Human-readable merged-timeline summary lines (the trace_merge
    CLI's stdout; chaos.py greps the straggler line)."""
    rows = epoch_rows(merged)
    rep = straggler_report(merged, rows)
    lines = ["=== merged timeline (%d ranks, %d spans) ==="
             % (len(merged["ranks"]), len(merged["spans"]))]
    for r in cross_rank_rows(merged):
        lines.append(
            "rank %-3d offset %+8.3fs (%d clock samples)  spans %-6d "
            "batches %-5d epochs %-2d wait %8.3fs"
            % (r["rank"], r["offset_s"], r["clock_samples"], r["spans"],
               r["batches"], r["epochs"], r["wait_s"]))
    if rows:
        lines.append("")
        lines.append("-- per-epoch barrier-wait vs compute --")
        lines.append("  %-5s %-6s %10s %10s %10s %6s %8s" % (
            "rank", "epoch", "dur_s", "wait_s", "compute_s", "wait%",
            "batches"))
        for row in rows:
            lines.append("  %-5d %-6d %10.3f %10.3f %10.3f %5.1f%% %8d" % (
                row["rank"], row["epoch"], row["dur"], row["wait_s"],
                row["compute_s"], 100.0 * row["wait_frac"],
                row["batches"]))
    profs = prof_rows(merged)
    if profs:
        lines.append("")
        lines.append("-- per-rank step decomposition (mxprof) --")
        lines.append("  %-5s %-14s %6s %9s %9s %9s %9s %9s  %s" % (
            "rank", "path", "steps", "host%", "disp%", "dev%", "d2h%",
            "upd%", "bound"))
        for row in profs:
            sh = row["phase_share"]
            lines.append(
                "  %-5d %-14s %6d %8.1f%% %8.1f%% %8.1f%% %8.1f%% "
                "%8.1f%%  %s-bound"
                % (row["rank"], row["path"], row["steps"],
                   100 * sh.get("host", 0.0), 100 * sh.get("dispatch", 0.0),
                   100 * sh.get("device", 0.0), 100 * sh.get("d2h", 0.0),
                   100 * sh.get("update", 0.0), row["bound"]))
    lines.append("")
    if rep["truncated"]:
        lines.append("truncated journals (killed/wedged rank?): %s"
                     % rep["truncated"])
    if rep["incomplete"]:
        lines.append("incomplete-epoch ranks (dropped out mid-run): %s"
                     % rep["incomplete"])
    for e in rep["per_epoch"]:
        lines.append("epoch %d straggler: rank %d (waits: %s)"
                     % (e["epoch"], e["straggler"],
                        {r: round(w, 3)
                         for r, w in sorted(e["waits"].items())}))
    if rep["straggler"] is not None:
        bound = rep.get("straggler_bound")
        note = ""
        if rep["straggler"] in rep["truncated"]:
            note = " (journal truncated — killed?)"
        elif bound == "input":
            # input stall != straggler: the rank is starved by the data
            # plane, not slow — evicting it would fix nothing
            note = (" [input-bound — input starvation, not a compute "
                    "straggler: check the data service (mxdata.* "
                    "stalls), not the rank]")
        elif bound is not None:
            note = " [%s-bound]" % bound
        lines.append("straggler: rank %d%s" % (rep["straggler"], note))
    else:
        lines.append("straggler: none identified")
    return lines

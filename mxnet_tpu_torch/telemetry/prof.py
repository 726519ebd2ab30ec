"""mxprof: continuous performance & memory attribution (``MXNET_PROF=1``).

Counterpart of ``mxnet_tpu/telemetry/prof.py``. mxtel records *that*
time passed; mxprof attributes *where* a training or serving step's time
and device memory go. Like the rest of the telemetry subsystem it is
always available and **off by default**: with ``MXNET_PROF`` unset
every instrumented site reduces to one module-bool check.

Three views, keyed as the JAX package keys them:

1. **Per-program cost records.** The port runs no compiled program: a
   step is the executor's graph walk, the scanned fit's K queued steps,
   the serving model's bucketed step. Their call sites hand each such
   program to :func:`attribute_program` once, which records its analytic
   cost (``flops`` and ``bytes_accessed`` from :func:`graph_cost`, or the
   call site's own count) under ``<config_key_prefix()>|<site
   signature>[|g=<graph key>]`` and returns the callable unchanged. The
   JAX package's record carries XLA's ``cost_analysis()`` and
   ``memory_analysis()`` of the compiled program instead; the port has
   neither, so the fields of XLA's memory analysis (``argument_size``,
   ``output_size``, ``temp_size``, ``alias_size``,
   ``generated_code_size``, ``static_peak``) are left out, not invented.
   In their place :func:`measure_first_call` records the first call's
   measured device memory (``memory.first_call_peak_bytes``, the
   allocator's peak during the call, and ``memory.first_call_delta_bytes``,
   that peak less what was allocated before it) where the program runs
   on a card.

2. **Analytic graph cost.** :func:`graph_cost` walks a Symbol DAG with
   the compile layer's shape and dtype sweeps (``compile/ir.py``'s
   ``propagate_shapes``/``propagate_dtypes``) and computes per-node
   FLOPs/bytes from the op metadata alone — no device. The numbers are
   the JAX package's, node for node.

3. **Step-time decomposition.** The train and serving step paths feed
   :func:`note_step` fenced sub-phase durations — ``host`` (input
   prep/staging), ``dispatch`` (queueing the step's kernels), ``device``
   (the wait on the card's stream: time truly blocked on the device),
   ``d2h`` (result pull + metric fence), ``update`` (optimizer/kvstore,
   per-batch path only). Each call lands a ``{"kind": "prof", "event":
   "step_breakdown"}`` journal record plus ``prof.step.<phase>_secs``
   histograms, and classifies the step as input-/compute-/host-bound.

Derived headline metrics — MFU against the card's bf16 peak and
roofline% against its memory bandwidth — live in :func:`peak_flops`,
:func:`hbm_gbps` and :func:`derived`. The defaults are the H100 SXM's
(NVIDIA data sheet, dense bf16 at the 700 W limit: 989e12 FLOP/s; HBM3:
3,350 GB/s); the JAX package's ResNet-50 roofline constant
(``ROOFLINE_IMG_S``) was derived for another chip and is left out.

Enablement::

    MXNET_PROF=1                    # master switch (off by default)
    MXNET_PROF_PEAK_FLOPS=9.89e14   # optional: peak override
    MXNET_PROF_HBM_GBPS=3350        # optional: bandwidth override

With ``MXNET_TELEMETRY=1`` as well, prof metrics land in the registry /
journal / ``/profilez``; prof alone still accumulates its in-process
program and step tables (``snapshot()``).
"""
from __future__ import annotations

import contextlib
import hashlib
import logging
import os
import threading
import time

__all__ = [
    "ENABLED", "reload", "reset",
    "graph_cost", "attribute_program", "measure_first_call",
    "program_records", "program_key_for", "config_key_prefix",
    "symbol_fingerprint", "graph_hash",
    "note_step", "step_summary",
    "peak_flops", "hbm_gbps", "hbm_stats", "derived", "snapshot",
    "DEFAULT_PEAK_BF16", "DEFAULT_HBM_GBPS", "PHASES",
]

log = logging.getLogger("mxnet_tpu_torch.prof")

#: H100 SXM dense bf16 peak (NVIDIA data sheet, 700 W) — the MFU
#: denominator; chip_smoke.PEAK_BF16 is the same figure.
DEFAULT_PEAK_BF16 = 989e12
#: H100 SXM HBM3 bandwidth (GB/s) — the roofline denominator
#: (chip_smoke.PEAK_BYTES / 1e9).
DEFAULT_HBM_GBPS = 3350.0

#: the fenced sub-phases a step decomposes into (note_step keys)
PHASES = ("host", "dispatch", "device", "d2h", "update")

#: phase -> boundedness verdict when it dominates the step
_BOUND_BY_PHASE = {
    "host": "input",      # staging/input prep dominates: input-bound
    "dispatch": "host",   # python dispatch overhead dominates
    "device": "compute",  # blocked on the device: compute-bound
    "d2h": "host",        # result pull / metric fence dominates
    "update": "host",
}

ENABLED = False

_lock = threading.Lock()
#: key -> program record dict (attribute_program)
_programs = {}
#: path -> {"count", "batches", "phases": {p: total}, "total": s,
#:          "bound": {verdict: count}}
_steps = {}
#: note_step throttles the derived()/hbm_stats() gauge refresh to ~1 Hz
_GAUGE_REFRESH_SECS = 1.0
_last_gauge_t = 0.0
#: fresh attributions performed (NOT memo hits). Step instrumentation
#: snapshots this around a step and skips the breakdown record when it
#: advanced: a program's first call (allocator growth, cuDNN's algorithm
#: search, kernel builds) would dominate the phase shares.
_attr_calls = 0


def attribution_count():
    """Number of fresh attribute_program records — call sites bracket a
    step with it to drop first-call-polluted breakdown records."""
    return _attr_calls


def _env_on(name):
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "off", "no")


def reload():
    """Re-read ``MXNET_PROF``; called from ``telemetry.reload()``."""
    global ENABLED
    ENABLED = _env_on("MXNET_PROF")
    return ENABLED


def reset():
    """Drop program/step state (test isolation; rides
    ``telemetry.reset()``)."""
    global _last_gauge_t
    with _lock:
        _programs.clear()
        _steps.clear()
        _last_gauge_t = 0.0


# -- derived-metric constants -------------------------------------------------
def _env_float(name, default):
    raw = os.environ.get(name, "").strip()
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return default


def peak_flops():
    """Peak FLOP/s for MFU: ``MXNET_PROF_PEAK_FLOPS``, else the H100
    SXM's dense bf16 peak (989e12)."""
    return _env_float("MXNET_PROF_PEAK_FLOPS", DEFAULT_PEAK_BF16)


def hbm_gbps():
    """Memory bandwidth (GB/s) for roofline%: ``MXNET_PROF_HBM_GBPS``,
    else the H100 SXM's HBM3 (3,350)."""
    return _env_float("MXNET_PROF_HBM_GBPS", DEFAULT_HBM_GBPS)


# -- analytic graph cost ------------------------------------------------------
def _prod(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _itemsize(dt):
    try:
        import numpy as np

        return int(np.dtype(dt).itemsize)
    except Exception:
        try:
            return int(dt.itemsize)   # a torch dtype
        except Exception:
            return 4


def _node_flops(n, out_shape, in_shapes):
    """Forward FLOPs for one node from its op metadata + shapes (the
    standard conventions: 2·M·N·K for matmuls/convs, a few ops per
    element for normalization/softmax, one per element otherwise)."""
    op = n.op.name
    p = n.params
    if out_shape is None:
        return 0
    size = _prod(out_shape)
    if op in ("Convolution", "Deconvolution"):
        kernel = p.get("kernel") or ()
        group = int(p.get("num_group") or 1)
        cin = None
        if in_shapes and in_shapes[0] is not None and len(in_shapes[0]) >= 2:
            cin = int(in_shapes[0][1])
        if cin is None or not kernel:
            return 2 * size
        return 2 * size * (cin // max(group, 1)) * _prod(kernel)
    if op == "FullyConnected":
        if in_shapes and in_shapes[0] is not None:
            d_in = _prod(in_shapes[0][1:])
            return 2 * size * d_in
        return 2 * size
    if op == "BatchNorm":
        return 8 * size
    if op == "Pooling":
        kernel = p.get("kernel") or ()
        if p.get("global_pool") and in_shapes and in_shapes[0] is not None:
            return _prod(in_shapes[0])
        return size * max(1, _prod(kernel))
    if op in ("SoftmaxOutput", "Softmax", "SoftmaxActivation",
              "LogisticRegressionOutput", "LinearRegressionOutput",
              "MAERegressionOutput", "log_softmax", "softmax"):
        return 5 * size
    if op in ("Concat", "Reshape", "Flatten", "transpose", "SliceChannel",
              "expand_dims", "BlockGrad", "Cast", "_copy"):
        return 0  # pure data movement: bytes, not flops
    return size


def graph_cost(symbol, input_shapes, input_types=None):
    """Analytic per-node FLOPs/bytes for a Symbol graph. Returns::

        {"nodes": [{"name", "op", "flops", "bytes", "out_shape"}...],
         "flops": <forward total>, "flops_train": <~3x forward>,
         "bytes": <total moved>, "params_bytes": <weight footprint>,
         "unresolved": <nodes whose shapes stayed unknown>}

    Nodes whose shapes cannot be recovered contribute zero (and are
    counted in ``unresolved``)."""
    import numpy as np

    from ..compile.ir import propagate_dtypes, propagate_shapes

    nodes = symbol.nodes
    name_to_var = {n.name: n for n in nodes if n.is_variable}
    seed = {}
    for name, shape in (input_shapes or {}).items():
        v = name_to_var.get(name)
        if v is not None and shape is not None:
            seed[(id(v), 0)] = tuple(shape)
    shapes = propagate_shapes(nodes, seed)
    tseed = {}
    for name, t in (input_types or {}).items():
        v = name_to_var.get(name)
        if v is not None and t is not None:
            tseed[(id(v), 0)] = _np_dtype(t)
    dtypes = propagate_dtypes(nodes, tseed)

    out = []
    total_flops = 0
    total_bytes = 0
    unresolved = 0
    params_bytes = 0
    input_names = set(input_shapes or ())
    for n in nodes:
        if n.is_variable:
            s = shapes.get((id(n), 0))
            if s is not None and n.name not in input_names:
                params_bytes += _prod(s) * _itemsize(
                    dtypes.get((id(n), 0), np.float32))
            continue
        out_shape = shapes.get((id(n), 0))
        in_shapes = [shapes.get((id(s), i)) for s, i in n.inputs]
        if out_shape is None:
            unresolved += 1
        flops = _node_flops(n, out_shape, in_shapes)
        nbytes = 0
        for (s, i), sh in zip(n.inputs, in_shapes):
            if sh is not None:
                nbytes += _prod(sh) * _itemsize(
                    dtypes.get((id(s), i), np.float32))
        n_out = len(n.op.list_outputs(n.params))
        for i in range(n_out):
            sh = shapes.get((id(n), i))
            if sh is not None:
                nbytes += _prod(sh) * _itemsize(
                    dtypes.get((id(n), i), np.float32))
        total_flops += flops
        total_bytes += nbytes
        out.append({
            "name": n.name, "op": n.op.name, "flops": int(flops),
            "bytes": int(nbytes),
            "out_shape": list(out_shape) if out_shape is not None else None,
        })
    out.sort(key=lambda r: -r["flops"])
    return {
        "nodes": out,
        "flops": int(total_flops),
        # fwd+bwd ≈ 3x fwd for matmul-dominated graphs
        "flops_train": int(3 * total_flops),
        "bytes": int(total_bytes),
        "params_bytes": int(params_bytes),
        "unresolved": unresolved,
    }


def _np_dtype(t):
    """A numpy dtype for a numpy/str/torch dtype (torch's by name;
    bfloat16, which numpy lacks, stays the torch dtype)."""
    import numpy as np

    try:
        return np.dtype(t)
    except TypeError:
        name = str(t).replace("torch.", "")
        try:
            return np.dtype(name)
        except TypeError:
            return t


# -- program attribution -------------------------------------------------------
def config_key_prefix():
    """The compile layer's configuration key (``compile.config_key()``),
    as in the JAX package: program records and the persistent cache's
    entries share a key root. The device is not in it: the cubin
    cache's entries carry the architecture and the NVRTC version, and
    the tuning database's the card's name."""
    try:
        from .. import compile as _compile

        return _compile.config_key()
    except Exception:
        return "v1|opt=?"


def graph_hash(text):
    """Short stable hash of a graph-identity string — the component of
    a program key that distinguishes two programs whose shape
    signatures coincide."""
    return hashlib.sha1(str(text).encode("utf-8", "replace")) \
        .hexdigest()[:12]


def symbol_fingerprint(sym):
    """Graph-identity hash of a Symbol: op names, node names, FULL op
    params and wiring."""
    lines = []
    for n in sym.nodes:
        ins = ",".join("%s[%d]" % (s.name, i) for s, i in n.inputs)
        if n.is_variable:
            lines.append("var %s %r" % (n.name, sorted(n.attrs.items())))
        else:
            lines.append("%s %s %r %r (%s)" % (
                n.op.name, n.name, sorted(n.params.items()),
                sorted(n.attrs.items()), ins))
    return graph_hash("\n".join(lines))


def program_key_for(key, graph_key=None):
    """The full (config-prefixed) key :func:`attribute_program` stores
    ``key`` under — call sites pass it back to :func:`note_step`."""
    full_key = "%s|%s" % (config_key_prefix(), key)
    if graph_key:
        full_key += "|g=%s" % graph_key
    return full_key


def attribute_program(key, fn, site="", analytic=None, meta=None,
                      graph_key=None, flops=None, bytes_accessed=None):
    """Record one program's cost under ``<config_key>|<key>[|g=...]``
    and return ``fn`` unchanged (the port's counterpart of the JAX
    package's ``attribute_jit``, which AOT-compiles and returns the
    compiled callable). ``flops``/``bytes_accessed``: the program's
    work per call as the call site counts it (the scanned fit counts K
    training steps); default ``analytic``'s forward totals. A repeated
    key is a memo hit: nothing is recorded again. Never raises into a
    step."""
    global _attr_calls
    full_key = program_key_for(key, graph_key)
    with _lock:
        if full_key in _programs:
            return fn
        _attr_calls += 1
        rec = {
            "key": full_key, "site": site or key, "t": time.time(),
            "calls": 0, "device_secs": 0.0,
            "meta": dict(meta or {}),
        }
        if flops is None and analytic:
            flops = analytic.get("flops")
        if bytes_accessed is None and analytic:
            bytes_accessed = analytic.get("bytes")
        if flops is not None:
            rec["flops"] = float(flops)
        if bytes_accessed is not None:
            rec["bytes_accessed"] = float(bytes_accessed)
        if analytic:
            rec["analytic"] = {
                "flops": analytic.get("flops"),
                "flops_train": analytic.get("flops_train"),
                "bytes": analytic.get("bytes"),
                "params_bytes": analytic.get("params_bytes"),
                "top_ops": analytic.get("nodes", [])[:12],
            }
        _programs[full_key] = rec
    _emit(dict(rec, kind="prof", event="program"))
    return fn


@contextlib.contextmanager
def measure_first_call(full_key, device):
    """Around a program's call: on its first call on a card, record the
    allocator's peak during the call into the program record's
    ``memory`` (``first_call_peak_bytes``, ``first_call_delta_bytes``).
    Resets the allocator's peak counter; a no-op on the host, with prof
    off, or once the record has its memory."""
    with _lock:
        rec = _programs.get(full_key)
        todo = (ENABLED and rec is not None and "memory" not in rec
                and getattr(device, "type", str(device)).startswith("cuda"))
    if not todo:
        yield
        return
    import torch

    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    yield
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    with _lock:
        rec["memory"] = {"first_call_peak_bytes": int(peak),
                         "first_call_delta_bytes": int(peak - base)}


def program_records(top=None):
    """Program records sorted by accumulated device seconds (then
    flops) — the ``/profilez`` "top programs" table."""
    with _lock:
        recs = [dict(r) for r in _programs.values()]
    recs.sort(key=lambda r: (-r.get("device_secs", 0.0),
                             -(r.get("flops") or 0)))
    return recs if top is None else recs[:top]


# -- step-time decomposition --------------------------------------------------
def _emit(record):
    from . import export as _export

    _export.emit(record)


def note_step(path, phases, key=None, batches=1, samples=None,
              tokens=None, d2h_bytes=None):
    """Record one decomposed step (or K-batch chunk).

    ``phases``: {phase: seconds} with phases from :data:`PHASES`.
    Accumulates the per-path aggregate, attributes the ``device`` phase
    to the program record under ``key``, observes
    ``prof.step.<phase>_secs`` + ``prof.step_secs`` histograms and
    refreshes the derived gauges (``prof.mfu`` etc.) when telemetry is
    on, and emits one ``step_breakdown`` journal record. ``d2h_bytes``:
    the result bytes the step pulled device->host. A no-op with prof
    off."""
    if not ENABLED:
        return None
    total = sum(phases.values())
    dominant = max(phases, key=lambda p: phases[p]) if phases else None
    bound = _BOUND_BY_PHASE.get(dominant, "unknown")
    with _lock:
        st = _steps.get(path)
        if st is None:
            st = _steps[path] = {
                "count": 0, "batches": 0, "total": 0.0,
                "phases": {}, "bound": {},
            }
        st["count"] += 1
        st["batches"] += int(batches)
        st["total"] += total
        for p, v in phases.items():
            st["phases"][p] = st["phases"].get(p, 0.0) + float(v)
        st["bound"][bound] = st["bound"].get(bound, 0) + 1
        if key is not None:
            prog = _programs.get(key)
            if prog is not None:
                prog["calls"] += 1
                prog["device_secs"] += float(phases.get("device", 0.0))
    from .. import telemetry as _tel

    if _tel.ENABLED:
        _tel.histogram("prof.step_secs").observe(total)
        for p, v in phases.items():
            _tel.histogram("prof.step.%s_secs" % p).observe(v)
        global _last_gauge_t
        now = time.monotonic()
        with _lock:
            refresh = now - _last_gauge_t >= _GAUGE_REFRESH_SECS
            if refresh:
                _last_gauge_t = now
        if refresh:
            d = derived()
            if d.get("mfu") is not None:
                _tel.gauge("prof.mfu").set(d["mfu"])
            if d.get("roofline_pct") is not None:
                _tel.gauge("prof.roofline_pct").set(d["roofline_pct"])
            hbm = hbm_stats()
            if hbm.get("live_bytes") is not None:
                _tel.gauge("prof.hbm_live_bytes").set(hbm["live_bytes"])
            if hbm.get("peak_bytes") is not None:
                _tel.gauge("prof.hbm_peak_bytes").set(hbm["peak_bytes"])
    rec = {
        "kind": "prof", "event": "step_breakdown", "t": time.time(),
        "path": path, "batches": int(batches), "total_s": total,
        "phases": {p: float(v) for p, v in phases.items()},
        "bound": bound,
    }
    if key is not None:
        rec["key"] = key
    if samples is not None and total > 0:
        rec["samples_per_s"] = samples / total
    if tokens is not None and total > 0:
        rec["tokens_per_s"] = tokens / total
    if d2h_bytes is not None:
        rec["d2h_bytes"] = int(d2h_bytes)
    _emit(rec)
    return rec


def step_summary():
    """{path: aggregate} — per-path phase totals, mean shares, and the
    majority boundedness verdict."""
    with _lock:
        out = {}
        for path, st in _steps.items():
            total = st["total"] or 1e-12
            shares = {p: v / total for p, v in st["phases"].items()}
            verdict = max(st["bound"], key=lambda b: st["bound"][b]) \
                if st["bound"] else None
            out[path] = {
                "count": st["count"], "batches": st["batches"],
                "total_s": st["total"],
                "phases_s": dict(st["phases"]),
                "phase_share": shares,
                "bound": verdict,
                "bound_votes": dict(st["bound"]),
            }
        return out


# -- derived metrics + device memory ------------------------------------------
def hbm_stats():
    """{"live_bytes", "peak_bytes", "source"} — the card's allocator
    (``torch.cuda.memory_stats``) when a card is in use, else the largest
    first-call peak the attributed programs recorded, else nothing."""
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            ms = torch.cuda.memory_stats()
            if ms and "allocated_bytes.all.current" in ms:
                return {
                    "live_bytes": int(ms["allocated_bytes.all.current"]),
                    "peak_bytes": int(ms.get("allocated_bytes.all.peak",
                                             ms["allocated_bytes.all.current"])),
                    "source": "device",
                }
    except Exception:
        pass
    with _lock:
        peaks = [r.get("memory", {}).get("first_call_peak_bytes")
                 for r in _programs.values()]
    peaks = [p for p in peaks if p]
    if peaks:
        return {"live_bytes": None, "peak_bytes": max(peaks),
                "source": "first_call_peak"}
    return {"live_bytes": None, "peak_bytes": None, "source": "none"}


def derived():
    """Headline derivations over the attributed programs:

    - ``mfu``: executed FLOPs / device seconds / peak, over every program
      with measured device time;
    - ``roofline_pct``: achieved bytes/s as % of the memory bandwidth;
    - ``tflops`` beside ``mfu``."""
    with _lock:
        recs = [dict(r) for r in _programs.values()]
    flops_done = 0.0
    bytes_done = 0.0
    dev_secs = 0.0
    for r in recs:
        calls, ds = r.get("calls", 0), r.get("device_secs", 0.0)
        if not calls or ds <= 0:
            continue
        if r.get("flops"):
            flops_done += r["flops"] * calls
        if r.get("bytes_accessed"):
            bytes_done += r["bytes_accessed"] * calls
        dev_secs += ds
    out = {
        "peak_flops": peak_flops(),
        "hbm_gbps": hbm_gbps(),
        "device_secs": dev_secs,
        "mfu": None,
        "roofline_pct": None,
    }
    if dev_secs > 0 and flops_done > 0:
        out["mfu"] = flops_done / dev_secs / peak_flops()
        out["tflops"] = flops_done / dev_secs / 1e12
    if dev_secs > 0 and bytes_done > 0:
        out["roofline_pct"] = (100.0 * bytes_done / dev_secs
                               / (hbm_gbps() * 1e9))
    return out


def snapshot(top=20):
    """The ``/profilez`` body: program table, step decomposition,
    derived MFU/roofline, device memory. Valid (``enabled: false``)
    when prof is off — introspection never errors."""
    return {
        "enabled": ENABLED,
        "config_key": config_key_prefix(),
        "programs": program_records(top=top),
        "steps": step_summary(),
        "derived": derived(),
        "hbm": hbm_stats(),
    }


reload()

"""Runtime compile/transfer verifier (``MXNET_JIT_VERIFY``).

Counterpart of ``mxnet_tpu/analysis/compile_verify.py``: it watches the
port's program boundaries *live* and catches the two dynamic failure
modes a static pass cannot — a "recompile" triggered by an
actually-varying value, and a hot-path device->host transfer whose byte
volume breaks the token-vector-only contract of the serving decode
step.

Activated by ``MXNET_JIT_VERIFY``:

- unset/``0`` — completely off: :func:`wrap` returns the callable it
  was given, :func:`d2h_region` is a no-op context; zero overhead.
- ``record`` — count and journal, never raise: every boundary keeps a
  per-callable compile counter; a compile past the declared budget
  journals a ``jit_verify`` record with the exact arg-signature diff
  (which argument changed shape/dtype/device/static value vs the
  closest previously-seen signature) and lands in the ambient
  :func:`unexpected` list.
- ``1`` (any other truthy) — as ``record``, plus raises
  :class:`JitVerifyError` at the offending dispatch so the stack trace
  points at the caller that broke the bucket contract.

What a "compile" is: torch builds no program per signature, and its
callables have no ``_cache_size()``. A boundary counts a compile when
it sees an argument signature it has not seen before — each array's
shape, dtype and device, and each static value — which is the JAX
module's own fallback for callables without a cache. The boundaries
are placed where the JAX package's jitted programs are, with the same
names and budgets, so the counts mean what they mean there: one per
bucket, and a second means a caller leaked a varying value into a
fixed-shape contract.

Budgets come from the bucket sets: each memoized program gets a default
budget of one compile (the memo key IS the bucket), and a wiring site
may declare a group-level budget (``declare_budget("serve.step",
len(batch_buckets) * (len(chunk_buckets) + 1))``) that
:func:`check_budgets` audits.

The D2H ledger is the transfer half: hot regions open
``with d2h_region("serve.decode_step", budget_bytes=...)`` and every
accounted pull calls :func:`note_d2h(nbytes, site)`. A region closing
over budget is a violation (journaled / raised like a recompile).
Observed sites are kept by id (:func:`observed_d2h_sites`); the JAX
package's cross-check of them against ``jit_lint``'s statically
sanctioned sites is not ported (``jit_lint`` is not).

Ambient state (unexpected recompiles, D2H violations, observed sites)
is module-global and deliberately survives ``telemetry.reset()``. Only
an explicit :func:`reset` clears it.

Counters (telemetry catalog): ``compile.recompiles_total``,
``jit.verify_compiles_total``, ``jit.verify_recompiles_total``,
``jit.verify_d2h_bytes_total``, ``jit.verify_d2h_violations_total``.
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager

__all__ = [
    "ENV", "ENABLED", "MODE", "reload", "reset", "JitVerifyError",
    "wrap", "unwrap", "rebind", "Boundary", "declare_budget",
    "check_budgets", "d2h_region", "note_d2h", "observed_d2h_sites",
    "unexpected", "d2h_violations", "expecting_violations", "summary",
]

ENV = "MXNET_JIT_VERIFY"

_OFF_VALUES = ("", "0", "false", "off", "no")


def _env_mode():
    v = os.environ.get(ENV, "").strip().lower()
    if v in _OFF_VALUES:
        return ""
    return "record" if v == "record" else "raise"


MODE = _env_mode()
ENABLED = bool(MODE)


def reload():
    """Re-read ``MXNET_JIT_VERIFY`` (tests flip the env mid-process).
    Already-wrapped boundaries keep verifying; only new :func:`wrap`
    calls and region entries observe the change."""
    global MODE, ENABLED
    MODE = _env_mode()
    ENABLED = bool(MODE)
    return ENABLED


class JitVerifyError(RuntimeError):
    """An unexpected recompile past budget, or a hot-region D2H ledger
    over its byte budget, under MXNET_JIT_VERIFY=1."""


# -- ambient state (survives telemetry.reset; cleared only by reset()) --------
_lock = threading.Lock()
_BOUNDARIES = []        # every live Boundary, for summary()
_GROUP_BUDGETS = {}     # group -> declared compile budget
_GROUP_COMPILES = {}    # group -> observed compiles
_UNEXPECTED = []        # unexpected-recompile records (suite gate reads)
_D2H_VIOLATIONS = []    # over-budget region records (suite gate reads)
_OBSERVED_D2H = {}      # site -> {"bytes": int, "count": int}
_DIVERT = None          # expecting_violations() redirect target
_tls = threading.local()


def reset():
    """Clear ambient verifier state (counts, ledgers, budgets). Used by
    tests that need a pristine gate; the conftest suite gate relies on
    this NOT happening implicitly."""
    global _DIVERT
    with _lock:
        del _BOUNDARIES[:]
        _GROUP_BUDGETS.clear()
        _GROUP_COMPILES.clear()
        del _UNEXPECTED[:]
        del _D2H_VIOLATIONS[:]
        _OBSERVED_D2H.clear()
        _DIVERT = None


def _counter(name):
    # mxtel-metrics: compile.recompiles_total jit.verify_compiles_total
    # mxtel-metrics: jit.verify_recompiles_total jit.verify_d2h_bytes_total
    # mxtel-metrics: jit.verify_d2h_violations_total
    from .. import telemetry as _tel
    return _tel.counter(name)


def _journal(record):
    from ..telemetry import export as _export
    _export.emit(record)


def _record_violation(kind, rec):
    """Route a violation: into the expecting_violations() capture when
    one is open (negative-control tests), else into the ambient list +
    journal, raising in raise-mode."""
    rec = dict(rec, event=kind)
    with _lock:
        target = _DIVERT
        if target is not None:
            target.append(rec)
            return False
        if kind == "unexpected_recompile":
            _UNEXPECTED.append(rec)
        else:
            _D2H_VIOLATIONS.append(rec)
    _journal(dict(rec, kind="jit_verify"))
    return MODE == "raise"


# -- argument signatures -------------------------------------------------------

def _sig_of(value, depth=0):
    shape = getattr(value, "shape", None)
    dtype = getattr(value, "dtype", None)
    if shape is not None and dtype is not None:
        # torch tensors carry their device; numpy arrays live on the host
        return ("A", tuple(shape), str(dtype).replace("torch.", ""),
                str(getattr(value, "device", "cpu")))
    if depth < 2:
        if isinstance(value, (tuple, list)):
            return ("T", tuple(_sig_of(v, depth + 1) for v in value))
        if isinstance(value, dict):
            return ("D", tuple(sorted(
                (str(k), _sig_of(v, depth + 1)) for k, v in value.items())))
    if isinstance(value, (int, float, bool, str, bytes, type(None))):
        return ("S", value)
    return ("O", type(value).__name__)


def _signature(args, kwargs):
    sig = [(("arg[%d]" % i), _sig_of(a)) for i, a in enumerate(args)]
    sig.extend((k, _sig_of(v)) for k, v in sorted(kwargs.items()))
    return tuple(sig)


def _describe_entry(e):
    if e[0] == "A":
        return "array shape=%s dtype=%s device=%s" % (e[1], e[2], e[3])
    if e[0] == "S":
        return "static value %r" % (e[1],)
    return "%s" % (e,)


def _sig_diff(old, new):
    """Human-readable minimal diff between two signatures: exactly
    which argument changed shape, dtype or static value."""
    changes = []
    old_d, new_d = dict(old), dict(new)
    for name in list(old_d) + [n for n in new_d if n not in old_d]:
        a, b = old_d.get(name), new_d.get(name)
        if a == b:
            continue
        if a is None:
            changes.append("%s: added (%s)" % (name, _describe_entry(b)))
        elif b is None:
            changes.append("%s: removed (was %s)"
                           % (name, _describe_entry(a)))
        elif a[0] == "A" and b[0] == "A":
            if a[1] != b[1]:
                changes.append("%s: shape %s -> %s" % (name, a[1], b[1]))
            if a[2] != b[2]:
                changes.append("%s: dtype %s -> %s" % (name, a[2], b[2]))
            if a[3] != b[3]:
                changes.append("%s: device %s -> %s" % (name, a[3], b[3]))
        elif a[0] == "S" and b[0] == "S":
            changes.append("%s: static value %r -> %r"
                           % (name, a[1], b[1]))
        else:
            changes.append("%s: %s -> %s"
                           % (name, _describe_entry(a), _describe_entry(b)))
    return changes


def _closest(seen, sig):
    """The previously-seen signature sharing the most entries — the
    best reference for naming what changed."""
    best, best_n = None, -1
    new_d = dict(sig)
    for s in seen:
        n = sum(1 for k, v in s if new_d.get(k) == v)
        if n > best_n:
            best, best_n = s, n
    return best


# -- compile boundaries --------------------------------------------------------

class Boundary:
    """Verifying wrapper around one program callable.  ``fn`` is a
    mutable attribute on purpose: a wiring site that replaces the
    program behind a memo entry rebinds ``boundary.fn`` so verification
    survives the swap."""

    __slots__ = ("name", "fn", "budget", "group", "compiles", "sigs")

    def __init__(self, name, fn, budget, group):
        self.name = name
        self.fn = fn
        self.budget = budget
        self.group = group
        self.compiles = 0
        self.sigs = []

    def __call__(self, *args, **kwargs):
        sig = _signature(args, kwargs)
        out = self.fn(*args, **kwargs)
        if sig not in self.sigs:
            self.sigs.append(sig)
            self._on_compile(sig)
        return out

    def _on_compile(self, sig):
        self.compiles += 1
        _counter("jit.verify_compiles_total").inc()
        if self.group is not None:
            with _lock:
                _GROUP_COMPILES[self.group] = \
                    _GROUP_COMPILES.get(self.group, 0) + 1
        if self.compiles <= self.budget:
            return
        _counter("compile.recompiles_total").inc()
        _counter("jit.verify_recompiles_total").inc()
        ref = _closest(self.sigs[:-1] if self.sigs
                       and self.sigs[-1] == sig else self.sigs, sig)
        diff = _sig_diff(ref, sig) if ref is not None else \
            ["first signature: %s" % (sig,)]
        rec = {
            "name": self.name,
            "group": self.group,
            "compiles": self.compiles,
            "budget": self.budget,
            "diff": diff,
        }
        if _record_violation("unexpected_recompile", rec):
            raise JitVerifyError(
                "unexpected recompile of %r (compile %d, budget %d): %s"
                % (self.name, self.compiles, self.budget,
                   "; ".join(diff)))


def wrap(name, fn, budget=1, group=None):
    """Wrap a program callable at its memo/attr store site.  Identity
    (zero overhead) when the verifier is off; idempotent on an
    already-wrapped boundary."""
    if not ENABLED:
        return fn
    if isinstance(fn, Boundary):
        return fn
    # register the headline counter up front: a clean verified run then
    # journals an explicit compile.recompiles_total=0 snapshot
    _counter("compile.recompiles_total")
    b = Boundary(name, fn, budget, group)
    with _lock:
        _BOUNDARIES.append(b)
    return b


def unwrap(fn):
    """The raw callable behind a boundary, or ``fn`` itself when
    unwrapped/off."""
    return fn.fn if isinstance(fn, Boundary) else fn


def rebind(prev, new_fn):
    """Swap a boundary's inner callable in place (the program was
    replaced) keeping its compile history; passthrough when the
    verifier is off."""
    if isinstance(prev, Boundary):
        prev.fn = new_fn
        return prev
    return new_fn


def declare_budget(group, n):
    """Declare the bucket-derived compile budget for a dispatch group
    (e.g. ``len(batch_buckets) * len(chunk_buckets)`` per serving
    kind).  Re-declaration takes the max — warmup helpers and tests may
    both declare."""
    if not ENABLED:
        return
    with _lock:
        _GROUP_BUDGETS[group] = max(n, _GROUP_BUDGETS.get(group, 0))


def check_budgets():
    """Groups whose observed compile count exceeded the declared
    budget: ``[(group, declared, observed), ...]``."""
    out = []
    with _lock:
        for group, declared in sorted(_GROUP_BUDGETS.items()):
            observed = _GROUP_COMPILES.get(group, 0)
            if observed > declared:
                out.append((group, declared, observed))
    return out


# -- D2H byte ledger -----------------------------------------------------------

@contextmanager
def d2h_region(name, budget_bytes=None):
    """Open a hot-region transfer ledger.  Pulls inside call
    :func:`note_d2h`; on exit the region's byte total is checked
    against ``budget_bytes`` (None = site-tracking only, no budget).
    Regions nest; bytes are attributed to the innermost."""
    if not ENABLED:
        yield None
        return
    rec = {"name": name, "budget_bytes": budget_bytes, "bytes": 0,
           "sites": {}}
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(rec)
    try:
        yield rec
    finally:
        stack.pop()
        if budget_bytes is not None and rec["bytes"] > budget_bytes:
            _counter("jit.verify_d2h_violations_total").inc()
            v = {"region": name, "bytes": rec["bytes"],
                 "budget_bytes": budget_bytes,
                 "sites": dict(rec["sites"])}
            if _record_violation("d2h_over_budget", v):
                raise JitVerifyError(
                    "hot-region D2H ledger %r over budget: %d bytes "
                    "observed, %d allowed (sites: %s)"
                    % (name, rec["bytes"], budget_bytes,
                       sorted(rec["sites"])))


def note_d2h(nbytes, site):
    """Account one device->host pull against the innermost open region
    (and the global observed-site ledger).  Call it next to the
    transfer with ``site='relpath::qualname'``."""
    if not ENABLED:
        return
    nbytes = int(nbytes)
    _counter("jit.verify_d2h_bytes_total").inc(nbytes)
    stack = getattr(_tls, "stack", None)
    if stack:
        rec = stack[-1]
        rec["bytes"] += nbytes
        rec["sites"][site] = rec["sites"].get(site, 0) + nbytes
    with _lock:
        ent = _OBSERVED_D2H.setdefault(site, {"bytes": 0, "count": 0})
        ent["bytes"] += nbytes
        ent["count"] += 1


def observed_d2h_sites():
    """Copy of the run's observed-pull ledger keyed by site id."""
    with _lock:
        return {k: dict(v) for k, v in _OBSERVED_D2H.items()}


# -- suite-gate accessors ------------------------------------------------------

def unexpected():
    """Ambient unexpected-recompile records (the conftest gate)."""
    with _lock:
        return list(_UNEXPECTED)


def d2h_violations():
    """Ambient over-budget D2H region records (the conftest gate)."""
    with _lock:
        return list(_D2H_VIOLATIONS)


@contextmanager
def expecting_violations():
    """Divert violations into a local capture list instead of the
    ambient gate (and suppress raising) — negative-control tests seed a
    storm, assert it was caught, and must not fail the suite gate."""
    global _DIVERT
    captured = []
    with _lock:
        prev = _DIVERT
        _DIVERT = captured
    try:
        yield captured
    finally:
        with _lock:
            _DIVERT = prev


def summary():
    """Plain-dict snapshot for /statusz."""
    with _lock:
        return {
            "mode": MODE,
            "boundaries": {
                b.name: {"compiles": b.compiles, "budget": b.budget}
                for b in _BOUNDARIES},
            "groups": {g: {"budget": _GROUP_BUDGETS.get(g),
                           "compiles": _GROUP_COMPILES.get(g, 0)}
                       for g in set(_GROUP_BUDGETS) | set(_GROUP_COMPILES)},
            "unexpected_recompiles": len(_UNEXPECTED),
            "d2h_violations": len(_D2H_VIOLATIONS),
            "d2h_sites": {k: dict(v) for k, v in _OBSERVED_D2H.items()},
        }

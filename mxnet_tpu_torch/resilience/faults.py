"""Deterministic fault injection points.

Production code calls ``faults.point("ckpt.write")`` at the places a
real system fails — record reads, checkpoint writes, coordinator RPCs,
engine task bodies. With no spec installed the call is a dict lookup
(measured noise at test scale); with a spec it fires deterministically
from a per-rule seeded RNG, so a test that saw a failure sequence sees
the *same* sequence on every run and in every bisect.

Spec grammar (``MXNET_FAULT_SPEC`` or ``inject()``; ';'-separated):

    spec   := rule (';' rule)*
    rule   := point ':' mode (':' param)*
    mode   := 'error'                 -- raise FaultInjected at the point
            | 'delay=<secs>'          -- sleep <secs> at the point
    param  := 'p=<float>'             -- fire probability per hit (default 1)
            | 'seed=<int>'            -- RNG seed for the fire pattern
            | 'count=<int>'           -- stop after <int> fires
            | 'skip=<int>'            -- let the first <int> hits pass

Examples::

    MXNET_FAULT_SPEC="ckpt.write:error:p=0.5:seed=7"
    MXNET_FAULT_SPEC="rio.read:error:count=2;kv.coord:delay=0.05:p=0.1:seed=3"

Registered points (grep ``faults.point(`` for the live list):

    rio.read     -- MXRecordIO.read record fetch
    ckpt.write   -- model.save_checkpoint, after tmp write, before rename
    kv.coord     -- KVStore coordination-service get/set RPCs (incl.
                    every elastic-coordinator RPC)
    kv.barrier   -- KVStore dist barrier rendezvous body
    kv.evict     -- elastic coordinator eviction path (error aborts the
                    sweep — the eviction retries on the next pass)
    kv.rejoin    -- elastic worker rejoin/re-register path
    engine.task  -- dependency-engine task body, before fn runs
    grad.nan     -- optimizer update path: an ``error``-mode fire makes
                    the production hook (``guardian.corrupt_grad`` /
                    the scanned trainer's staged multipliers) poison
                    that gradient with NaN instead of raising —
                    consumed via :func:`check`, not :func:`point`
    loss.spike   -- same hook: scales the gradient by
                    MXNET_GUARDIAN_SPIKE_SCALE (a finite explosion the
                    guardian's anomaly detector must catch)

The registry is process-global and thread-safe. ``clear()`` removes
every installed rule AND re-arms the env read, so a pytest fixture
calling it between tests gives each test a fresh, deterministic pattern
(tests/conftest.py does exactly that; chaos runs rely on the env spec
being re-read so each test replays the same seeded pattern).
"""
from __future__ import annotations

import os
import random
import threading
import time

from ..base import MXNetError

__all__ = [
    "FaultInjected", "FaultRule", "parse_spec", "point", "check",
    "armed", "inject", "clear", "active", "fire_pattern",
]


class FaultInjected(MXNetError):
    """Raised by an armed ``error``-mode injection point.

    Subclasses MXNetError so recovery paths treat it exactly like the
    real failure it stands in for; chaos reports grep for the class
    name to separate injected casualties from genuine bugs."""

    def __init__(self, point_name, rule=None):
        self.point = point_name
        self.rule = rule
        super().__init__(
            "injected fault at point %r%s (MXNET_FAULT_SPEC / "
            "resilience.faults)" % (point_name,
                                    "" if rule is None else " [%s]" % rule))


class FaultRule:
    """One armed rule at one point. Fire decisions come from a private
    seeded RNG consumed once per hit — same seed, same hit sequence,
    same fire pattern, regardless of what other points do."""

    __slots__ = ("point", "mode", "p", "seed", "count", "skip", "delay",
                 "_rng", "hits", "fired")

    def __init__(self, point, mode, p=1.0, seed=0, count=None, skip=0,
                 delay=0.0):
        if mode not in ("error", "delay"):
            raise MXNetError("fault rule mode must be 'error' or 'delay', "
                             "got %r" % (mode,))
        if not 0.0 <= p <= 1.0:
            raise MXNetError("fault rule p must be in [0, 1], got %r" % (p,))
        if delay < 0:
            raise MXNetError("fault rule delay must be >= 0, got %r" % (delay,))
        self.point = point
        self.mode = mode
        self.p = float(p)
        self.seed = int(seed)
        self.count = None if count is None else int(count)
        self.skip = int(skip)
        self.delay = float(delay)
        self._rng = random.Random(self.seed)
        self.hits = 0
        self.fired = 0

    def should_fire(self):
        """Advance one hit; True when this hit fires. Must be called
        under the registry lock (mutates hit/fire counters)."""
        self.hits += 1
        # the RNG is consumed on EVERY hit so the fire pattern for hit N
        # does not depend on skip/count bookkeeping — same seed, same
        # per-hit coin flips, always
        coin = self._rng.random() < self.p if self.p < 1.0 else True
        if not coin:
            return False
        if self.hits <= self.skip:
            return False
        if self.count is not None and self.fired >= self.count:
            return False
        self.fired += 1
        return True

    def __str__(self):
        parts = ["%s:%s" % (self.point,
                            self.mode if self.mode == "error"
                            else "delay=%g" % self.delay)]
        if self.p < 1.0:
            parts.append("p=%g" % self.p)
        if self.seed:
            parts.append("seed=%d" % self.seed)
        if self.count is not None:
            parts.append("count=%d" % self.count)
        if self.skip:
            parts.append("skip=%d" % self.skip)
        return ":".join(parts)


def parse_spec(spec):
    """Parse a full spec string into a list of FaultRule. Raises
    MXNetError naming the offending token on any malformed input — a
    typo'd chaos spec must fail the run, not silently inject nothing."""
    rules = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        toks = raw.split(":")
        if len(toks) < 2:
            raise MXNetError(
                "bad fault spec %r: want point:mode[:param...]" % (raw,))
        pt = toks[0].strip()
        if not pt:
            raise MXNetError("bad fault spec %r: empty point name" % (raw,))
        mode, kwargs = None, {}
        for tok in toks[1:]:
            tok = tok.strip()
            if tok == "error":
                mode = "error"
            elif tok.startswith("delay="):
                mode = "delay"
                kwargs["delay"] = _num(tok, "delay")
            elif tok.startswith("p="):
                kwargs["p"] = _num(tok, "p")
            elif tok.startswith("seed="):
                kwargs["seed"] = int(_num(tok, "seed"))
            elif tok.startswith("count="):
                kwargs["count"] = int(_num(tok, "count"))
            elif tok.startswith("skip="):
                kwargs["skip"] = int(_num(tok, "skip"))
            else:
                raise MXNetError(
                    "bad fault spec token %r in %r (know: error, delay=, "
                    "p=, seed=, count=, skip=)" % (tok, raw))
        if mode is None:
            raise MXNetError(
                "fault spec %r has no mode (error or delay=secs)" % (raw,))
        rules.append(FaultRule(pt, mode, **kwargs))
    return rules


def _num(tok, name):
    v = tok.split("=", 1)[1]
    try:
        return float(v)
    except ValueError:
        raise MXNetError("bad fault spec value %r for %s" % (v, name))


# -- process-global registry ---------------------------------------------------
_lock = threading.Lock()
_rules = {}          # point name -> [FaultRule]
_env_loaded = False  # MXNET_FAULT_SPEC consumed into _rules?


def _ensure_env_locked():
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get("MXNET_FAULT_SPEC", "").strip()
    if spec:
        for r in parse_spec(spec):
            _rules.setdefault(r.point, []).append(r)


def point(name):
    """Fault injection point. No-op unless a rule is armed for `name`;
    an armed ``error`` rule raises FaultInjected, ``delay`` sleeps.
    The sleep happens OUTSIDE the registry lock (a delayed point must
    not serialize every other point in the process)."""
    # lock-free fast path for the armed-nothing case: this call sits on
    # per-record and per-engine-task hot paths (GIL makes the two global
    # reads atomic; a racing clear()/inject() just falls to the lock)
    if _env_loaded and not _rules:
        return
    with _lock:
        _ensure_env_locked()
        rules = _rules.get(name)
        if not rules:
            return
        naps, boom = [], None
        for r in rules:
            if r.should_fire():
                if r.mode == "delay":
                    naps.append(r.delay)
                elif boom is None:
                    boom = r
    if naps or boom is not None:
        # mxtel: count fires so chaos runs can prove which injection
        # points actually exercised (cold path — only on a fire)
        from .. import telemetry as _tel

        if _tel.ENABLED:
            _tel.counter("faults.fired_total").inc(
                len(naps) + (1 if boom is not None else 0))
            _tel.counter("faults.fired.%s" % name).inc(
                len(naps) + (1 if boom is not None else 0))
    for d in naps:
        time.sleep(d)
    if boom is not None:
        raise FaultInjected(name, boom)


def armed(name):
    """True when any rule is installed for `name` — the fast gate for
    call sites whose fault behavior is data corruption rather than an
    exception (grad.nan/loss.spike): they must not even touch the
    value when nothing is armed. Same lock-free fast path as point()."""
    if _env_loaded and not _rules:
        return False
    with _lock:
        _ensure_env_locked()
        return bool(_rules.get(name))


def check(name):
    """Like :func:`point`, but an ``error``-mode fire RETURNS True
    instead of raising — for points where 'the fault fired' means the
    call site corrupts a value (grad.nan poisons the gradient) rather
    than aborts. ``delay`` rules still sleep. Fire counting and
    telemetry match point()."""
    if _env_loaded and not _rules:
        return False
    with _lock:
        _ensure_env_locked()
        rules = _rules.get(name)
        if not rules:
            return False
        naps, fired = [], False
        for r in rules:
            if r.should_fire():
                if r.mode == "delay":
                    naps.append(r.delay)
                else:
                    fired = True
    if naps or fired:
        from .. import telemetry as _tel

        if _tel.ENABLED:
            n = len(naps) + (1 if fired else 0)
            _tel.counter("faults.fired_total").inc(n)
            _tel.counter("faults.fired.%s" % name).inc(n)
    for d in naps:
        time.sleep(d)
    return fired


def inject(spec, **kwargs):
    """Arm rules programmatically. Accepts a full spec string
    (``inject("ckpt.write:error:count=1")``), or a point name plus
    keyword fields (``inject("ckpt.write", mode="error", count=1)``).
    Returns the installed rules."""
    if kwargs:
        rules = [FaultRule(spec, **kwargs)]
    else:
        rules = parse_spec(spec)
        if not rules:
            raise MXNetError("inject(): empty fault spec %r" % (spec,))
    with _lock:
        _ensure_env_locked()
        for r in rules:
            _rules.setdefault(r.point, []).append(r)
    return rules


def clear():
    """Remove every armed rule and re-arm the env read: the next
    ``point()`` call re-parses MXNET_FAULT_SPEC from scratch (fresh
    RNGs — deterministic per test under chaos runs)."""
    global _env_loaded
    with _lock:
        _rules.clear()
        _env_loaded = False


def active():
    """Snapshot of armed rules: {point: [str(rule), ...]}."""
    with _lock:
        _ensure_env_locked()
        return {pt: [str(r) for r in rs] for pt, rs in _rules.items()}


def fire_pattern(rule_spec, n):
    """The first `n` fire decisions a single-rule spec would make —
    the determinism contract as data, for tests and for previewing a
    chaos spec without running anything."""
    rules = parse_spec(rule_spec)
    if len(rules) != 1:
        raise MXNetError("fire_pattern wants exactly one rule, got %d"
                         % len(rules))
    r = rules[0]
    return [r.should_fire() for _ in range(n)]

"""Measure-and-cache autotuner for contested compilation choices.

Counterpart of ``mxnet_tpu/compile/autotune.py``. Some rewrite decisions
have no safe static answer — per-conv layout, elementwise segment
boundaries, and the matmul accumulation choice all depend on the actual
device. Each contested choice is *measured* once on the card and the
winner remembered: the candidates run as small torch programs (warmed
up, then the best of N timed with CUDA events on the card, or the host
clock on the CPU), and the winner is persisted in an on-disk tuning
database keyed by ``(choice-kind, op, shapes, dtype, backend)``;
``backend`` is the card's name (``torch.cuda.get_device_name``) or
``"cpu"``.

Database format (``tuning.json`` under ``MXNET_COMPILE_CACHE_DIR``), the
JAX package's, so one package's file loads in the other::

    {"version": 1,
     "entries": {"<key>": {"choice": "...", "timings": {...},
                           "backend": "...", "ts": ...}}}

Reads are cheap and happen on every optimize(); measurement only runs
under ``MXNET_COMPILE_TUNE=1`` (a tuning run is a deliberate,
device-occupying act). A corrupt database never crashes a run: it is
quarantined to ``tuning.json.corrupt`` and counted via
``compile.cache_corrupt_total``.
"""
from __future__ import annotations

import json
import os
import time

import numpy as _np
import torch

from .. import telemetry as _tel

__all__ = ["TuningDB", "Tuner", "make_tuner", "measure_calls"]

DB_VERSION = 1

#: process-lifetime counters (exact mirrors of the mxtel counters, kept
#: as plain ints so subprocess probes can report without telemetry on)
TRIALS = 0
CORRUPT = 0

#: seconds the trials of this process took, measurement included
TRIAL_SECS = 0.0


def _count_corrupt():
    global CORRUPT
    CORRUPT += 1
    if _tel.ENABLED:
        _tel.counter("compile.cache_corrupt_total").inc()


def _count_trial():
    global TRIALS
    TRIALS += 1
    if _tel.ENABLED:
        _tel.counter("compile.tuning_trials_total").inc()


class TuningDB:
    """On-disk choice database with crash/corruption-safe semantics:
    atomic replace on write, quarantine + empty-start on unreadable or
    malformed content."""

    def __init__(self, path):
        self.path = path
        self._entries = None

    def _load(self):
        if self._entries is not None:
            return self._entries
        self._entries = {}
        if not os.path.exists(self.path):
            return self._entries
        try:
            with open(self.path, "r") as f:
                data = json.load(f)
            if (not isinstance(data, dict)
                    or data.get("version") != DB_VERSION
                    or not isinstance(data.get("entries"), dict)):
                raise ValueError("malformed tuning db")
            self._entries = dict(data["entries"])
        except (OSError, ValueError) as e:
            # truncated write, bit-flip, wrong version: recompute-able
            # state, so quarantine and start empty — never crash the run
            _count_corrupt()
            try:
                os.replace(self.path, self.path + ".corrupt")
            except OSError:
                pass
            import logging

            logging.getLogger("mxnet_tpu_torch.compile").warning(
                "tuning db %s unreadable (%s); starting empty "
                "(quarantined to .corrupt)", self.path, e)
            self._entries = {}
        return self._entries

    def get(self, key):
        return self._load().get(key)

    def put(self, key, record):
        entries = self._load()
        entries[key] = record
        tmp = "%s.tmp.%d" % (self.path, os.getpid())
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"version": DB_VERSION, "entries": entries}, f,
                      indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def __len__(self):
        return len(self._load())


def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def measure_calls(f, args, warmup=2, iters=5, clock=None):
    """Best-of-N seconds of ``f(*args)`` after ``warmup`` calls: CUDA
    events around each call on a card (device time of the queued
    work), the host clock after a synchronisation otherwise. ``clock``
    (tests): a zero-arg callable returning seconds, used in place of
    both. One call = one tuning trial (counted)."""
    global TRIAL_SECS
    _count_trial()
    t_start = time.perf_counter()
    dev = _device_of(args)
    for _ in range(max(1, warmup)):
        f(*args)
    best = float("inf")
    if clock is None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(max(1, iters)):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            f(*args)
            t1.record()
            t1.synchronize()
            best = min(best, t0.elapsed_time(t1) / 1e3)
    else:
        clock = clock or time.perf_counter
        for _ in range(max(1, iters)):
            t0 = clock()
            f(*args)
            best = min(best, clock() - t0)
    TRIAL_SECS += time.perf_counter() - t_start
    return best


def backend_name(device):
    """The tuning key's backend: the card's name, or ``"cpu"``."""
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


class Tuner:
    """Decision point used by the rewrite passes.

    ``measure_enabled=False`` (the default outside MXNET_COMPILE_TUNE=1)
    makes the tuner read-only: recorded winners are honored, unknown
    keys fall back to ``default`` without touching the device. Trials
    run on ``device`` (default: the CPU)."""

    def __init__(self, db, measure_enabled=False, backend=None, device=None):
        self.db = db
        self.measure_enabled = measure_enabled
        self._backend = backend
        self.device = torch.device(device if device is not None else "cpu")

    @property
    def backend(self):
        if self._backend is None:
            self._backend = backend_name(self.device)
        return self._backend

    def pick(self, key, candidates, default):
        """``candidates``: dict choice-name -> zero-arg thunk returning
        measured seconds. Returns the winning choice name."""
        rec = self.db.get(key) if self.db is not None else None
        if rec is not None and rec.get("choice") in candidates:
            return rec["choice"]
        if not self.measure_enabled:
            return default
        timings = {}
        for name, thunk in candidates.items():
            try:
                timings[name] = thunk()
            except Exception as e:
                import logging

                logging.getLogger("mxnet_tpu_torch.compile").warning(
                    "tuning candidate %s for %s failed (%s: %s); skipped",
                    name, key, type(e).__name__, e)
        if not timings:
            return default
        choice = min(timings, key=timings.get)
        if self.db is not None:
            self.db.put(key, {
                "choice": choice,
                "timings": {k: round(v, 6) for k, v in timings.items()},
                "backend": self.backend,
                "ts": time.time(),
            })
        return choice

    def _rand(self, gen, shape, dt):
        """Uniform [0, 1) trial data made on the tuner's device (the
        values do not matter; a host draw of a batch-128 activation
        would cost more than the trial)."""
        return torch.rand(tuple(shape), generator=gen,
                          device=self.device).to(_torch_dtype(dt))

    def _gen(self):
        return torch.Generator(device=self.device).manual_seed(0)

    # -- the contested choices -------------------------------------------------
    def pick_conv_layout(self, params, dshape, dtype=None):
        """'nhwc' or 'nchw' for one Convolution, keyed by its full
        problem statement. Measures fwd+bwd (training is the dominant
        consumer) of the bare conv in each layout."""
        if dshape is None:
            return "nchw"
        dt = _dtype_name(dtype)
        k = tuple(params.get("kernel") or ())
        key = "conv_layout|d=%s|k=%s|s=%s|p=%s|dl=%s|f=%s|g=%s|dt=%s|b=%s" % (
            tuple(dshape), k, tuple(params.get("stride") or ()),
            tuple(params.get("pad") or ()),
            tuple(params.get("dilate") or ()), params.get("num_filter"),
            params.get("num_group", 1), dt, self.backend)

        def _variant(nhwc):
            def run():
                from ..ops import nn as _nn

                gen = self._gen()
                nsp = len(dshape) - 2
                kk = _nn._pair(k, nsp)
                cin = dshape[1]
                nf = int(params.get("num_filter"))
                g = int(params.get("num_group", 1) or 1)
                w = self._rand(gen, (nf, cin // g) + tuple(kk), dt)
                x = self._rand(gen, tuple(dshape), dt)
                if nhwc:
                    # the layout pass's operand: an NHWC tensor seen
                    # through its channels_last NCHW view
                    x = x.permute(0, 2, 3, 1).contiguous().permute(
                        0, 3, 1, 2)
                p = {"stride": params.get("stride"),
                     "pad": params.get("pad"),
                     "dilate": params.get("dilate"), "num_group": g,
                     "no_bias": True}

                def step(w_):
                    w_ = w_.detach().requires_grad_()
                    with torch.enable_grad():
                        (o,), _ = _nn._conv_fwd(p, [x, w_], [], True, None)
                        loss = (o.float() * o.float()).sum()
                        (gw,) = torch.autograd.grad(loss, [w_])
                    return gw

                return measure_calls(step, (w,))
            return run

        return self.pick(key, {"nchw": _variant(False),
                               "nhwc": _variant(True)}, default="nhwc")

    def pick_segment_boundary(self, op_names, shape):
        """'whole' or 'split' for an elementwise chain: fuse the chain
        into one segment or split it at the midpoint. Keyed by the op
        signature and shape."""
        key = "seg_boundary|ops=%s|d=%s|b=%s" % (
            "+".join(op_names), tuple(shape), self.backend)

        def _variant(split):
            def run():
                x = self._rand(self._gen(), tuple(shape), "float32")
                n = len(op_names)

                def chain(v, count):
                    for i in range(count):
                        v = torch.tanh(v) if i % 2 else torch.clamp(
                            v, min=0) * 1.01
                    return v

                if split:
                    # two segments: the boundary re-exposes one
                    # intermediate between the halves
                    def f(v):
                        mid = chain(v, n // 2).clone()
                        return chain(mid, n - n // 2)
                else:
                    def f(v):
                        return chain(v, n)
                return measure_calls(f, (x,))
            return run

        return self.pick(key, {"whole": _variant(False),
                               "split": _variant(True)}, default="whole")

    def pick_matmul_precision(self, dshape, num_hidden, dtype=None):
        """'f32' (the stock FullyConnected: f32 accumulation, no TF32)
        or 'fast' (reduced-precision accumulation allowed for the call,
        ``precision.fast_matmul``) for one FullyConnected problem."""
        dt = _dtype_name(dtype)
        key = "matmul_prec|d=%s|h=%s|dt=%s|b=%s" % (
            tuple(dshape), num_hidden, dt, self.backend)

        def _variant(f32):
            def run():
                from .precision import fast_matmul

                gen = self._gen()
                flat = int(_np.prod(dshape[1:]))
                x = self._rand(gen, (dshape[0], flat), dt)
                w = self._rand(gen, (num_hidden, flat), dt)

                def f(x_, w_):
                    if f32:
                        return torch.matmul(x_, w_.t())
                    return fast_matmul(x_, w_)

                return measure_calls(f, (x, w))
            return run

        return self.pick(key, {"f32": _variant(True),
                               "fast": _variant(False)}, default="f32")


def _dtype_name(dtype):
    """The key's dtype: numpy's name (``str(np.dtype)``), as the JAX
    package writes it; torch dtypes by their torch name."""
    if dtype is None:
        return "float32"
    try:
        return str(_np.dtype(dtype))
    except TypeError:
        return str(dtype).replace("torch.", "")


def _torch_dtype(name):
    from ..base import torch_dtype

    return torch_dtype(name)


def make_tuner(cache_dir, measure_enabled, device=None):
    """Build the pipeline's tuner, or None when there is nowhere to
    persist decisions and measurement is off (a memory-only tuner that
    re-times every process would violate the measure-ONCE contract)."""
    if cache_dir:
        db = TuningDB(os.path.join(cache_dir, "tuning.json"))
        return Tuner(db, measure_enabled=measure_enabled, device=device)
    if measure_enabled:
        return Tuner(TuningDB(os.path.join(
            os.path.expanduser("~"), ".cache", "mxnet_tpu_torch",
            "tuning.json")), measure_enabled=True, device=device)
    return None

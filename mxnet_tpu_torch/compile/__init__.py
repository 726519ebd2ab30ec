"""mxc: the compilation layer — graph rewrites, autotuning, jit cache.

Counterpart of ``mxnet_tpu/compile/``. Three cooperating pieces:

1. **Graph-rewrite passes** over the Symbol graph before the executor
   walks it — constant folding (fold.py), NCHW->NHWC layout selection
   with transpose hoisting (layout.py), elementwise-chain fusion
   (fuse.py) and the matmul-accumulation choice (precision.py). Each
   pass is a separate module sharing the ir.py walk utilities (a byte
   copy of the JAX package's), individually disableable, and checked
   against the unrewritten graph (pipeline.check_equivalence). The
   rewrite reports and the rewritten node lists are the JAX package's
   on the same graph.
2. **A measure-and-cache autotuner** (autotune.py) for contested
   choices — per-conv layout, segment boundaries, matmul precision —
   timed once on the card with CUDA events, the winner persisted on
   disk keyed by (op, shapes, dtype, backend), in the JAX package's
   database format.
3. **A persistent compilation cache** (jit_cache.py). The port builds
   no XLA executables; the compiled programs it does build in a process
   are NVRTC's cubins (RTC bodies, ``ops/_nvrtc.compile_cubin``). Under
   ``MXNET_COMPILE_CACHE_DIR`` they persist, keyed to include the
   rewrite-pass configuration, and the next process loads them.

Enablement contract (off by default, as in the JAX package)::

    MXNET_COMPILE_OPT=1               # master switch for the passes
    MXNET_COMPILE_PASSES=...          # subset of fold,layout,fuse,precision
    MXNET_COMPILE_CACHE_DIR=/path     # persistent cubin cache + tuning db
    MXNET_COMPILE_TUNE=1              # allow on-device tuning trials
    MXNET_COMPILE_VERIFY=1            # golden-check every optimize()
    MXNET_COMPILE_MATMUL_PREC=auto    # auto | f32 | fast

Off, the only cost at bind time is one module attribute test.
mxtel counters: ``compile.passes_applied_total``,
``compile.pass.<name>_rewrites_total``,
``compile.cache_hits_total``/``misses_total``/``corrupt_total``,
``compile.tuning_trials_total``; spans: ``compile.optimize``,
``compile.pass.<name>``.
"""
from __future__ import annotations

import os

from .. import telemetry as _tel
from ..base import MXNetError

__all__ = [
    "ENABLED", "enabled", "reload", "optimize", "ensure_jit_cache",
    "active_passes", "config_key", "last_report", "CompileVerifyError",
]


class CompileVerifyError(MXNetError):
    """A rewritten graph diverged from the unrewritten reference under
    ``MXNET_COMPILE_VERIFY=1``. Never swallowed by the bind-time
    fallback — a wrong rewrite must not train silently."""

#: Master switch for the rewrite passes. The executor reads this ONE
#: attribute on every bind; everything else loads lazily behind it.
ENABLED = False

PASS_ORDER = ("fold", "layout", "fuse", "precision")

_passes = PASS_ORDER
_verify = False
_tune = False
_matmul_prec = "auto"


def _env_on(name):
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "off", "no")


def reload():
    """Re-read the MXNET_COMPILE_* environment (import-time default;
    tests call it after monkeypatching)."""
    global ENABLED, _passes, _verify, _tune, _matmul_prec
    ENABLED = _env_on("MXNET_COMPILE_OPT")
    raw = os.environ.get("MXNET_COMPILE_PASSES", "").strip()
    if raw:
        wanted = {p.strip() for p in raw.split(",") if p.strip()}
        unknown = wanted - set(PASS_ORDER)
        if unknown:
            raise ValueError(
                "MXNET_COMPILE_PASSES: unknown pass(es) %s (know: %s)"
                % (sorted(unknown), list(PASS_ORDER)))
        _passes = tuple(p for p in PASS_ORDER if p in wanted)
    else:
        _passes = PASS_ORDER
    _verify = _env_on("MXNET_COMPILE_VERIFY")
    _tune = _env_on("MXNET_COMPILE_TUNE")
    _matmul_prec = (os.environ.get("MXNET_COMPILE_MATMUL_PREC", "auto")
                    .strip().lower() or "auto")
    if _matmul_prec not in ("auto", "f32", "fast"):
        raise ValueError(
            "MXNET_COMPILE_MATMUL_PREC=%r (know: auto, f32, fast)"
            % (_matmul_prec,))


def enabled():
    return ENABLED


def active_passes():
    return _passes


def config_key():
    """Stable string describing the rewrite configuration — folded into
    the jit-cache directory key so programs compiled under different
    pass configurations never share entries. Byte-equal to the JAX
    package's for the same environment."""
    return "v1|opt=%d|passes=%s|prec=%s" % (
        int(ENABLED), ",".join(_passes) if ENABLED else "-", _matmul_prec)


def optimize(sym, input_shapes=None, input_types=None, frozen_params=None,
             device=None):
    """Run the active passes over ``sym``; returns the rewritten Symbol
    (``sym`` unchanged when nothing applies). Callers treat the result
    as an executor-internal artifact: it shares variable nodes with the
    original by identity and its fused/layout ops are not registry ops,
    so it must never be serialized. ``device``: where folded constants
    live, tuning trials and the verify check run (default: the CPU)."""
    if not ENABLED:
        return sym
    from . import autotune, pipeline
    from .jit_cache import cache_dir

    tuner = autotune.make_tuner(cache_dir(), measure_enabled=_tune,
                                device=device)
    with _tel.span("compile.optimize"):
        return pipeline.run(
            sym, _passes, input_shapes=input_shapes,
            input_types=input_types, frozen_params=frozen_params,
            tuner=tuner, matmul_prec=_matmul_prec, verify=_verify,
            device=device)


def ensure_jit_cache():
    """Arm the persistent cubin cache when configured; safe no-op
    otherwise. Every compile entry point calls this before building
    programs."""
    if os.environ.get("MXNET_COMPILE_CACHE_DIR", "").strip():
        from . import jit_cache

        return jit_cache.ensure(config_key())
    return None


def last_report():
    """The most recent optimize() pass report (test/tools hook)."""
    from . import pipeline

    return dict(pipeline.LAST_REPORT)


try:
    reload()
except ValueError as _e:  # a typo'd env var must not break import;
    import logging as _logging  # explicit reload() still raises for tests

    _logging.getLogger("mxnet_tpu_torch.compile").warning(
        "MXNET_COMPILE_* misconfigured (%s); compile layer disabled", _e)
    ENABLED = False

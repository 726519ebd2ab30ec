"""Training-run guardian: non-finite gradient sentinels, coordinated
skip-steps, and automatic rollback-to-last-good.

Counterpart of ``mxnet_tpu/resilience/guardian.py``, with its policy
state machine, counters and messages:

1. **On-device sentinel** — every optimizer update computes one
   finiteness flag + one squared norm per gradient on the gradient's
   device and applies the update through ``torch.where(ok, new, old)``:
   a poisoned update is suppressed ON DEVICE, with no host
   synchronisation on the happy path (no ``.item()``, no ``bool()`` of a
   card tensor). The per-batch path folds this into
   ``optimizer.get_updater``; the scanned fit (parallel/fit_trainer.py)
   gates every step of its K-step chunk the same way, and the per-step
   verdicts come back with the chunk's one device-to-host copy.
2. **Host-side anomaly detector** — EMA + z-score on the loss channel
   and a grad-norm explosion factor classify each step good / suspect /
   poisoned (``MXNET_GUARDIAN_*`` env vars below). Poisoned
   observations never fold into the EMA baselines.
3. **Escalation policy** — a poisoned step is a *skip* (counted);
   after ``MXNET_GUARDIAN_MAX_SKIPS`` consecutive poisoned steps the
   guardian rolls back to the newest in-memory last-good snapshot (a
   cheap ring, refreshed every ``MXNET_GUARDIAN_SNAPSHOT_STEPS`` good
   steps) or, failing that, the newest on-disk checkpoint via
   ``model.find_latest_checkpoint``, then fast-forwards the data
   iterator past the offending batches.
4. **Distributed coordination** — on a ``dist_sync`` kvstore in several
   processes a poisoned vote from ANY rank makes ALL ranks skip the same
   step (``KVStore.guardian_vote``: one all-reduce of the flag), so
   replicas never diverge.

Env vars (all read when the guardian is created, at ``fit()`` start)::

    MXNET_GUARDIAN=1                  master switch (off by default —
                                      zero overhead when unset)
    MXNET_GUARDIAN_MAX_SKIPS=3        consecutive poisoned steps before
                                      rollback
    MXNET_GUARDIAN_SNAPSHOT_STEPS=20  good steps between ring snapshots
    MXNET_GUARDIAN_SNAPSHOT_KEEP=2    snapshot ring depth
    MXNET_GUARDIAN_ZSCORE=6           loss z-score poisoned threshold
                                      (z > threshold/2 is 'suspect')
    MXNET_GUARDIAN_GRADNORM_FACTOR=25 grad-norm explosion: poisoned when
                                      norm > factor * EMA(norm)
    MXNET_GUARDIAN_GRADNORM_MAX=0     absolute grad-norm bound folded
                                      into the ON-DEVICE sentinel
                                      (0 = finiteness only)
    MXNET_GUARDIAN_WARMUP=10          good steps of EMA history before
                                      the statistical detectors arm
    MXNET_GUARDIAN_FF_BATCHES=0       extra batches to fast-forward the
                                      iterator past after a rollback
    MXNET_GUARDIAN_SPIKE_SCALE=1e8    multiplier the ``loss.spike``
                                      chaos point applies to gradients

Telemetry (mxtel): ``guardian.nonfinite_steps``,
``guardian.skipped_steps`` (updates that never landed),
``guardian.anomaly_steps`` (poisoned-but-applied finite spikes, undone
only by the escalation rollback), ``guardian.rollbacks`` counters and
the ``guardian.last_good_age`` gauge (steps since the newest last-good
snapshot).

The port carries no quantized kvstore wire (``MXNET_KV_QUANTIZE`` raises
at ``kvstore.create``), so the JAX package's quantization-noise margin
(``quantize.guard_norm_scale()``) is its inert 1.0 here, and no
data-service iterator (``attach_data_iter`` binds only iterators that
speak ``mark()``/``restore_mark()``, as in the JAX package).
"""
from __future__ import annotations

import logging
import math
import os
from collections import deque

from .. import telemetry as _tel
from ..base import MXNetError
from . import faults as _faults

__all__ = [
    "enabled", "GuardianConfig", "AnomalyDetector", "SnapshotRing",
    "TrainingGuardian", "UpdaterSentinel", "updater_sentinel",
    "corrupt_grad", "grad_fault_multiplier", "fast_forward", "grad_flags",
    "snapshot_updater_states", "restore_updater_states",
    "zero_updater_states", "MetricLossFeed",
]

GOOD = "good"
SUSPECT = "suspect"
POISONED = "poisoned"


def _env_float(name, default):
    raw = os.environ.get(name, "").strip()
    if not raw:
        return float(default)
    try:
        return float(raw)
    except ValueError:
        raise MXNetError("%s must be a number, got %r" % (name, raw))


def enabled():
    """Master switch (read live, like the other MXNET_* knobs)."""
    return os.environ.get("MXNET_GUARDIAN", "0").strip().lower() not in (
        "", "0", "false", "off", "no")


class GuardianConfig:
    """One read of every MXNET_GUARDIAN_* knob (fit()-start snapshot)."""

    def __init__(self):
        self.max_skips = max(1, int(_env_float("MXNET_GUARDIAN_MAX_SKIPS", 3)))
        self.snapshot_steps = max(1, int(_env_float(
            "MXNET_GUARDIAN_SNAPSHOT_STEPS", 20)))
        self.snapshot_keep = max(1, int(_env_float(
            "MXNET_GUARDIAN_SNAPSHOT_KEEP", 2)))
        self.zscore = _env_float("MXNET_GUARDIAN_ZSCORE", 6.0)
        self.gradnorm_factor = _env_float("MXNET_GUARDIAN_GRADNORM_FACTOR", 25.0)
        self.gradnorm_max = _env_float("MXNET_GUARDIAN_GRADNORM_MAX", 0.0)
        self.warmup = max(1, int(_env_float("MXNET_GUARDIAN_WARMUP", 10)))
        self.ff_batches = max(0, int(_env_float("MXNET_GUARDIAN_FF_BATCHES", 0)))
        # the JAX package's quantization-noise margin: 1.0 (inert)
        # without a quantized wire, which the port does not carry
        self.quant_guard_scale = 1.0


class AnomalyDetector:
    """Good/suspect/poisoned classification from host-side step signals.

    Two channels, both optional per step:

    - ``loss``: EMA mean + EMA second moment -> z-score. ``z > zscore``
      is poisoned, ``z > zscore/2`` suspect.
    - ``grad_norm``: explosion factor against the EMA of past *good*
      norms.

    Non-finite in either channel is poisoned outright. The statistical
    thresholds arm only after ``warmup`` good observations (an EMA with
    no history classifies everything). ``classify`` is pure;
    ``observe`` folds a GOOD step's values into the baselines — a
    poisoned value must never drag the baseline toward itself (the
    classic way a slow NaN ramp defeats a naive z-score)."""

    _BETA = 0.9  # EMA decay; ~10-step memory, matches the warmup default

    def __init__(self, config):
        self.cfg = config
        self.reset()

    def reset(self):
        self._n = 0
        self._loss_mean = 0.0
        self._loss_sq = 0.0
        self._gnorm_mean = 0.0

    @property
    def armed(self):
        return self._n >= self.cfg.warmup

    def classify(self, finite=True, grad_norm=None, loss=None):
        if not finite:
            return POISONED
        for v in (grad_norm, loss):
            if v is not None and not math.isfinite(v):
                return POISONED
        verdict = GOOD
        if self.armed:
            if grad_norm is not None and self._gnorm_mean > 0.0:
                # calibrated quantization-noise margin, multiplicative
                # like the absolute bound (exactly 1.0 with the codec
                # off): the explosion threshold widens by the worst
                # codec noise, so a gradient sitting at the edge never
                # tips POISONED from quantization alone
                limit = (self.cfg.gradnorm_factor * self._gnorm_mean
                         * getattr(self.cfg, "quant_guard_scale", 1.0))
                if grad_norm > limit:
                    return POISONED
            if loss is not None:
                # variance floor at 5% of the mean: a near-constant loss
                # baseline has ~zero EMA variance, and without the floor
                # any observable deviation reads as an infinite z-score.
                # ONE-SIDED: only loss INCREASES poison — a fast
                # legitimate improvement deviates just as many sigmas
                # below the baseline, and a two-sided test would freeze
                # the run poisoned forever (the below-baseline steps,
                # being GOOD, fold into the EMA and pull it down)
                var = max(self._loss_sq - self._loss_mean ** 2,
                          (0.05 * abs(self._loss_mean)) ** 2, 1e-8)
                z = (loss - self._loss_mean) / math.sqrt(var)
                if z > self.cfg.zscore:
                    return POISONED
                if z > self.cfg.zscore / 2.0:
                    verdict = SUSPECT
        return verdict

    def observe(self, grad_norm=None, loss=None):
        """Fold one GOOD step into the EMA baselines."""
        b = self._BETA
        if self._n == 0:
            if grad_norm is not None:
                self._gnorm_mean = grad_norm
            if loss is not None:
                self._loss_mean = loss
                self._loss_sq = loss * loss
        else:
            if grad_norm is not None:
                self._gnorm_mean = b * self._gnorm_mean + (1 - b) * grad_norm
            if loss is not None:
                self._loss_mean = b * self._loss_mean + (1 - b) * loss
                self._loss_sq = b * self._loss_sq + (1 - b) * loss * loss
        self._n += 1


class SnapshotRing:
    """In-memory last-good parameter snapshots (host copies). The
    payload is opaque to the ring — the per-batch loops store numpy
    param dicts, the scanned loop stores a FitTrainer state dump."""

    def __init__(self, keep):
        self._ring = deque(maxlen=int(keep))

    def push(self, step, payload):
        self._ring.append((int(step), payload))

    def latest(self):
        """(step, payload) of the newest snapshot, or None."""
        return self._ring[-1] if self._ring else None

    def pop_latest(self):
        """Remove and return the newest snapshot (a rollback CONSUMES
        it: if the restored state itself turns out poisoned, the next
        escalation must reach further back, not loop on one snapshot)."""
        return self._ring.pop() if self._ring else None

    def __len__(self):
        return len(self._ring)


# -- on-device sentinel --------------------------------------------------------

def _state_nd_leaves(state):
    """The NDArray leaves of an optimizer state (None | NDArray |
    tuple/list of NDArray-or-None)."""
    from ..ndarray import NDArray

    if state is None:
        return []
    if isinstance(state, NDArray):
        return [state]
    if isinstance(state, (list, tuple)):
        return [s for s in state if isinstance(s, NDArray)]
    return []


class UpdaterSentinel:
    """Device-side non-finite sentinel for the per-batch updater path.

    ``guarded_update`` wraps one real ``optimizer.update`` call: it
    computes the gradient's finiteness and squared norm ON DEVICE, keeps
    copies of the weight and optimizer-state tensors, runs the update
    (which writes them in place), then writes ``torch.where(ok, new,
    old)`` back into them — a poisoned update never lands, and no host
    sync happens here (the verdict scalars stay on device until
    ``read_step`` pulls them, one bool + one float per *step*, after the
    training loop's existing per-batch metric fence).

    Granularity: suppression is per PARAMETER on this path — a NaN
    isolated to one parameter's gradient gates that parameter while the
    step's other parameters still update; the step then counts as
    skipped (any-param verdict) and the escalation/rollback machinery
    covers the partial landing. The scanned path (fit_trainer) gates
    the WHOLE step, since all gradients are in scope at once there."""

    def __init__(self, max_norm=0.0):
        self.max_norm = float(max_norm)
        self._ok = None     # device bool, ANDed across params since read
        self._gsq = None    # device f32, summed across params since read

    def guarded_update(self, optimizer, index, weight, grad, state):
        import torch

        with torch.no_grad():
            g = grad._data
            ok, gsq = grad_flags([g], self.max_norm)
            leaves = [weight] + _state_nd_leaves(state)
            old = [l._data.clone() for l in leaves]
            optimizer.update(index, weight, grad, state)
            for leaf, o in zip(leaves, old):
                t = leaf._data
                t.copy_(torch.where(ok.to(t.device), t, o))
            self._ok = ok if self._ok is None else (self._ok & ok)
            self._gsq = gsq if self._gsq is None else (self._gsq + gsq)

    def read_step(self):
        """Host (finite, grad_norm) for the accumulated step; resets the
        accumulators. The ONLY host sync the sentinel performs."""
        if self._ok is None:
            return True, None
        import torch

        flags = torch.stack([self._ok.float(), self._gsq.float()]).cpu()
        ok = bool(flags[0] > 0)
        gsq = float(flags[1])
        self._ok = None
        self._gsq = None
        gnorm = math.sqrt(gsq) if math.isfinite(gsq) and gsq >= 0 \
            else float("nan")
        return ok, gnorm


def grad_flags(grads, max_norm=0.0):
    """``(ok, gsq)`` device scalars over gradient tensors: every element
    finite (and, with ``max_norm`` > 0, the squared norm within its
    square), and the summed f32 squared norm. Queued on the device,
    never read here, in a handful of multi-tensor kernels whatever the
    number of gradients: finiteness is the 2-norm of ``g * 0`` (0 where
    every element is finite, NaN where one is not: exact, and free of
    the overflow a squared norm of huge finite values would have), the
    squared norm the sum of the per-gradient 2-norms squared."""
    import torch

    grads = list(grads)
    zero = torch.stack(torch._foreach_norm(torch._foreach_mul(grads, 0.0)))
    ok = torch.all(zero == 0)
    norms = torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float32))
    gsq = torch.sum(norms * norms)
    if max_norm > 0.0:
        # per-parameter partial bound on the per-batch path, the whole
        # step's on the scanned path: the global-norm check is the host
        # detector's job; this on-device bound exists so a configured
        # hard ceiling suppresses BEFORE any host read
        ok = ok & (gsq <= float(max_norm) ** 2)
    return ok, gsq


def snapshot_updater_states(updater):
    """Host copies of an updater's optimizer-state NDArrays (momentum,
    Adam moments, ...). Rollback without these is half a rollback: a
    spike's 1e6-scale momentum would re-poison freshly restored weights
    within a step."""
    states = getattr(updater, "states", None) if updater is not None else None
    if not states:
        return None
    return {
        idx: [_host_copy(l) for l in _state_nd_leaves(st)]
        for idx, st in states.items()
    }


def _host_copy(nd):
    """A host copy of an NDArray's tensor (its dtype kept: bf16 states
    round-trip exactly)."""
    return nd._data.detach().to("cpu", copy=True)


def restore_updater_states(updater, snap):
    """Write a snapshot_updater_states dump back into the updater's
    live state NDArrays. Indices created after the snapshot (unlikely:
    state creation is first-batch) are zeroed — stale poison must not
    survive a rollback."""
    states = getattr(updater, "states", None) if updater is not None else None
    if not states:
        return
    snap = snap or {}
    for idx, st in states.items():
        leaves = _state_nd_leaves(st)
        saved = snap.get(idx)
        if saved is not None:
            for leaf, arr in zip(leaves, saved):
                leaf[:] = arr
        else:
            for leaf in leaves:
                leaf[:] = 0


def zero_updater_states(updater):
    """Reset every optimizer-state buffer (the disk-rollback fallback:
    a .params checkpoint carries no optimizer state, and keeping the
    poisoned momenta would defeat the restore)."""
    restore_updater_states(updater, None)


def updater_sentinel():
    """The sentinel ``optimizer.get_updater`` installs, or None when the
    guardian is disabled (the off-by-default zero-overhead contract)."""
    if not enabled():
        return None
    return UpdaterSentinel(
        max_norm=_env_float("MXNET_GUARDIAN_GRADNORM_MAX", 0))


# -- chaos injection (independent of the guardian switch) ----------------------

def _spike_scale():
    return _env_float("MXNET_GUARDIAN_SPIKE_SCALE", 1e8)


def grad_fault_multiplier():
    """One fire decision for the ``grad.nan`` / ``loss.spike`` chaos
    points: NaN, the spike scale, or 1.0. Consumes one hit per armed
    point per call. NOTE the injection clock differs by path: the
    scanned trainer draws once per STEP (one staged multiplier per
    step of a chunk), while the per-batch paths draw once per
    PARAM-UPDATE via corrupt_grad (num_params hits per step, so p=0.02
    poisons ~1-(0.98^P) of steps and skip=N offsets land at step
    ~N/P) — calibrate specs per path with ``faults.fire_pattern``. The
    injection is deliberately OUTSIDE the guardian switch: the
    negative-control chaos leg needs the same poison with the guardian
    off."""
    if _faults.check("grad.nan"):
        return float("nan")
    if _faults.check("loss.spike"):
        return _spike_scale()
    return 1.0


def corrupt_grad(grad):
    """Apply an armed grad.nan/loss.spike fault to one gradient NDArray
    (production no-op: two dict lookups when nothing is armed)."""
    if not (_faults.armed("grad.nan") or _faults.armed("loss.spike")):
        return grad
    mult = grad_fault_multiplier()
    if mult == 1.0:
        return grad
    from ..ndarray import NDArray

    return NDArray(grad._data * mult, grad.context)


# -- loss channel --------------------------------------------------------------

_LOSS_METRIC_NAMES = ("crossentropy", "perplexity", "torch", "caffe",
                      "mae", "mse", "rmse", "nll", "logloss", "loss")


class MetricLossFeed:
    """Per-step loss extracted from a loss-like EvalMetric's running
    ``(sum_metric, num_inst)`` deltas — the z-score channel's default
    source (the fit loops update the metric every batch anyway, so the
    per-step loss is one subtraction, no extra compute). Accuracy-style
    metrics yield None: a proportion is not a loss, and its per-batch
    noise would false-poison the z-score."""

    def __init__(self, metric):
        self._metric = metric if _is_loss_metric(metric) else None
        self._last = (0.0, 0)

    @property
    def active(self):
        return self._metric is not None

    def step_loss(self):
        """Mean loss of the batches folded in since the previous call,
        or None (inactive feed, no new instances, or a multi-output
        metric)."""
        m = self._metric
        if m is None:
            return None
        try:
            s, n = float(m.sum_metric), int(m.num_inst)
        except (TypeError, ValueError):
            return None  # multi-output metric: lists, not scalars
        ls, ln = self._last
        if n < ln:  # metric.reset() (epoch boundary)
            ls, ln = 0.0, 0
        self._last = (s, n)
        if n - ln <= 0:
            return None
        return (s - ls) / (n - ln)


def _is_loss_metric(metric):
    name = getattr(metric, "name", None)
    if not isinstance(name, str):
        return False
    return name.replace("-", "").replace("_", "").lower() \
        in _LOSS_METRIC_NAMES


# -- iterator fast-forward -----------------------------------------------------

def fast_forward(data_iter, n):
    """Consume ``n`` batches from a DataIter (the skip-batches half of
    the PaLM recipe: after a rollback the run resumes PAST the
    offending data, not on it). Stops early at epoch end — the outer
    loop's reset discipline owns the epoch boundary. Returns the number
    of batches actually skipped."""
    skipped = 0
    for _ in range(int(n)):
        try:
            nxt = getattr(data_iter, "next", None)
            if nxt is not None:
                nxt()
            else:
                next(data_iter)
        except StopIteration:
            break
        skipped += 1
    return skipped


# -- the guardian itself -------------------------------------------------------

class TrainingGuardian:
    """Per-fit policy state machine. Create via :meth:`create` (returns
    None unless ``MXNET_GUARDIAN=1``); drive with one
    :meth:`record_step` per optimizer step plus :meth:`maybe_snapshot`,
    and honor a ``"rollback"`` verdict with :meth:`rollback`."""

    def __init__(self, config=None, kvstore=None, prefix=None, logger=None):
        self.cfg = config or GuardianConfig()
        self.kv = kvstore
        self.prefix = prefix
        self.logger = logger or logging
        self.detector = AnomalyDetector(self.cfg)
        self.ring = SnapshotRing(self.cfg.snapshot_keep)
        # rollback restores the LOOP's copy of the weights — correct
        # only when the loop owns them. With a kvstore the authoritative
        # weights live in the store (or the elastic coordinator), and a
        # local restore would be clobbered by the next pull; those paths
        # get votes + coordinated skips + the sentinel, not rollback.
        self.rollback_enabled = kvstore is None
        self.step = 0
        self.consecutive_poisoned = 0
        self.nonfinite_steps = 0
        self.skipped_steps = 0   # updates that never landed (suppressed)
        self.anomaly_steps = 0   # poisoned-but-APPLIED (finite spikes on
        #                          paths without an absolute device bound
        #                          — rollback, not suppression, undoes
        #                          these)
        self.rollbacks = 0
        self._last_good_step = 0
        self._discard_next_chunk = False
        self._loss_feed = None
        self._data_iter = None   # exact-resume frontier bridge (attach_data_iter)
        # elastic stores mirror the coordinator's guard skips into this
        # worker's guardian.* counters; local vote-path accounting must
        # then not ALSO count the same poisoned round (double count)
        self._kv_mirrors_counters = bool(
            getattr(kvstore, "_guardian_mirrors_skips", False))

    @classmethod
    def create(cls, kvstore=None, epoch_end_callback=None, prefix=None,
               logger=None):
        """The fit-loop entry point: None when the guardian is off.
        ``prefix`` for the disk-rollback fallback is discovered from a
        ``callback.do_checkpoint`` epoch callback (same ``.prefix``
        stamp the resume path reads) when not passed explicitly."""
        if not enabled():
            return None
        if prefix is None and epoch_end_callback is not None:
            cbs = epoch_end_callback if isinstance(epoch_end_callback, list) \
                else [epoch_end_callback]
            for cb in cbs:
                p = getattr(cb, "prefix", None)
                if isinstance(p, str):
                    prefix = p
                    break
        return cls(kvstore=kvstore, prefix=prefix, logger=logger)

    def attach_metric(self, eval_metric):
        """Arm the loss z-score channel from the fit loop's eval metric
        (active only for loss-like metrics — see MetricLossFeed)."""
        self._loss_feed = MetricLossFeed(eval_metric)
        return self._loss_feed.active

    def attach_data_iter(self, data_iter):
        """Register the training iterator for exact-resume rollback.
        When the iterator speaks the data-service frontier protocol
        (``mark()``/``restore_mark()``, the JAX package's
        DataServiceIter), every ring snapshot also marks
        the consumed frontier, and :meth:`rollback` seeks the stream
        back to it instead of the approximate
        ``MXNET_GUARDIAN_FF_BATCHES`` skip. Inert (zero-cost) for
        local-read iterators."""
        if hasattr(data_iter, "mark") and \
                hasattr(data_iter, "restore_mark"):
            self._data_iter = data_iter
        return self._data_iter is not None

    def _mark_data_iter(self):
        """Pin the stream frontier to the snapshot just taken: the
        rollback target's data position."""
        it = self._data_iter
        if it is None:
            return
        try:
            it.mark()
        except Exception as e:  # noqa: BLE001 - a mark must never kill fit
            self.logger.warning(
                "guardian: data-service frontier mark failed (%s: %s) — "
                "rollback will fall back to fast-forward",
                type(e).__name__, e)

    def metric_step_loss(self):
        feed = self._loss_feed
        return feed.step_loss() if feed is not None else None

    # -- distributed vote ------------------------------------------------------
    def vote(self, poisoned):
        """Group skip verdict for this step: on a dist/elastic kvstore a
        poisoned vote from any rank skips the step on EVERY rank (the
        replicas-never-diverge invariant); locally it is the local
        verdict."""
        kv = self.kv
        if kv is None:
            return bool(poisoned)
        voter = getattr(kv, "guardian_vote", None)
        if voter is None:
            return bool(poisoned)
        return bool(voter(self.step, bool(poisoned)))

    # -- step accounting -------------------------------------------------------
    def begin_step(self):
        self.step += 1
        return self.step

    @staticmethod
    def _host_grad_stats(grads):
        """(finite, global_norm) over a list of gradient NDArrays: one
        device reduction a gradient, one scalar D2H. Used on the kvstore
        vote path, where every rank must agree before the update runs,
        so the verdict has to reach the host first."""
        import torch

        gsq = None
        for g in grads:
            if g is None:
                continue
            s = torch.sum(torch.square(g._data.float())).to("cpu")
            gsq = s if gsq is None else gsq + s
        if gsq is None:
            return True, None
        v = float(gsq)
        if not math.isfinite(v):
            return False, float("nan")
        return True, math.sqrt(v)

    def guard_batch(self, do_update, grad_arrays_fn=None, updater=None,
                    loss=None):
        """One guarded per-batch optimizer step. ``do_update`` performs
        the real update; on a dist kvstore the group votes first and a
        skip verdict suppresses the update on EVERY rank (same
        decision, same step). On local paths the update always runs —
        the device sentinel inside the (guarded) updater suppresses
        poisoned writes — and the verdict is read back afterwards.
        Returns the :meth:`record_step` action."""
        self.begin_step()
        if loss is None:
            loss = self.metric_step_loss()
        kv_type = getattr(self.kv, "type", "") if self.kv is not None else ""
        if self.kv is not None and self._kv_mirrors_counters:
            # elastic store: the verdict is SERVER-side (the aggregation
            # guard skips poisoned key-rounds for the whole group and
            # mirrors the counts), and a local vote is never cast — so
            # don't pay a per-step device reduction + host sync for a
            # discarded verdict. The loss channel stays live (host-side
            # subtraction): a loss anomaly is local knowledge the server
            # never sees, and it still drives the escalation log.
            do_update()
            return self.record_step(finite=True, grad_norm=None,
                                    loss=loss, suppressed=False)
        if self.kv is not None and kv_type.startswith("dist"):
            grads = grad_arrays_fn() if grad_arrays_fn is not None else []
            finite, gnorm = self._host_grad_stats(grads)
            poisoned = self.detector.classify(
                finite=finite, grad_norm=gnorm, loss=loss) == POISONED
            skip = self.vote(poisoned)
            if not skip:
                do_update()
            return self.record_step(finite=finite, grad_norm=gnorm,
                                    loss=loss, suppressed=skip)
        do_update()
        sentinel = getattr(updater, "sentinel", None) \
            if updater is not None else None
        ok, gnorm = sentinel.read_step() if sentinel is not None \
            else (True, None)
        # finiteness is the NORM's finiteness, not the suppression bit:
        # a finite gradient clipped by MXNET_GUARDIAN_GRADNORM_MAX is a
        # skipped step, not a non-finite one
        finite = gnorm is None or math.isfinite(gnorm)
        return self.record_step(finite=finite, grad_norm=gnorm, loss=loss,
                                suppressed=not ok)

    def record_step(self, finite=True, grad_norm=None, loss=None,
                    suppressed=False):
        """Account one optimizer step; returns ``"ok"``, ``"skip"``, or
        ``"rollback"``. ``suppressed`` marks steps whose update never
        landed (device sentinel or a group skip vote) — they count as
        skipped without being re-suppressed here."""
        verdict = self.detector.classify(finite=finite, grad_norm=grad_norm,
                                         loss=loss)
        poisoned = (verdict == POISONED) or suppressed
        if not finite:
            self.nonfinite_steps += 1
            if _tel.ENABLED:
                _tel.counter("guardian.nonfinite_steps").inc()
        if poisoned:
            # honest accounting: "skipped" means the update never landed
            # (device sentinel / group vote). A finite anomaly the host
            # detector flags AFTER the update applied is an ANOMALY step
            # — only the escalation rollback undoes it
            if suppressed:
                self.skipped_steps += 1
                if _tel.ENABLED:
                    _tel.counter("guardian.skipped_steps").inc()
            else:
                self.anomaly_steps += 1
                if _tel.ENABLED:
                    _tel.counter("guardian.anomaly_steps").inc()
            self.consecutive_poisoned += 1
            self.logger.warning(
                "guardian: step %d poisoned — update %s (finite=%s "
                "grad_norm=%s loss=%s; %d consecutive, rollback at %d)",
                self.step,
                "suppressed" if suppressed else "APPLIED (awaiting "
                "rollback escalation)",
                finite, grad_norm, loss,
                self.consecutive_poisoned, self.cfg.max_skips)
        else:
            self.consecutive_poisoned = 0
            self._last_good_step = self.step
            if verdict == GOOD:
                self.detector.observe(grad_norm=grad_norm, loss=loss)
        if _tel.ENABLED:
            _tel.gauge("guardian.last_good_age").set(
                self.step - self._snapshot_step())
        if (self.rollback_enabled
                and self.consecutive_poisoned >= self.cfg.max_skips
                and (len(self.ring) or self.prefix)):
            return "rollback"
        return "skip" if poisoned else "ok"

    def _snapshot_step(self):
        snap = self.ring.latest()
        return snap[0] if snap else 0

    # -- snapshots -------------------------------------------------------------
    def snapshot_due(self):
        """Cheap gate before paying for a state copy: the newest ring
        entry is at least ``snapshot_steps`` old and the run is not
        inside a poisoned streak."""
        if self.consecutive_poisoned:
            return False
        snap = self.ring.latest()
        return snap is None or self.step - snap[0] >= self.cfg.snapshot_steps

    def commit_snapshot(self, payload):
        """Commit a payload captured at DISPATCH time on the scanned
        path (the state a flush read was produced by the chunk the
        previous drain verified). Discarded when that verification
        found poison — the ring must only ever hold known-good state."""
        if payload is None or self.consecutive_poisoned \
                or self._discard_next_chunk:
            return False
        self.ring.push(self.step, payload)
        self._mark_data_iter()
        if _tel.ENABLED:
            _tel.gauge("guardian.last_good_age").set(0)
        return True

    def maybe_snapshot(self, payload_fn):
        """Refresh the last-good ring when due: the previous snapshot is
        at least ``snapshot_steps`` old AND the current state is good
        (never snapshot inside a poisoned streak — that would make the
        poison the rollback target)."""
        if self.consecutive_poisoned:
            return False
        if self.step - self._snapshot_step() < self.cfg.snapshot_steps \
                and len(self.ring):
            return False
        self.ring.push(self.step, payload_fn())
        self._mark_data_iter()
        if _tel.ENABLED:
            _tel.gauge("guardian.last_good_age").set(0)
        return True

    # -- rollback --------------------------------------------------------------
    def rollback(self, restore_fn, disk_restore_fn=None, data_iter=None):
        """Roll back to last-good: the newest ring snapshot via
        ``restore_fn(payload)``, else the newest valid on-disk
        checkpoint of ``prefix`` via ``disk_restore_fn(arg_params,
        aux_params)``. Fast-forwards ``data_iter`` by
        ``MXNET_GUARDIAN_FF_BATCHES`` (the offending batches are
        already behind the iterator — the extra skip moves past their
        neighborhood). Resets the detector and the poisoned streak.
        Returns the step/epoch rolled back to, or None when no recovery
        source exists (the caller keeps training; the device sentinel
        still protects the weights)."""
        target = None
        snap = self.ring.pop_latest()
        if snap is not None:
            restore_fn(snap[1])
            target = snap[0]
            self.logger.warning(
                "guardian: rolled back to in-memory snapshot of step %d "
                "after %d consecutive poisoned steps",
                target, self.consecutive_poisoned)
        elif self.prefix and disk_restore_fn is not None:
            from ..model import find_latest_checkpoint
            from ..ndarray import load as nd_load

            epoch = find_latest_checkpoint(self.prefix)
            if epoch is not None:
                # params only — a rollback needs weights, not the symbol
                # json (which a Module-driven checkpoint may not have)
                save_dict = nd_load("%s-%04d.params" % (self.prefix, epoch))
                args = {k.split(":", 1)[1]: v for k, v in save_dict.items()
                        if k.startswith("arg:")}
                auxs = {k.split(":", 1)[1]: v for k, v in save_dict.items()
                        if k.startswith("aux:")}
                disk_restore_fn(args, auxs)
                target = -epoch  # epoch, flagged negative for the log
                self.logger.warning(
                    "guardian: ring empty — rolled back to on-disk "
                    "checkpoint %r epoch %d", self.prefix, epoch)
        if target is None:
            self.logger.error(
                "guardian: rollback requested but no snapshot or valid "
                "checkpoint exists; continuing on current weights")
            self.consecutive_poisoned = 0
            self.detector.reset()
            return None
        self.rollbacks += 1
        if _tel.ENABLED:
            _tel.counter("guardian.rollbacks").inc()
        if data_iter is None:
            data_iter = self._data_iter
        restored = self._restore_frontier(data_iter)
        if restored:
            self.logger.warning(
                "guardian: data-service frontier restored for shard(s) "
                "%s — the run replays the exact records after the "
                "snapshot (no approximate fast-forward)", restored)
        elif data_iter is not None and self.cfg.ff_batches:
            n = fast_forward(data_iter, self.cfg.ff_batches)
            self.logger.warning("guardian: fast-forwarded the data "
                                "iterator %d batch(es)", n)
        self.consecutive_poisoned = 0
        self.detector.reset()
        # scanned-path pipelining: one chunk was already dispatched from
        # the pre-rollback state when the verdict arrived; its updates
        # are discarded by the restore and its flags must not be
        # re-accounted as a fresh poisoned streak
        self._discard_next_chunk = True
        return target

    def _restore_frontier(self, data_iter):
        """Exact-resume half of the rollback: seek a frontier-capable
        iterator (DataServiceIter) back to its last mark. Returns the
        restored shard ids ([] when unavailable — the fast-forward
        fallback then applies)."""
        if data_iter is None or not hasattr(data_iter, "restore_mark"):
            return []
        try:
            return list(data_iter.restore_mark() or [])
        except Exception as e:  # noqa: BLE001 - degrade, never kill fit
            self.logger.warning(
                "guardian: data-service frontier restore failed "
                "(%s: %s) — falling back to fast-forward",
                type(e).__name__, e)
            return []

    # -- scanned-path bridge ---------------------------------------------------
    def drain_chunk(self, flags, losses=None):
        """Account a drained K-step chunk's device verdicts (the scanned
        fit path: ``flags`` is ``(ok_array, gnorm_array)`` with leading
        axis K, or None when the trainer ran unguarded; ``losses`` is an
        optional per-step loss list from the metric feed). Returns
        ``"rollback"`` as soon as the streak escalates — the caller
        stops accounting and restores."""
        if flags is None:
            return "ok"
        if self._discard_next_chunk:
            self._discard_next_chunk = False
            return "ok"
        import numpy as _np

        oks = _np.asarray(flags[0]).ravel()
        gnorms = _np.asarray(flags[1], dtype=_np.float64).ravel()
        out = "ok"
        for i, (ok, gn) in enumerate(zip(oks, gnorms)):
            self.begin_step()
            gn = float(gn)
            action = self.record_step(
                # finiteness = the norm's, not the suppression bit (a
                # finite grad clipped by the absolute bound is a skip,
                # not a non-finite step)
                finite=math.isfinite(gn), grad_norm=gn,
                loss=(losses[i] if losses is not None
                      and i < len(losses) else None),
                suppressed=not bool(ok))
            if action == "rollback":
                return "rollback"
            if action == "skip":
                out = "skip"
        return out

    def end_epoch(self):
        """Epoch boundary on the scanned path: no chunk is in flight
        across it, so a rollback on the epoch's final drain must not
        discard the NEXT epoch's first (clean, post-restore) chunk."""
        self._discard_next_chunk = False

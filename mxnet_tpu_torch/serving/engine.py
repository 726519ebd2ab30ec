"""Request front-end: ``Engine.submit(prompt) -> stream of tokens``.

Counterpart of ``mxnet_tpu/serving/engine.py``. An Engine owns one
model's params on one device, a paged KV pool sized by
:class:`ServingConfig`, a :class:`~.scheduler.Scheduler` and the
bucketed step (:class:`~.model.ServingModel`). Each ``step()`` runs at
most one decode batch and one prefill batch; ``start()`` drives steps
from a background thread, while tests drive ``step()`` directly.

Prompts of at least ``cp_min_tokens`` tokens on an engine with a
``mesh`` are prefilled whole by :func:`~.model.cp_prefill_kv` (with
``cp_kind="ulysses"`` the attention of each layer is the flash-attention
kernel); shorter prompts take the paged chunked prefill.

Admission control: ``submit`` raises :class:`QueueFullError` past
``max_queue_depth`` and rejects outright a request whose worst-case
footprint can never fit the pool or the model's position table.

Sampling: ``temperature > 0`` samples on the device with top-k/top-p
filtering, every draw keyed by (seed, token position, salt) with JAX's
threefry bits (``sampling.py``), so a stream equals the JAX package's
and replays identically after eviction.

Speculative decoding (``ServingConfig.spec``, ``MXNET_SERVE_SPEC``): a
draft transformer proposes up to ``spec_k`` tokens per scheduled decode
turn, the target verifies them all in one ragged step with
accept/reject and resampling on the device, and the bookkeeping rolls
both block tables back to the first rejection. Off by default, and then
no draft pool exists.

Draining: ``drain()`` closes admissions (``submit`` raises
:class:`QueueFullError` with reason ``draining``) while everything
accepted runs to completion; ``resume()`` reopens them.

Telemetry (``MXNET_TELEMETRY=1``, ``telemetry/``): the JAX package's
catalog — counters ``serving.requests_{admitted,completed,evicted,
rejected,cancelled}``, ``serving.streams_reaped``,
``serving.drains_total`` and ``serving.spec_turns`` /
``serving.spec_tokens_drafted`` / ``serving.spec_tokens_accepted``;
gauges ``serving.kv_pool_utilization`` / ``serving.kv_pool_hwm_blocks``
/ ``serving.tokens_per_s`` / ``serving.queue_depth`` /
``serving.spec_accept_rate``; histograms ``serving.ttft_s``,
``serving.ttft_sync_s`` (TTFTs inside a weight-sync window),
``serving.token_latency_s``, ``serving.decode_batch_size``,
``serving.decode_step_s`` and ``serving.spec_accepted_tokens``; spans
``serve.decode``, ``serve.prefill``, ``serve.draft_prefill``,
``serve.cp_prefill``, ``serve.spec_turn`` and a request's lifecycle
events under one trace id. ``Engine.stats()`` mirrors them as plain
numbers with telemetry off; ``introspect()`` is ``/servingz``'s payload.

Live weight sync (``MXNET_WSYNC``, ``wsync/``): ``install_weights``
copies a gated param set (target + draft) onto the engine's device,
then swaps it in, with the f32 unembedding of the cp prefill, under
the step lock between scheduled steps; ``rollback_weights`` restores
the newest last-good ring entry. Off by default: no subscriber thread,
no ring growth, no journal records.

mxprof (``MXNET_PROF=1``, ``telemetry/prof.py``): the serving model's
steps land ``serve.prefill``/``serve.decode`` step breakdowns, and a
speculative turn ``serve.spec_draft`` and ``serve.spec_verify`` ones
(``mxnet_tpu/serving/engine.py:994-1131``).

The compile/transfer verifier (``MXNET_JIT_VERIFY``,
``analysis/compile_verify.py``): the serving model's bucket programs
are its boundaries, and the decode step and the speculative turn are
D2H regions with the JAX package's budgets
(``mxnet_tpu/serving/engine.py:968``, ``:1042``, ``:1069``): a plain
decode step may pull 4 bytes a lane of its batch bucket (the token
vector), a speculative turn 4·B·(K + 3) (accepted counts, final tokens
and draft tokens; never logits).

Not in this release: the JAX package's lock tracer
(``MXNET_ENGINE_VERIFY``, ``analysis/engine_verify.py``): with it set,
``Engine`` raises.
"""
from __future__ import annotations

import dataclasses
import os
import queue as _queue
import threading
import time
import weakref

import numpy as np
import torch

from .. import telemetry as _tel
from ..analysis import compile_verify as _cv
from ..telemetry import prof as _prof
from ..base import MXNetError, env_bool as _env_bool, env_int as _env_int
from ..context import resolve_device
from ..wsync import enabled as _wsync_enabled
from . import sampling as _samp
from .kv_cache import PagedKVPool, blocks_for_tokens
from .model import ServingModel, bucket_for, cp_prefill_kv
from .scheduler import CANCELLED, DECODE, FINISHED, PREFILL, Request, \
    Scheduler

__all__ = ["Engine", "ServingConfig", "StreamHandle", "QueueFullError",
           "live_engines"]

_END = object()

# every constructed Engine, weakly held — the /servingz introspection
# endpoint (telemetry/server.py) iterates this to render live request
# tables without the serving layer ever knowing about HTTP
_live_engines = weakref.WeakSet()

# switches of the JAX package whose modules are not ported
_UNPORTED_SWITCHES = (
    ("MXNET_ENGINE_VERIFY", "the lock tracer (analysis/engine_verify.py)"),)


def live_engines():
    """The Engines currently alive in this process (weakly tracked)."""
    return sorted(_live_engines, key=id)


def _env_on(name):
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "off", "no")


class QueueFullError(MXNetError):
    """submit() past max_queue_depth, or during a drain — shed load
    upstream. Carries the observed ``queue_depth`` and a computed
    ``retry_after_s`` hint (one admission slot's expected time to free
    at the current service rate), which the fleet router reads."""

    def __init__(self, message, queue_depth=0, retry_after_s=1.0):
        super().__init__(message)
        self.queue_depth = int(queue_depth)
        self.retry_after_s = float(retry_after_s)


@dataclasses.dataclass
class ServingConfig:
    """Engine knobs. Every field defaults from an ``MXNET_SERVE_*`` env
    var, as in the JAX package."""

    block_size: int = None
    num_blocks: int = None
    max_batch: int = None
    max_active: int = None
    prefill_chunk: int = None
    token_budget: int = None
    max_queue_depth: int = None
    policy: str = "continuous"
    eos_id: int = None
    max_seq_tokens: int = None   # per-request cap; default model max_seq_len
    # speculative decoding (off by default: no draft pool, no draft)
    spec: bool = None            # MXNET_SERVE_SPEC
    spec_k: int = None           # draft tokens per turn, MXNET_SERVE_SPEC_K
    events_max: int = None       # scheduler event-ring bound
    # context-parallel long-prompt prefill (model.cp_prefill_kv):
    mesh: object = None
    cp_kind: str = "ring"
    cp_seq_axis: str = "seq"
    cp_min_tokens: int = None
    cp_chunk: int = None
    # idle-stream reaper: a StreamHandle nobody consumes for this many
    # seconds is cancelled and its KV blocks freed (0 = off)
    stream_idle_s: float = None

    def __post_init__(self):
        if self.block_size is None:
            self.block_size = _env_int("MXNET_SERVE_BLOCK_SIZE", 16)
        if self.num_blocks is None:
            self.num_blocks = _env_int("MXNET_SERVE_KV_BLOCKS", 256)
        if self.max_batch is None:
            self.max_batch = _env_int("MXNET_SERVE_MAX_BATCH", 8)
        if self.max_active is None:
            self.max_active = _env_int("MXNET_SERVE_MAX_ACTIVE",
                                       2 * self.max_batch)
        if self.prefill_chunk is None:
            self.prefill_chunk = _env_int("MXNET_SERVE_PREFILL_CHUNK", 64)
        if self.spec is None:
            self.spec = _env_bool("MXNET_SERVE_SPEC", False)
        if self.spec_k is None:
            self.spec_k = _env_int("MXNET_SERVE_SPEC_K", 4)
        if self.token_budget is None:
            decode_cost = (1 + self.spec_k) if self.spec else 1
            self.token_budget = _env_int(
                "MXNET_SERVE_TOKEN_BUDGET",
                self.max_batch * decode_cost + self.prefill_chunk)
        if self.max_queue_depth is None:
            self.max_queue_depth = _env_int("MXNET_SERVE_MAX_QUEUE", 64)
        if self.cp_min_tokens is None:
            self.cp_min_tokens = _env_int("MXNET_SERVE_CP_MIN_TOKENS", 2048)
        if self.stream_idle_s is None:
            try:
                self.stream_idle_s = float(
                    os.environ.get("MXNET_SERVE_STREAM_IDLE_S", "") or 0.0)
            except ValueError:
                self.stream_idle_s = 0.0


class StreamHandle:
    """Per-request token stream + control surface."""

    def __init__(self, engine, req):
        self._engine = engine
        self._req = req
        self._q = _queue.Queue()
        self.status = "running"
        # last time a consumer pulled a token: the idle reaper's signal
        self._touched_t = time.monotonic()
        req.stream = self

    @property
    def request_id(self):
        return self._req.rid

    def _emit(self, token):
        self._q.put(int(token))

    def _idle_abandoned(self, now, idle_s):
        """True when nobody has consumed for ``idle_s`` seconds while
        tokens sat ready."""
        return (self.status == "running" and self._q.qsize() > 0
                and now - self._touched_t > idle_s)

    def _end(self, status):
        self.status = status
        self._q.put(_END)

    def cancel(self):
        """Request cancellation; takes effect at the next scheduler
        sweep (blocks are freed, stream ends with status "cancelled")."""
        self._engine.cancel(self._req)

    def tokens(self, timeout=None):
        """Iterate generated tokens as they land; ends when the request
        finishes or is cancelled."""
        while True:
            item = self._q.get(timeout=timeout)
            self._touched_t = time.monotonic()
            if item is _END:
                return
            yield item

    def result(self, timeout=None):
        """Block until the stream ends; returns the full token list."""
        return list(self.tokens(timeout=timeout))


class Engine:
    """Continuous-batching serving engine over a transformer LM.

    ``SPEC_WINDOW_SECS`` bounds the sliding window behind the
    ``spec_accept_rate_window`` stat (the current draft quality; the
    cumulative rate is reported alongside).

    Parameters
    ----------
    params : dict of tensors
        ``models/transformer.py`` params; moved to ``device`` if they
        live elsewhere.
    model_cfg : TransformerConfig
    cfg : ServingConfig, optional
    draft_params, draft_cfg : dict of tensors / TransformerConfig, optional
        The draft model for speculative decoding (required when
        ``cfg.spec``, refused otherwise): a smaller transformer whose
        proposals the target verifies K+1 at a time; moved to
        ``device`` like ``params``.
    device : torch.device, str or Context, optional
        Where the engine runs; default ``cuda:0`` (raises without CUDA).
    """

    #: sliding-window width for the live accept-rate signal
    SPEC_WINDOW_SECS = 30.0

    def __init__(self, params, model_cfg, cfg=None, draft_params=None,
                 draft_cfg=None, device=None):
        for name, what in _UNPORTED_SWITCHES:
            if _env_on(name):
                raise MXNetError("%s: %s is not ported; unset it"
                                 % (name, what))
        self.cfg = cfg or ServingConfig()
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.model_cfg = model_cfg
        # cp prefill samples its first token from f32 x_last @ embed.T:
        # the f32 unembedding is made once a weight version, not per
        # long prompt
        self._unembed = self._make_unembed(self.params)
        bs = self.cfg.block_size
        max_seq = min(self.cfg.max_seq_tokens or model_cfg.max_seq_len,
                      model_cfg.max_seq_len)
        self.max_seq_tokens = max_seq
        self.pool = PagedKVPool(
            model_cfg.num_layers, model_cfg.num_heads, model_cfg.head_dim,
            self.cfg.num_blocks, bs, dtype=model_cfg.dtype,
            device=self.device)
        w = blocks_for_tokens(max_seq, bs)
        # buckets cover the prefill batch too, which can span the whole
        # admission depth (max_active), not just the decode width
        top = max(self.cfg.max_batch, self.cfg.max_active)
        batch_buckets = sorted({1, 2, 4, 8, 16, 32, 64, self.cfg.max_batch,
                                top})
        batch_buckets = [b for b in batch_buckets if b <= top]
        chunk_buckets = sorted({8, 16, 32, 64, 128, 256,
                                self.cfg.prefill_chunk})
        chunk_buckets = [c for c in chunk_buckets
                         if c <= self.cfg.prefill_chunk]
        # speculative decoding: draft model + mirrored paged pool; the
        # verify chunk is exactly spec_k + 1 wide, and the draft's chunk
        # buckets gain 2 (the catch-up ingest after a full accept)
        self.draft_params = None
        self.draft_cfg = None
        self.draft_model = None
        self.draft_pool = None
        spec_k = 0
        if self.cfg.spec:
            if draft_params is None or draft_cfg is None:
                raise MXNetError(
                    "ServingConfig.spec requires draft_params + "
                    "draft_cfg (the draft transformer)")
            if self.cfg.policy == "static":
                raise MXNetError(
                    "speculative decoding requires policy="
                    "'continuous' (static is the fixed-shape baseline)")
            if self.cfg.spec_k < 1:
                raise MXNetError("spec_k must be >= 1, got %d"
                                 % self.cfg.spec_k)
            spec_k = self.cfg.spec_k
            self.draft_params = _to_device(draft_params, self.device)
            self.draft_cfg = draft_cfg
            self.draft_pool = self.pool.mirror(
                draft_cfg.num_layers, draft_cfg.num_heads,
                draft_cfg.head_dim, dtype=draft_cfg.dtype)
            self.draft_model = ServingModel(
                draft_cfg, bs, w, batch_buckets=batch_buckets,
                chunk_buckets=sorted(set(chunk_buckets) | {2}))
        elif draft_params is not None or draft_cfg is not None:
            raise MXNetError(
                "draft model passed but ServingConfig.spec is off — "
                "set spec=True (or MXNET_SERVE_SPEC=1)")
        self.model = ServingModel(model_cfg, bs, w,
                                  batch_buckets=batch_buckets,
                                  chunk_buckets=chunk_buckets)
        self.sched = Scheduler(
            self.pool, max_batch=self.cfg.max_batch,
            prefill_chunk=self.cfg.prefill_chunk,
            token_budget=self.cfg.token_budget, policy=self.cfg.policy,
            max_active=self.cfg.max_active, draft_pool=self.draft_pool,
            spec_k=spec_k, events_max=self.cfg.events_max)
        self._lock = threading.RLock()
        # serializes whole steps: model execution runs outside _lock
        # (submit must not block on a dispatch), so two concurrent
        # step loops would otherwise write the same pool at once
        self._step_lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._by_rid = {}
        self._last_counts = {}
        self._stats = {"admitted": 0, "completed": 0, "evicted": 0,
                       "rejected": 0, "cancelled": 0, "tokens_emitted": 0,
                       "steps": 0, "streams_reaped": 0, "cp_prefills": 0,
                       "spec_turns": 0, "spec_tokens_drafted": 0,
                       "spec_tokens_accepted": 0}
        self._ttfts = []
        self._token_lats = []
        self._rate_window = []  # (t, cumulative tokens) for tokens/s
        # (t, drafted, accepted) per spec turn over a sliding window:
        # the accept-rate signal must track CURRENT draft quality, not
        # the lifetime average
        self._spec_window = []
        self._thread = None
        self._stop = False
        self._last_rate = 0.0
        self._draining = False
        self._drained = False
        # -- wsync: staged hot-swap state. _installed_params and
        # _installed_draft are identity tokens — step() rejects a params
        # rebind that bypassed install_weights(), so the gates
        # (shape/dtype, finiteness, acceptance) are enforced
        self._installed_params = self.params
        self._installed_draft = self.draft_params
        self._weight_version = None
        self._weight_ring = []   # (version, params, draft, unembed)
        self._weight_ring_keep = max(1, _env_int("MXNET_WSYNC_RING", 2))
        try:
            self._sync_ttft_window = float(
                os.environ.get("MXNET_WSYNC_TTFT_WINDOW", "") or 2.0)
        except ValueError:
            self._sync_ttft_window = 2.0
        self._sync_mark_until = 0.0   # monotonic: TTFTs before this
        self._sync_ttfts = []         # land in the sync-window stats
        self._wsync_sub = None
        if _wsync_enabled():
            from ..wsync.subscriber import maybe_autosync

            self._wsync_sub = maybe_autosync(self)
        _live_engines.add(self)

    # -- intake --------------------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, eos_id=None,
               temperature=0.0, top_k=0, top_p=1.0, seed=0,
               prefix_tokens=None):
        """Queue a generation request; returns a StreamHandle.

        ``temperature`` 0 (the default) is exact greedy decode;
        positive temperatures sample on the device with top-k/top-p
        filtering, every draw keyed by ``(seed, token position)``, so
        the plain-decode stream replays identically across evictions
        and re-chunking. Under speculation a shifted turn alignment may
        change which salt stream a position draws from (accepted draft,
        residual or bonus): the same distribution, byte-stable only at
        temperature 0 or for a fixed schedule.

        ``prefix_tokens`` is the fleet redelivery hook
        (``serving/fleet/router.py``): tokens this request already
        streamed on a replica that died are folded into the recompute
        context. The request prefills ``prompt + prefix`` and decodes
        onward; the prefix counts against ``max_new_tokens`` but is
        never re-emitted. Sampling is keyed by (seed, global position),
        so the continuation is the uninterrupted stream's wherever the
        numerics agree: in f32 on the host exactly; in bf16 on the card
        the prefill's products round unlike the decode steps' and can
        part from it at a near-tie.

        Raises QueueFullError past ``max_queue_depth`` or while
        draining, and MXNetError for requests that could never fit the
        KV pool / position table (all counted under
        serving.requests_rejected).
        """
        if temperature < 0 or top_k < 0 or not 0.0 < top_p <= 1.0:
            with self._lock:
                self._reject()
            raise MXNetError(
                "invalid sampling params: temperature >= 0, top_k >= 0 "
                "and 0 < top_p <= 1 required (got %r, %r, %r)"
                % (temperature, top_k, top_p))
        req = Request(prompt, max_new_tokens,
                      eos_id=self.cfg.eos_id if eos_id is None else eos_id,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed)
        if prefix_tokens is not None and len(prefix_tokens):
            pre = np.asarray(prefix_tokens, np.int32).reshape(-1)
            if pre.shape[0] >= max_new_tokens:
                with self._lock:
                    self._reject("prefix")
                raise MXNetError(
                    "prefix_tokens (%d) already meets max_new_tokens "
                    "(%d) — nothing left to generate" % (pre.shape[0],
                                                         max_new_tokens))
            req.context = np.concatenate([req.context, pre])
            req.generated = [int(t) for t in pre]
        total = req.total_len()
        limit = min(self.max_seq_tokens,
                    self.sched.max_request_tokens(),
                    self.model.max_blocks * self.cfg.block_size)
        with self._lock:
            if self._draining:
                depth = len(self.sched.queue)
                self._reject("draining", depth)
                raise QueueFullError(
                    "engine draining — admissions closed (resume() "
                    "reopens)", queue_depth=depth,
                    retry_after_s=self._retry_after_locked(depth))
            if total > limit:
                self._reject("geometry")
                raise MXNetError(
                    "request needs %d tokens; engine limit is %d "
                    "(pool/max_seq geometry)" % (total, limit))
            if len(self.sched.queue) >= self.cfg.max_queue_depth:
                depth = len(self.sched.queue)
                self._reject("queue_full", depth)
                raise QueueFullError(
                    "admission queue full (%d)" % self.cfg.max_queue_depth,
                    queue_depth=depth,
                    retry_after_s=self._retry_after_locked(depth))
            req.submit_t = time.monotonic()
            if _tel.ENABLED:
                # request-scoped trace: every lifecycle span of this
                # request (submit -> prefill -> decode -> complete)
                # shares one trace id
                req.trace = _tel.mint_trace()
                req.wall0 = time.time()
                _tel.event("serve.request.submit", t=req.wall0,
                           trace=req.trace, rid=req.rid,
                           prompt_len=int(req.prompt.shape[0]),
                           prefix_len=len(req.generated),
                           max_new_tokens=req.max_new_tokens)
            handle = StreamHandle(self, req)
            self._by_rid[req.rid] = req
            self.sched.submit(req)
            self._work.notify_all()
        return handle

    def cancel(self, req):
        with self._lock:
            self.sched.cancel(req)
            self._work.notify_all()

    def _reap_idle_locked(self, now):
        """Cancel streams nobody is consuming (caller holds _lock); the
        blocks free on the next plan()."""
        idle = self.cfg.stream_idle_s
        if not idle or idle <= 0:
            return
        for req in list(self._by_rid.values()):
            s = req.stream
            if s is not None and s._idle_abandoned(now, idle):
                self._stats["streams_reaped"] += 1
                if _tel.ENABLED:
                    _tel.counter("serving.streams_reaped").inc()
                    _tel.event("serve.stream.reaped", rid=req.rid,
                               trace=req.trace,
                               idle_s=now - s._touched_t,
                               tokens=len(req.generated))
                self.sched.cancel(req)

    # -- graceful drain ------------------------------------------------------
    def drain(self, wait=False, timeout=None):
        """Stop admissions; everything already accepted (queued or
        active) runs to completion. New ``submit`` calls raise
        :class:`QueueFullError` (counted as rejections — an upstream
        router sheds to other replicas). When the last in-flight
        request finishes, a ``drained`` event lands in the scheduler
        event log, ``serve.drained`` in the journal, and ``/servingz``
        reports ``drained: true``.

        ``wait=True`` blocks until drained (the caller must be driving
        steps, or have ``start()`` running). Returns True when drained.
        """
        with self._lock:
            if not self._draining:
                self._draining = True
                if _tel.ENABLED:
                    _tel.counter("serving.drains_total").inc()
                self._check_drained_locked()
                self._work.notify_all()
            if not wait:
                return self._drained
            deadline = (time.monotonic() + timeout
                        if timeout is not None else None)
            while not self._drained:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._work.wait(timeout=remaining if remaining is not None
                                else 0.5)
            return True

    def resume(self):
        """Reopen admissions after :meth:`drain`."""
        with self._lock:
            if self._draining:
                self._draining = False
                self._drained = False
                self._work.notify_all()

    def accepting(self):
        """True while ``submit`` admits work — the /readyz signal: a
        draining replica is alive but not ready."""
        with self._lock:
            return not self._draining

    @property
    def draining(self):
        with self._lock:
            return self._draining

    @property
    def drained(self):
        with self._lock:
            return self._drained

    def _check_drained_locked(self):
        """Latch the drained state once the last accepted request is
        gone (caller holds ``_lock``)."""
        if (self._draining and not self._drained
                and not self.sched.queue and not self.sched.active):
            self._drained = True
            self.sched.note_drained()
            if _tel.ENABLED:
                _tel.event("serve.drained",
                           completed=self._stats["completed"],
                           cancelled=self._stats["cancelled"])
            self._work.notify_all()

    def _reject(self, reason="params", queue_depth=None):
        self._stats["rejected"] += 1
        if _tel.ENABLED:
            _tel.counter("serving.requests_rejected").inc()
            # the rejection detail rides a journal event (reason, depth
            # and the backoff hint handed to the caller)
            _tel.event("serve.request.reject", reason=reason,
                       queue_depth=queue_depth,
                       retry_after_s=(
                           self._retry_after_locked(queue_depth)
                           if queue_depth is not None else None))

    def _retry_after_locked(self, queue_depth=None):
        """Backoff hint for a rejected submit: expected seconds until
        one admission slot frees at the current token rate, clamped to
        [0.05, 30]; 1 s when idle or cold."""
        rate = self._last_rate
        active = len(self.sched.active)
        if rate <= 0.0 or not active:
            return 1.0
        remaining = min(
            max(1, r.max_new_tokens - len(r.generated))
            for r in self.sched.active)
        return float(min(30.0, max(0.05, remaining * active / rate)))

    # -- speculative-decoding runtime toggle ---------------------------------
    def set_spec(self, enabled):
        """Flip speculation at runtime (takes effect at the next
        scheduler plan). The draft pool stays resident and mirrored, so
        re-enabling is instant. Raises when the engine was built
        without a draft model."""
        if self.draft_model is None:
            raise MXNetError(
                "speculation was not configured on this engine "
                "(ServingConfig.spec + draft model)")
        with self._lock:
            self.sched.set_spec_k(self.cfg.spec_k if enabled else 0)

    @property
    def spec_enabled(self):
        with self._lock:
            return self.sched.spec_active()

    def warmup_spec(self, batch_sizes=None):
        """Run every speculative-path entry point once before traffic:
        the draft model's step at each batch and chunk bucket, and the
        draft turn (both steady-state ingest widths) and verify at each
        batch bucket, so lazy CUDA and cuBLAS set-up lands here.
        Inactive rows write only the scratch block, so warming against
        the live pools is safe."""
        if self.draft_model is None:
            return
        K = self.cfg.spec_k
        for b in (batch_sizes or self.draft_model.batch_buckets):
            for c in self.draft_model.chunk_buckets:
                self.draft_model.step(
                    self.draft_params, self.draft_pool.k, self.draft_pool.v,
                    np.zeros((b, c), np.int32), np.zeros((b,), np.int32),
                    np.ones((b,), np.int32),
                    np.zeros((b, self.draft_model.max_blocks), np.int32),
                    np.zeros((b,), bool))
        for b in (batch_sizes or self.model.batch_buckets):
            bt = np.zeros((b, self.model.max_blocks), np.int32)
            ks = np.full((b,), K, np.int32)
            act = np.zeros((b,), bool)
            for cin in (1, 2):
                d, q = self.draft_model.draft_turn(
                    self.draft_params, self.draft_pool.k, self.draft_pool.v,
                    np.zeros((b, cin), np.int32), np.zeros((b,), np.int32),
                    np.full((b,), cin, np.int32), bt, act, ks, K)
            self.model.verify(
                self.params, self.pool.k, self.pool.v,
                np.zeros((b, 1), np.int32), d, q, np.zeros((b,), np.int32),
                1 + ks, bt, act)

    # -- live weight sync (wsync/) -------------------------------------------
    def install_weights(self, version, params, draft_params=None,
                        trace=None):
        """Atomically swap in a gated weight set between scheduled steps:
        target params, draft params, and the f32 unembedding of the cp
        prefill in ONE transaction under the step lock — no drain. The
        set (tensors on any device, or numpy arrays) is first copied
        onto the engine's device on a side stream, outside the locks,
        so the locks cover a rebind only. The outgoing version lands on
        the bounded last-good ring (``MXNET_WSYNC_RING``) for
        :meth:`rollback_weights`.

        Gates (reject ⇒ ``wsync.rejected_total`` + a journaled
        ``rejected`` record + MXNetError, live params untouched):

        - shape/dtype mismatch against the live set — hard reject;
        - non-finite values in any floating tensor, bf16 included.

        ``draft_params`` refresh in the same transaction; a version
        without a draft half swaps the target only (and a draft half is
        dropped when the engine was built without a draft model).
        """
        from ..wsync import common as _wc

        version = int(version)
        if _wc.param_manifest(params) != _wc.param_manifest(self.params):
            self._reject_weights(
                version, trace, "shape/dtype mismatch against live "
                "params (the engine's buffers are sized for them — a "
                "resized model needs a new engine, not a sync)")
        if draft_params is not None and self.draft_model is None:
            draft_params = None
        if draft_params is not None and (
                _wc.param_manifest(draft_params)
                != _wc.param_manifest(self.draft_params)):
            self._reject_weights(
                version, trace,
                "draft shape/dtype mismatch against live draft params")
        staged, staged_draft, unembed = self._stage_weights(
            params, draft_params)
        bad = _wc.nonfinite_keys(_wc.flatten_params(staged))
        if bad:
            self._reject_weights(
                version, trace,
                "non-finite tensors: %s" % ", ".join(sorted(bad)[:4]))
        if staged_draft is not None:
            dbad = _wc.nonfinite_keys(_wc.flatten_params(staged_draft))
            if dbad:
                self._reject_weights(
                    version, trace, "non-finite draft tensors: %s"
                    % ", ".join(sorted(dbad)[:4]))
        with self._step_lock:
            with self._lock:
                self._weight_ring.append(
                    (self._weight_version, self.params, self.draft_params,
                     self._unembed))
                del self._weight_ring[:-self._weight_ring_keep]
                self.params = staged
                self._installed_params = staged
                if staged_draft is not None:
                    self.draft_params = staged_draft
                self._installed_draft = self.draft_params
                self._unembed = unembed
                self._weight_version = version
                self._sync_mark_until = (time.monotonic()
                                         + self._sync_ttft_window)
                if _tel.ENABLED:
                    _tel.counter("wsync.versions_applied_total").inc()
                    _tel.gauge("wsync.current_version").set(version)
                _wc.journal("applied", version, trace=trace,
                            draft=staged_draft is not None,
                            ring=len(self._weight_ring))
        return version

    def _stage_weights(self, params, draft_params):
        """Fresh copies of ``params`` (and ``draft_params``) on the
        engine's device, and the f32 unembedding when the engine has a
        mesh. On CUDA the copies run on a side stream, so the decode
        loop's kernels keep running, and the host waits for them before
        the swap."""
        from ..wsync import common as _wc

        def copy(tree):
            return _tree_map(
                lambda t: (t.detach() if isinstance(t, torch.Tensor)
                           else _wc.host_tensor(t)).to(self.device,
                                                       copy=True), tree)

        if self.device.type != "cuda":
            staged = copy(params)
            draft = copy(draft_params) if draft_params is not None else None
            return staged, draft, self._make_unembed(staged)
        side = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(side):
            staged = copy(params)
            draft = copy(draft_params) if draft_params is not None else None
            unembed = self._make_unembed(staged)
        side.synchronize()
        # the tensors were made on the side stream and are read on the
        # main one: their memory must not be reused before that stream's
        # reads finish
        for tree in (staged, draft, unembed):
            for t in _leaves(tree):
                t.record_stream(main)
        return staged, draft, unembed

    def _make_unembed(self, params):
        """cp prefill samples its first token from f32 x_last @ embed.T:
        the f32 unembedding is made once a weight version."""
        if self.cfg.mesh is None:
            return None
        return params["embed"].float().T.contiguous()

    def rollback_weights(self, trace=None):
        """Reinstall the newest last-good ring entry (target + draft +
        unembedding in one transaction, like :meth:`install_weights`).
        A rollback CONSUMES its entry — repeated calls walk further
        back, never loop on one version. Returns ``{"from_version",
        "to_version"}``; raises MXNetError on an empty ring."""
        from ..wsync import common as _wc

        with self._step_lock:
            with self._lock:
                if not self._weight_ring:
                    raise MXNetError(
                        "rollback_weights: last-good ring is empty "
                        "(no prior version to restore)")
                version, params, draft, unembed = self._weight_ring.pop()
                from_v = self._weight_version
                if trace is None and _tel.ENABLED:
                    trace = _tel.mint_trace()
                self.params = params
                self._installed_params = params
                if draft is not None and self.draft_model is not None:
                    self.draft_params = draft
                self._installed_draft = self.draft_params
                self._unembed = unembed
                self._weight_version = version
                if _tel.ENABLED:
                    _tel.counter("wsync.rollbacks_total").inc()
                    _tel.gauge("wsync.current_version").set(
                        version if version is not None else 0)
                _wc.journal("rolled_back", version, trace=trace,
                            from_version=from_v,
                            ring=len(self._weight_ring))
        return {"from_version": from_v, "to_version": version}

    def _reject_weights(self, version, trace, reason):
        from ..wsync import common as _wc

        if _tel.ENABLED:
            _tel.counter("wsync.rejected_total").inc()
        _wc.journal("rejected", version, trace=trace, reason=reason)
        raise MXNetError("weight sync version %d rejected: %s"
                         % (version, reason))

    def weight_version(self):
        """Version installed by the newest sync (None before any)."""
        with self._lock:
            return self._weight_version

    # -- synchronous batch API -----------------------------------------------
    def generate(self, prompts, max_new_tokens=16):
        """Submit all prompts, drive the loop to completion, return the
        generated token lists."""
        handles = [self.submit(p, max_new_tokens) for p in prompts]
        with self._lock:
            background = self._thread is not None
        if not background:
            self.run_until_idle()
        return [h.result() for h in handles]

    # -- the step loop -------------------------------------------------------
    def step(self):
        """Run one scheduler step (<=1 decode batch + <=1 prefill
        batch). Returns True when any work ran."""
        with self._step_lock:
            if (self.params is not self._installed_params
                    or (self.draft_model is not None
                        and self.draft_params is not self._installed_draft)):
                raise MXNetError(
                    "Engine params were rebound without "
                    "install_weights(): a direct write bypasses the "
                    "staged-swap gates (shape/dtype, finiteness, "
                    "acceptance)")
            with self._lock:
                self._reap_idle_locked(time.monotonic())
                plan = self.sched.plan()
                self._mirror_events()
                decode = list(plan.decode)
                prefill = list(plan.prefill)
                spec_k = dict(plan.spec_k)
                now = time.monotonic()
                for req, _cs, _clen in prefill:
                    if req.admit_t is None:  # first admission only —
                        req.admit_t = now    # eviction re-prefills later
            worked = False
            if decode:
                self._run_decode(decode, spec_k)
                worked = True
            if prefill:
                self._run_prefill(prefill)
                worked = True
            if worked:
                with self._lock:
                    self._stats["steps"] += 1
                    self._mirror_events()
                    self._update_gauges()
            return worked

    def run_until_idle(self, max_steps=None):
        """Drive step() until no work remains; returns steps run."""
        n = 0
        while self.step():
            n += 1
            if max_steps is not None and n >= max_steps:
                break
        return n

    def start(self):
        """Serve from a background thread (submit() wakes it)."""

        def loop():
            while True:
                with self._lock:
                    if self._stop:
                        break
                if not self.step():
                    with self._work:
                        if self._stop:
                            break
                        self._work.wait(timeout=0.05)

        with self._lock:
            if self._thread is not None:
                return
            self._stop = False
            self._thread = threading.Thread(target=loop, name="mx-serve",
                                            daemon=True)
            self._thread.start()

    def stop(self):
        with self._lock:
            thread = self._thread
            if thread is None:
                return
            self._stop = True
            self._work.notify_all()
        # join outside the lock (the loop's step() takes it); clear
        # _thread only after the join so a racing start() no-ops
        thread.join()
        with self._lock:
            if self._thread is thread:
                self._thread = None

    # -- batch execution -----------------------------------------------------
    def _tables(self, reqs):
        w = self.model.max_blocks
        bt = np.zeros((len(reqs), w), np.int32)
        for i, r in enumerate(reqs):
            bt[i, :len(r.blocks)] = r.blocks
        return bt

    def _draft_tables(self, reqs):
        w = self.draft_model.max_blocks
        bt = np.zeros((len(reqs), w), np.int32)
        for i, r in enumerate(reqs):
            bt[i, :len(r.draft_blocks)] = r.draft_blocks
        return bt

    @staticmethod
    def _samp_arrays(reqs):
        """Per-request sampler parameter vectors (host arrays)."""
        return (np.asarray([r.temperature for r in reqs], np.float32),
                np.asarray([r.top_k for r in reqs], np.int32),
                np.asarray([r.top_p for r in reqs], np.float32),
                np.asarray([r.seed for r in reqs], np.uint32))

    @staticmethod
    def _stream_slice(req, a, b):
        """Tokens at global positions [a, b) of a request's emitted
        stream (prompt then generated: eviction's recompute fold moves
        tokens between context and generated but never their global
        positions)."""
        lp = len(req.prompt)
        return [int(req.prompt[p]) if p < lp else int(req.generated[p - lp])
                for p in range(a, b)]

    def _run_decode(self, reqs, spec_k=None):
        """Dispatch one decode batch: rows the plan gave a draft budget
        run the draft + verify turn, the rest (speculation off, or a
        request's final token) the plain sampled step."""
        spec_rows = [r for r in reqs if spec_k and spec_k.get(r.rid, 0) > 0]
        if spec_rows:
            self._run_spec_turn(spec_rows, [spec_k[r.rid] for r in spec_rows])
        plain = [r for r in reqs if r not in spec_rows]
        if plain:
            self._run_plain_decode(plain)

    def _run_plain_decode(self, reqs):
        t0 = time.monotonic()
        B = len(reqs)
        tokens = np.asarray([[r.generated[-1]] for r in reqs], np.int32)
        start = np.asarray(
            [len(r.prompt) + len(r.generated) - 1 for r in reqs], np.int32)
        temp, tk, tp, sd = self._samp_arrays(reqs)
        # static policy = fixed-shape serving: decode dispatches at the
        # full batch width even as the batch drains
        min_b = self.cfg.max_batch if self.cfg.policy == "static" else None
        # token-vector-only contract: the step's one D2H is the sampled
        # token vector at bucket width (4 bytes a lane) — the ledger
        # fails the turn if anything more (e.g. logits) crosses
        Bv = bucket_for(max(B, min_b or 1), self.model.batch_buckets)
        with _tel.span("serve.decode"), \
                _cv.d2h_region("serve.decode_step", budget_bytes=4 * Bv):
            nxt = self.model.step(
                self.params, self.pool.k, self.pool.v, tokens, start,
                np.ones((B,), np.int32), self._tables(reqs),
                np.ones((B,), bool), min_batch_bucket=min_b,
                temperature=temp, top_k=tk, top_p=tp, seed=sd)
        now = time.monotonic()
        with self._lock:
            if _tel.ENABLED:
                _tel.histogram("serving.decode_batch_size").observe(B)
                _tel.histogram("serving.decode_step_s").observe(now - t0)
            for r, t in zip(reqs, nxt):
                if r.state != DECODE:   # cancelled while stepping
                    continue
                self._emit(r, int(t), now)

    def _draft_ingest(self, toks, lo, dtable):
        """Write the draft pool's K/V for ``toks`` at stream positions
        from ``lo`` on (one request, its draft table ``dtable``) through
        the draft's paged step, ``prefill_chunk`` tokens at a time."""
        toks = np.asarray(toks, np.int32)
        for c0 in range(0, len(toks), self.cfg.prefill_chunk):
            c = toks[c0:c0 + self.cfg.prefill_chunk]
            self.draft_model.step(
                self.draft_params, self.draft_pool.k, self.draft_pool.v,
                c[None], np.asarray([lo + c0], np.int32),
                np.asarray([len(c)], np.int32), dtable, np.ones((1,), bool))

    def _run_spec_turn(self, reqs, ks):
        """One speculative decode turn: the draft model proposes up to
        ``ks[i]`` tokens a request (chained on the device), the target
        verifies every position in one ragged step with accept/reject
        and resampling, and the host folds the accepted prefix plus one
        corrected or bonus token into each stream. The turn's only
        device->host pulls are ints: the accepted counts, the final
        tokens and the draft tokens."""
        prof_on = _prof.ENABLED
        ac0 = _prof.attribution_count() if prof_on else 0
        t0 = time.monotonic()
        B = len(reqs)
        # a fixed chain length: ks masks each row's unused tail
        K = self.cfg.spec_k
        P = np.asarray([len(r.prompt) + len(r.generated) for r in reqs],
                       np.int32)              # next-token position per row
        temp, tk, tp, sd = self._samp_arrays(reqs)
        dtables = self._draft_tables(reqs)
        # draft catch-up beyond the steady-state ingest (a request that
        # ran plain decode while speculation was off can lag arbitrarily)
        for i, r in enumerate(reqs):
            while P[i] - 1 - r.draft_pos > 1:
                cl = min(self.cfg.prefill_chunk, int(P[i]) - 1 - r.draft_pos)
                self._draft_ingest(
                    self._stream_slice(r, r.draft_pos, r.draft_pos + cl),
                    r.draft_pos, dtables[i:i + 1])
                r.draft_pos += cl
        # draft phase: ingest the 1-2 missing stream tokens + K chained
        # proposals
        dstart = np.asarray([r.draft_pos for r in reqs], np.int32)
        lens = P - dstart
        ing = np.zeros((B, int(lens.max())), np.int32)
        for i, r in enumerate(reqs):
            ing[i, :lens[i]] = self._stream_slice(r, r.draft_pos, int(P[i]))
        karr = np.asarray(ks, np.int32)
        # the spec turn IS the decode dispatch when speculation is on —
        # it gets its own span (serve.spec_turn)
        Bv = bucket_for(B, self.model.batch_buckets)
        with _tel.span("serve.spec_turn"), \
                _cv.d2h_region("serve.spec_turn",
                               budget_bytes=4 * Bv * (K + 3)):
            td0 = time.monotonic() if prof_on else 0.0
            dmat, qmat = self.draft_model.draft_turn(
                self.draft_params, self.draft_pool.k, self.draft_pool.v,
                ing, dstart, lens, dtables, np.ones((B,), bool), karr, K,
                temperature=temp, top_k=tk, top_p=tp, seed=sd)
            if prof_on:
                self._sync()
                td1 = time.monotonic()
            # verify: one ragged target step over [prev, d_0..d_k]
            prev = np.asarray([[r.generated[-1]] for r in reqs], np.int32)
            n_dev, fin_dev = self.model.verify(
                self.params, self.pool.k, self.pool.v, prev, dmat, qmat,
                P - 1, 1 + karr, self._tables(reqs), np.ones((B,), bool),
                temperature=temp, top_k=tk, top_p=tp, seed=sd)
            if prof_on:
                tv1 = time.monotonic()
                self._sync()
                tv2 = time.monotonic()
            n = n_dev.cpu().numpy()
            fin = fin_dev.cpu().numpy()
            drafts = dmat.cpu().numpy()
            _cv.note_d2h(
                n.nbytes + fin.nbytes + drafts.nbytes,
                "mxnet_tpu_torch/serving/engine.py::Engine._run_spec_turn")
        now = time.monotonic()

        drafted = accepted = emitted = 0
        with self._lock:
            for i, r in enumerate(reqs):
                if r.state != DECODE:         # cancelled while stepping
                    continue
                k_i = int(ks[i])
                j = min(int(n[i]), k_i)
                # draft KV is valid through the accepted, fed prefix
                # (the last proposal is never fed back): positions
                # < P + min(j, k_i - 1)
                r.draft_pos = int(P[i]) + min(j, k_i - 1)
                r.spec_drafted += k_i
                r.spec_accepted += j
                drafted += k_i
                accepted += j
                for t in list(drafts[i, :j]) + [int(fin[i])]:
                    self._emit(r, int(t), now)
                    emitted += 1
                    if r.state != DECODE:     # eos / max_new hit
                        break
                if r.state == DECODE:
                    self.sched.trim_blocks(r)
            self._stats["spec_turns"] += 1
            self._stats["spec_tokens_drafted"] += drafted
            self._stats["spec_tokens_accepted"] += accepted
            self._spec_window.append((now, drafted, accepted))
            self._spec_window = [
                x for x in self._spec_window
                if now - x[0] <= self.SPEC_WINDOW_SECS]
            if _tel.ENABLED:
                _tel.counter("serving.spec_turns").inc()
                _tel.counter("serving.spec_tokens_drafted").inc(drafted)
                _tel.counter("serving.spec_tokens_accepted").inc(accepted)
                h = _tel.histogram("serving.spec_accepted_tokens")
                for i, r in enumerate(reqs):
                    h.observe(min(int(n[i]), int(ks[i])))
                _tel.histogram("serving.decode_batch_size").observe(B)
                _tel.histogram("serving.decode_step_s").observe(now - t0)
        if prof_on and _prof.attribution_count() == ac0:
            Bb = bucket_for(B, self.model.batch_buckets)
            Cin = int(lens.max())
            _prof.note_step(
                "serve.spec_draft",
                {"host": td0 - t0, "device": td1 - td0},
                key=self.draft_model._prof_keys.get(
                    ("draft_turn", Bb, Cin if Cin == 1 else
                     bucket_for(Cin, self.draft_model.chunk_buckets), K)),
                tokens=int(np.sum(lens)) + B * (K - 1))
            _prof.note_step(
                "serve.spec_verify",
                {"dispatch": tv1 - td1, "device": tv2 - tv1,
                 "d2h": now - tv2},
                key=self.model._prof_keys.get(("verify", Bb, K)),
                tokens=emitted,
                d2h_bytes=int(n.nbytes + fin.nbytes + drafts.nbytes))

    def _sync(self):
        """Wait for the engine's card (mxprof's device clock)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _run_prefill(self, chunks):
        # context-parallel long prompts take their own path, off the
        # bucketed batch (model.cp_prefill_kv)
        batched = []
        for req, cs, clen in chunks:
            if (self.cfg.mesh is not None and cs == 0
                    and req.ctx_len >= self.cfg.cp_min_tokens
                    and self._cp_eligible(req)):
                self._run_cp_prefill(req)
            else:
                batched.append((req, cs, clen))
        if not batched:
            return
        B = len(batched)
        C = max(clen for _, _, clen in batched)
        reqs = [r for r, _, _ in batched]
        tokens = np.zeros((B, C), np.int32)
        start = np.zeros((B,), np.int32)
        chunk_len = np.zeros((B,), np.int32)
        for i, (req, cs, clen) in enumerate(batched):
            tokens[i, :clen] = req.context[cs:cs + clen]
            start[i] = cs
            chunk_len[i] = clen
        temp, tk, tp, sd = self._samp_arrays(reqs)
        with _tel.span("serve.prefill"):
            nxt = self.model.step(
                self.params, self.pool.k, self.pool.v, tokens, start,
                chunk_len, self._tables(reqs), np.ones((B,), bool),
                temperature=temp, top_k=tk, top_p=tp, seed=sd)
        if self.draft_model is not None:
            # mirror the chunk into the draft pool (same tokens and
            # positions, the draft's own tables) so draft KV stays
            # position-consistent with the target from admission on; the
            # mirror runs while speculation is toggled off too
            with _tel.span("serve.draft_prefill"):
                self.draft_model.step(
                    self.draft_params, self.draft_pool.k,
                    self.draft_pool.v, tokens, start, chunk_len,
                    self._draft_tables(reqs), np.ones((B,), bool))
        now = time.monotonic()
        with self._lock:
            for i, (req, cs, clen) in enumerate(batched):
                if req.state != PREFILL:   # cancelled while stepping
                    continue
                self.sched.note_prefilled(req, clen)
                req.draft_pos = cs + clen
                if req.state == DECODE:
                    if req.prefill_done_t is None:  # first time only —
                        req.prefill_done_t = now    # an eviction
                    # re-prefill must not swallow the first decode phase
                    # from the journaled lifecycle spans; the final
                    # prefill chunk's logits give the first new token
                    self._emit(req, int(nxt[i]), now)

    def _cp_eligible(self, req):
        n = self.cfg.mesh.shape[self.cfg.cp_seq_axis]
        chunk = self.cfg.cp_chunk or req.ctx_len
        return chunk % n == 0 and req.ctx_len % chunk == 0

    def _run_cp_prefill(self, req):
        """Whole-prompt context-parallel prefill over the mesh, then
        scatter the dense K/V into this request's pool blocks."""
        cfg = self.model_cfg
        with _tel.span("serve.cp_prefill"):
            k, v, x_last = cp_prefill_kv(
                self.params, cfg, req.context, self.cfg.mesh,
                kind=self.cfg.cp_kind, chunk=self.cfg.cp_chunk,
                seq_axis=self.cfg.cp_seq_axis)
        bs = self.cfg.block_size
        T = req.ctx_len
        nb = blocks_for_tokens(T, bs)
        pad = nb * bs - T
        if pad:
            zpad = k.new_zeros((cfg.num_layers, pad) + tuple(k.shape[2:]))
            k = torch.cat([k, zpad], dim=1)
            v = torch.cat([v, zpad], dim=1)
        k = k.reshape(cfg.num_layers, nb, bs, cfg.num_heads, cfg.head_dim)
        v = v.reshape(cfg.num_layers, nb, bs, cfg.num_heads, cfg.head_dim)
        blocks = torch.as_tensor(np.asarray(req.blocks[:nb], np.int64),
                                 device=self.device)
        # the pool write, the logits and the draw run outside _lock
        # (every pool-writing path serializes on _step_lock)
        with torch.no_grad():
            self.pool.k[:, blocks] = k.to(self.pool.k.dtype)
            self.pool.v[:, blocks] = v.to(self.pool.v.dtype)
            logits = x_last @ self._unembed
            # the first token draws from the (seed, position) stream the
            # paged path's sampler uses, on the device
            first, _ = _samp.sample_tokens(
                logits[None], *self._samp_arrays([req]),
                np.asarray([T]), _samp.SALT_TARGET)
        if self.draft_model is not None:
            # the draft pool still needs this context: the draft ingests
            # it through its own paged prefill (it is small: chunked
            # single-row steps, not a cp pass)
            self._draft_ingest(req.context[:T], 0,
                               self._draft_tables([req]))
        first = int(first[0])
        now = time.monotonic()
        with self._lock:
            self._stats["cp_prefills"] += 1
            if req.state != PREFILL:
                return
            self.sched.note_prefilled(req, T - req.prefilled)
            req.draft_pos = T
            if req.state == DECODE and req.prefill_done_t is None:
                req.prefill_done_t = now
            self._emit(req, first, now)

    # -- per-token bookkeeping (under self._lock) ----------------------------
    def _emit(self, req, token, now):
        req.generated.append(token)
        stream = req.stream
        if req.first_token_t is None:
            req.first_token_t = now
            self._ttfts.append(now - req.submit_t)
            if _tel.ENABLED:
                _tel.histogram("serving.ttft_s").observe(now - req.submit_t)
            if now <= self._sync_mark_until:
                # TTFT landed inside a weight-sync window: the
                # degradation signal a sync is judged by
                self._sync_ttfts.append(now - req.submit_t)
                if _tel.ENABLED:
                    _tel.histogram("serving.ttft_sync_s").observe(
                        now - req.submit_t)
        if req.last_token_t is not None:
            self._token_lats.append(now - req.last_token_t)
            if _tel.ENABLED:
                _tel.histogram("serving.token_latency_s").observe(
                    now - req.last_token_t)
        req.last_token_t = now
        self._stats["tokens_emitted"] += 1
        self._rate_window.append((now, self._stats["tokens_emitted"]))
        if stream is not None:
            stream._emit(token)
        # len(generated) is the client-visible stream length — eviction
        # folds tokens into the recompute context but never drops them
        done = len(req.generated) >= req.max_new_tokens
        if req.eos_id is not None and token == req.eos_id:
            done = True
        if done:
            req.finish_t = now
            self.sched.finish(req)
            self._trace_request(req, "complete", now)
            self._mirror_events()
            if stream is not None:
                stream._end("finished")

    def _trace_request(self, req, status, now):
        """Journal the request's lifecycle as spans sharing its trace id
        (submit already landed at intake), re-anchored from the
        monotonic stamps to the submit wall clock."""
        if req.trace is None:
            return

        def w(mono):  # monotonic stamp -> journal wall clock
            return req.wall0 + (mono - req.submit_t)

        _tel.event("serve.request", t=req.wall0, dur=now - req.submit_t,
                   trace=req.trace, rid=req.rid, status=status,
                   tokens=len(req.generated), evictions=req.evictions)
        if req.admit_t is not None:
            _tel.event("serve.request.prefill", t=w(req.admit_t),
                       dur=(req.prefill_done_t or now) - req.admit_t,
                       trace=req.trace, rid=req.rid)
        if req.prefill_done_t is not None:
            _tel.event("serve.request.decode", t=w(req.prefill_done_t),
                       dur=now - req.prefill_done_t,
                       trace=req.trace, rid=req.rid)
        _tel.event("serve.request.%s" % status, t=w(now),
                   trace=req.trace, rid=req.rid)

    def _mirror_events(self):
        """Fold scheduler event counts into stats + mxtel counters,
        close out cancelled streams, and latch the drained state."""
        mapping = {"admit": "admitted", "complete": "completed",
                   "evict": "evicted", "cancel": "cancelled"}
        for ev, stat in mapping.items():
            n = self.sched.counts.get(ev, 0)
            d = n - self._last_counts.get(ev, 0)
            if d:
                self._stats[stat] += d
                self._last_counts[ev] = n
                if _tel.ENABLED:
                    _tel.counter("serving.requests_%s" % stat).inc(d)
        for rid, req in list(self._by_rid.items()):
            if req.state == CANCELLED:
                if req.stream is not None and req.stream.status == "running":
                    req.stream._end("cancelled")
                self._trace_request(req, "cancel", time.monotonic())
                del self._by_rid[rid]
            elif req.state == FINISHED:
                del self._by_rid[rid]
        self._check_drained_locked()

    def _update_gauges(self):
        """tokens/s over a sliding 2 s window of emissions, and the
        serving gauges."""
        util = self.pool.utilization()
        now = time.monotonic()
        win = [x for x in self._rate_window if now - x[0] <= 2.0]
        self._rate_window = win
        rate = 0.0
        if len(win) >= 2 and win[-1][0] > win[0][0]:
            rate = (win[-1][1] - win[0][1]) / (win[-1][0] - win[0][0])
        self._last_rate = rate
        if _tel.ENABLED:
            _tel.gauge("serving.kv_pool_utilization").set(util)
            _tel.gauge("serving.kv_pool_hwm_blocks").set(
                self.pool.high_water_mark())
            _tel.gauge("serving.tokens_per_s").set(rate)
            _tel.gauge("serving.queue_depth").set(len(self.sched.queue))
            if self._stats["spec_tokens_drafted"]:
                _tel.gauge("serving.spec_accept_rate").set(
                    self._stats["spec_tokens_accepted"]
                    / float(self._stats["spec_tokens_drafted"]))

    def note_idle(self):
        """Mark the engine idle: the tokens/s gauge drops to zero
        instead of freezing at its last in-flight value."""
        with self._lock:
            self._rate_window = []
            self._last_rate = 0.0
            if _tel.ENABLED:
                _tel.gauge("serving.tokens_per_s").set(0.0)
                _tel.gauge("serving.queue_depth").set(len(self.sched.queue))

    # -- reporting -----------------------------------------------------------
    def latency_samples(self):
        """Copies of the raw TTFT / per-token latency sample lists."""
        with self._lock:
            return list(self._ttfts), list(self._token_lats)

    def stats(self):
        """Plain-number mirror of the serving metrics (works with
        telemetry off); the JAX package's keys plus ``cp_prefills``."""
        def pct(xs, q):
            if not xs:
                return None
            return float(np.percentile(np.asarray(xs), q))

        with self._lock:
            out = dict(self._stats)
            drafted = self._stats["spec_tokens_drafted"]
            now = time.monotonic()
            win = [x for x in self._spec_window
                   if now - x[0] <= self.SPEC_WINDOW_SECS]
            wd = sum(x[1] for x in win)
            wa = sum(x[2] for x in win)
            out.update({
                "spec_enabled": self.sched.spec_active(),
                "spec_accept_rate": (
                    self._stats["spec_tokens_accepted"] / float(drafted)
                    if drafted else None),
                # the actionable signal: accept rate over the last
                # SPEC_WINDOW_SECS of turns (None when no recent turns)
                "spec_window_drafted": wd,
                "spec_window_accepted": wa,
                "spec_accept_rate_window": (wa / float(wd) if wd
                                            else None),
                "kv_pool_utilization": self.pool.utilization(),
                "kv_pool_hwm_blocks": self.pool.high_water_mark(),
                "queue_depth": len(self.sched.queue),
                "active": len(self.sched.active),
                "draining": self._draining,
                "drained": self._drained,
                "tokens_per_s_window": self._last_rate,
                "weight_version": self._weight_version,
                "weight_ring": len(self._weight_ring),
                "ttft_p50_s": pct(self._ttfts, 50),
                "ttft_p99_s": pct(self._ttfts, 99),
                "ttft_sync_p99_s": pct(self._sync_ttfts, 99),
                "token_latency_p50_s": pct(self._token_lats, 50),
                "token_latency_p99_s": pct(self._token_lats, 99),
            })
        return out

    def introspect(self, event_tail=50):
        """Live request table + pool state + scheduler event tail — the
        /servingz endpoint's payload (telemetry/server.py): every queued
        and active request with its state, progress, and trace id."""
        now = time.monotonic()
        with self._lock:
            reqs = []
            for req in list(self.sched.active) + list(self.sched.queue):
                reqs.append({
                    "rid": req.rid, "state": req.state,
                    "trace": req.trace,
                    "prompt_len": int(req.prompt.shape[0]),
                    "ctx_len": req.ctx_len,
                    "prefilled": req.prefilled,
                    "generated": len(req.generated),
                    "max_new_tokens": req.max_new_tokens,
                    "blocks": len(req.blocks),
                    "evictions": req.evictions,
                    "age_s": (now - req.submit_t
                              if req.submit_t is not None else None),
                })
            out = {
                "policy": self.cfg.policy,
                "draining": self._draining,
                "drained": self._drained,
                "spec": {
                    "configured": self.draft_model is not None,
                    "enabled": self.sched.spec_active(),
                    "spec_k": self.sched.spec_k,
                    "draft_pool_utilization": (
                        self.draft_pool.utilization()
                        if self.draft_pool is not None else None),
                },
                "wsync": {
                    "version": self._weight_version,
                    "ring": len(self._weight_ring),
                    "syncing": self._wsync_sub is not None,
                },
                "requests": reqs,
                "pool": {
                    "capacity_blocks": self.pool.capacity,
                    "free_blocks": self.pool.num_free,
                    "utilization": self.pool.utilization(),
                    "hwm_blocks": self.pool.high_water_mark(),
                    "block_size": self.cfg.block_size,
                },
                # the event log is a bounded ring — this is the TAIL;
                # events_total keeps the true count
                "events": [list(e) for e in
                           list(self.sched.events)[-event_tail:]],
                "events_total": self.sched.events_total,
            }
        # stats() sorts the latency sample lists: in its own lock window
        out["stats"] = self.stats()
        return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _to_device(tree, device):
    return _tree_map(lambda t: t.to(device), tree)

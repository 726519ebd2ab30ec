"""Continuous-batching scheduler: admit/evict per decode step.

Host-only copy of ``mxnet_tpu/serving/scheduler.py`` with its imports
pointed at the port (tests/test_torch_imports.py pins the two bodies
equal below the imports).

The scheduling model (PAPERS.md "Ragged Paged Attention"; the policy is
the now-standard continuous batching shape):

- every engine step runs at most one **decode batch** (one token for
  every running request) and one **prefill batch** (the next chunk of
  each admitted-but-not-yet-prefilled prompt, budget permitting) —
  prefill is batched *separately* so a long prompt never stalls the
  decoders, and a per-step **token budget** caps prefill work;
- **admission** is per step: whenever a slot (``max_batch``) and enough
  KV blocks for the prompt exist, the oldest queued request joins —
  requests never wait for a "batch to fill";
- **eviction** is the OOM pressure valve: when a *running* request
  crosses a block boundary and the pool can't hand out one more block,
  the youngest running request is preempted — its blocks are freed and
  it re-queues at the front with its already-streamed tokens folded
  into a recompute context (so nothing the client saw is lost);
- the **static** policy is the A/B baseline (bench_serve.py): admission
  only happens when the active set is fully drained, i.e. classic
  static batching — every batch runs to the completion of its slowest
  member while newly arrived requests queue.

All decisions are deterministic functions of (arrival order, config,
pool state): the ``events`` log of two runs over the same trace is
identical (pinned by tests/unittest/test_serving.py).

Block-allocation invariant: admission allocates every block the
*context* (prompt + any recompute tokens) needs, so prefill itself
never allocates; only admission and decode boundary-crossings touch the
free list. A request whose total footprint (context + max_new_tokens)
can never fit the pool or the model's ``max_seq_len`` is rejected at
submit time, not deadlocked.
"""
from __future__ import annotations

import collections
import itertools

import numpy as np

from ..base import env_int as _env_int
from .kv_cache import blocks_for_tokens

__all__ = ["Request", "Scheduler", "StepPlan",
           "QUEUED", "PREFILL", "DECODE", "FINISHED", "CANCELLED"]

QUEUED, PREFILL, DECODE, FINISHED, CANCELLED = (
    "queued", "prefill", "decode", "finished", "cancelled")

_rid = itertools.count()


class Request:
    """One generation request tracked by the scheduler."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_id", "state",
                 "blocks", "context", "prefilled", "generated",
                 "submit_t", "first_token_t", "last_token_t", "finish_t",
                 "evictions", "cancel_requested", "stream",
                 # fused-sampling params (sampling.py): temperature 0 =
                 # greedy; draws keyed (seed, position, salt)
                 "temperature", "top_k", "top_p", "seed",
                 # speculative decoding (engine + scheduler lockstep):
                 # draft-pool block table, first position the draft
                 # pool lacks valid KV for, cumulative drafted/accepted
                 "draft_blocks", "draft_pos", "spec_drafted",
                 "spec_accepted",
                 # request-scoped tracing (engine fills these in when
                 # telemetry is on; scheduling never reads them):
                 # trace id, submit wall-clock anchor, first-admission
                 # and prefill-complete monotonic stamps
                 "trace", "wall0", "admit_t", "prefill_done_t")

    def __init__(self, prompt, max_new_tokens, eos_id=None, stream=None,
                 temperature=0.0, top_k=0, top_p=1.0, seed=0):
        self.rid = next(_rid)
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.state = QUEUED
        self.blocks = []
        # context = tokens whose KV must be in the pool before decode:
        # the prompt, plus already-generated tokens after an eviction
        # (recompute-style preemption keeps the client's stream intact)
        self.context = self.prompt
        self.prefilled = 0
        self.generated = []
        self.submit_t = None
        self.first_token_t = None
        self.last_token_t = None
        self.finish_t = None
        self.evictions = 0
        self.cancel_requested = False
        self.stream = stream
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.draft_blocks = []
        self.draft_pos = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.trace = None
        self.wall0 = None
        self.admit_t = None
        self.prefill_done_t = None

    @property
    def ctx_len(self):
        return int(self.context.shape[0])

    def total_len(self):
        """Worst-case sequence length this request can reach."""
        return int(self.prompt.shape[0]) + self.max_new_tokens


class StepPlan:
    """What one engine step should run."""

    __slots__ = ("decode", "prefill", "spec_k")

    def __init__(self, decode, prefill, spec_k=None):
        self.decode = decode        # [Request] — one token each
        self.prefill = prefill      # [(Request, chunk_start, chunk_len)]
        # rid -> draft tokens this turn (0 = plain decode row); empty
        # when speculation is off
        self.spec_k = spec_k or {}

    def __bool__(self):
        return bool(self.decode or self.prefill)


class Scheduler:
    """Admission / eviction / step planning over a PagedKVPool.

    Parameters
    ----------
    pool : PagedKVPool
    max_batch : int
        Concurrent active (prefill+decode) requests.
    prefill_chunk : int
        Max prompt tokens prefilled per request per step.
    token_budget : int
        Per-step cap on total tokens entering the model: the decode
        batch (1/request) plus prefill chunks must fit under it.
    policy : "continuous" | "static"
    """

    def __init__(self, pool, max_batch=8, prefill_chunk=128,
                 token_budget=None, policy="continuous", max_active=None,
                 draft_pool=None, spec_k=0, events_max=None):
        if policy not in ("continuous", "static"):
            raise ValueError("unknown policy %r" % (policy,))
        self.pool = pool
        self.max_batch = int(max_batch)
        self.prefill_chunk = int(prefill_chunk)
        self.token_budget = int(token_budget if token_budget is not None
                                else self.max_batch + self.prefill_chunk)
        self.policy = policy
        # speculative decoding: the draft model's paged pool (same
        # block geometry, kv_cache.PagedKVPool.mirror) whose per-request
        # tables stay in LOCKSTEP with the target tables — every alloc/
        # free below pairs the two, so len(draft_blocks) == len(blocks)
        # always. spec_k > 0 makes each decode slot cost 1 + spec_k
        # budget tokens (its verify chunk); the engine toggles it at
        # runtime via set_spec_k (the mxctl spec_off actuator).
        self.draft_pool = draft_pool
        self.spec_k = int(spec_k)
        # admission depth: more requests than one decode batch may be
        # active so freshly-prefilled requests backfill drained decode
        # slots immediately (decode occupancy is the throughput lever);
        # static keeps depth == batch (one batch at a time, by design)
        if policy == "static":
            self.max_active = self.max_batch
        else:
            self.max_active = int(max_active if max_active is not None
                                  else 2 * self.max_batch)
        self.queue = collections.deque()
        self.active = []          # admission-ordered PREFILL/DECODE reqs
        # deterministic audit log, BOUNDED: long-lived serving processes
        # emit events forever, so the log is a ring holding the tail
        # (introspect()/servingz render the tail anyway); events_total
        # keeps the true count for accounting
        self.events = collections.deque(
            maxlen=int(events_max if events_max is not None
                       else _env_int("MXNET_SERVE_EVENTS_MAX", 4096)))
        self.events_total = 0
        self.counts = collections.Counter()

    def spec_active(self):
        return self.draft_pool is not None and self.spec_k > 0

    def set_spec_k(self, k):
        """Runtime speculation toggle (0 disables): takes effect at the
        next plan()."""
        self.spec_k = int(k)

    def _event(self, ev, rid):
        self.events.append((ev, rid))
        self.events_total += 1
        self.counts[ev] += 1

    # -- paired target/draft block bookkeeping -------------------------------
    def _alloc_pair(self, req, n):
        """Allocate n blocks in the target pool (and the draft pool in
        lockstep when speculation is configured). True on success; on
        any failure nothing is held."""
        blocks = self.pool.alloc(n)
        if blocks is None:
            return False
        if self.draft_pool is not None:
            dblocks = self.draft_pool.alloc(n)
            if dblocks is None:  # lockstep makes this unreachable, but
                self.pool.free(blocks)  # never leak on the safe side
                return False
            req.draft_blocks.extend(dblocks)
        req.blocks.extend(blocks)
        return True

    def _free_all(self, req):
        if req.blocks:
            self.pool.free(req.blocks)
            req.blocks = []
        if req.draft_blocks:
            self.draft_pool.free(req.draft_blocks)
            req.draft_blocks = []

    # -- intake --------------------------------------------------------------
    def max_request_tokens(self):
        """Largest total sequence the pool geometry can ever host."""
        return self.pool.capacity * self.pool.block_size

    def submit(self, req):
        """Queue a request (depth limits are the engine's concern)."""
        self.queue.append(req)

    def cancel(self, req):
        req.cancel_requested = True

    # -- internal helpers ----------------------------------------------------
    def _finish(self, req, state, event):
        self._free_all(req)
        req.state = state
        if req in self.active:
            self.active.remove(req)
        self._event(event, req.rid)

    def finish(self, req):
        """Mark a running request complete (engine calls after the stop
        condition trips)."""
        self._finish(req, FINISHED, "complete")

    def note_drained(self):
        """Record the engine's drain completion in the deterministic
        event log (rid -1: a lifecycle event, not a request)."""
        self._event("drained", -1)

    def _sweep_cancelled(self):
        for req in [r for r in self.active if r.cancel_requested]:
            self._finish(req, CANCELLED, "cancel")
        kept = [r for r in self.queue if not r.cancel_requested]
        for req in self.queue:
            if req.cancel_requested:
                req.state = CANCELLED
                self._event("cancel", req.rid)
        if len(kept) != len(self.queue):
            self.queue = collections.deque(kept)

    def _admit_one(self, req):
        need = blocks_for_tokens(req.ctx_len, self.pool.block_size)
        if self.policy == "static":
            # static batches are sized once: reserve the whole worst
            # case so the batch can always run to completion
            need = blocks_for_tokens(req.total_len(), self.pool.block_size)
        if not self._alloc_pair(req, need):
            return False
        req.state = PREFILL
        req.prefilled = 0
        req.draft_pos = 0
        self.active.append(req)
        self._event("admit", req.rid)
        return True

    def _admit(self):
        if self.policy == "static" and self.active:
            return  # classic static batching: drain before refill
        while self.queue and len(self.active) < self.max_active:
            if not self._admit_one(self.queue[0]):
                break  # OOM backpressure: wait for frees
            self.queue.popleft()

    def _evict_youngest(self):
        """Preempt the newest active request; returns it (or None)."""
        if not self.active:
            return None
        victim = self.active.pop()
        self._free_all(victim)
        # recompute context: everything already streamed is folded in
        victim.context = np.concatenate(
            [victim.context,
             np.asarray(victim.generated[
                 len(victim.context) - len(victim.prompt):], np.int32)])
        victim.prefilled = 0
        victim.draft_pos = 0
        victim.state = QUEUED
        victim.evictions += 1
        self.queue.appendleft(victim)
        self._event("evict", victim.rid)
        return victim

    def _ensure_decode_block(self, req, horizon=0):
        """Make sure the slots for this step's KV writes exist;
        evict-youngest until they do (the request itself may be the
        youngest, in which case it preempts itself and the step skips
        it). False = req can't decode this step.

        The slot written during decode is the *input* token's position:
        the engine feeds ``generated[-1]``, which lives at global
        position ``len(prompt) + len(generated) - 1`` (the recompute
        fold moves tokens between context and generated but never moves
        their global positions). A speculative turn writes ``horizon``
        more positions (the draft tokens its verify chunk carries), so
        the table must reach ``pos + horizon``; partial acceptance
        frees the unused tail via :meth:`trim_blocks`."""
        pos = len(req.prompt) + len(req.generated) - 1 + int(horizon)
        need = pos // self.pool.block_size + 1
        while need > len(req.blocks):
            if self._alloc_pair(req, need - len(req.blocks)):
                return True
            victim = self._evict_youngest()
            if victim is None or victim is req:
                return False
        return True

    def trim_blocks(self, req):
        """Roll both block tables back after a speculative turn: free
        blocks past the next write position — the block-granular form
        of "roll back to the first rejection" (rejected draft
        positions' KV is dead weight; the masks already exclude it).
        Static policy reserved the worst case at admission and keeps
        it."""
        if self.policy == "static":
            return
        pos = len(req.prompt) + len(req.generated) - 1
        keep = pos // self.pool.block_size + 1
        if keep < len(req.blocks):
            self.pool.free(req.blocks[keep:])
            del req.blocks[keep:]
            if self.draft_pool is not None and req.draft_blocks:
                self.draft_pool.free(req.draft_blocks[keep:])
                del req.draft_blocks[keep:]

    # -- planning ------------------------------------------------------------
    def plan(self):
        """One step's work. Mutates state (admissions, evictions,
        allocations) and returns a StepPlan."""
        self._sweep_cancelled()
        self._admit()

        decode = []
        spec_k = {}
        spec = self.spec_active()
        cost_used = 0
        # iterate a snapshot: _ensure_decode_block may evict the
        # youngest active request mid-loop. Eviction always moves the
        # victim's state to QUEUED, so the state check below filters
        # both never-decoding and just-evicted requests; victims are
        # the newest member of `active`, so an already-collected
        # (older) decode entry can never be evicted by a later one.
        for req in list(self.active):
            if req.state != DECODE:
                continue
            if len(decode) >= self.max_batch:
                break
            left = self.token_budget - cost_used
            if left < 1:
                break            # even a plain token no longer fits
            k = 0
            if spec:
                # a speculative slot costs its whole verify chunk
                # (1 + k tokens) against the budget; the final token
                # (remaining == 1) rides the plain fused-decode
                # program, and a tight budget SHRINKS a row's chain
                # rather than starving rows behind the first one that
                # doesn't fit at full spec_k
                remaining = req.max_new_tokens - len(req.generated)
                k = max(0, min(self.spec_k, remaining - 1, left - 1))
            if self._ensure_decode_block(req, horizon=k):
                decode.append(req)
                spec_k[req.rid] = k
                cost_used += 1 + k

        budget = self.token_budget - cost_used
        prefill = []
        for req in self.active:
            if req.state != PREFILL or budget <= 0:
                continue
            chunk = min(self.prefill_chunk, req.ctx_len - req.prefilled,
                        budget)
            if chunk <= 0:
                continue
            prefill.append((req, req.prefilled, chunk))
            budget -= chunk
        return StepPlan(decode, prefill, spec_k if spec else None)

    # -- engine feedback -----------------------------------------------------
    def note_prefilled(self, req, chunk_len):
        req.prefilled += chunk_len
        if req.prefilled >= req.ctx_len:
            req.state = DECODE

    def utilization(self):
        return self.pool.utilization()

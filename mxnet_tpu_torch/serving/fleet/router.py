"""Fleet router: the health-routed serving front-end.

One :class:`Router` owns the live replica set and places every request
(least-loaded with session affinity) over the ``fleet_*`` RPC arms a
:class:`~.replica.ReplicaServer` serves. The robustness core is the
per-request **redelivery journal**: the router remembers each request's
prompt, sampling params, and every token already streamed — so when a
replica dies mid-decode (health-scrape failure or a torn stream RPC),
the request is re-placed on a survivor with the streamed tokens folded
into a recompute prefill (``Engine.submit(prefix_tokens=...)``, the
engine's eviction-recompute fold lifted one tier up). The client's
stream never tears and, because sampling is keyed by (seed, global
position), the continuation is the uninterrupted stream's wherever
the numerics agree (exactly in f32 on the host; bf16 products on the
card round by batch shape and can part at a near-tie).

Discipline notes:

- **scrape-failure = dead** (the mxctl liveness rule): an evicted
  replica stays in the table with ``alive=0`` so the
  :class:`~...control.probes.FleetProbe` keeps emitting its sample and
  the ``restart_replica`` rule can respawn it; re-registration under
  the same name revives the entry. A graceful ``fleet_leave`` (the
  drain contract) removes the entry instead — retirement, not death.
- **admission backpressure**: past ``MXNET_FLEET_PENDING_MAX`` queued
  placements, ``submit`` raises :class:`~..engine.QueueFullError`
  carrying queue depth + a retry-after hint; a replica answering
  ``full`` is backed off for ITS hinted interval rather than hammered.
- **deterministic drive**: ``step()`` runs one pump iteration
  (scrape -> place -> poll) under one lock — tests and the mxrace
  schedule explorer drive it directly; ``start()`` wraps it in a
  thread for live processes.
"""
from __future__ import annotations

import collections
import itertools
import os
import queue as _queue
import socketserver
import threading
import time

import numpy as np

from ... import telemetry as _tel
from ...base import MXNetError
from ...elastic import protocol
from ...elastic.client import parse_addr
from ...resilience import faults as _faults
from ...resilience.retry import RetryPolicy
from ..engine import QueueFullError

__all__ = ["FleetClient", "FleetStream", "Router"]

_END = object()


def _env_float(name, default):
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class FleetClient:
    """One handle on a fleet peer (replica or router). Stateless
    between calls; transport errors retry under the kv.coord policy
    (``MXNET_KV_RETRIES``). ``direct=`` wires the client straight to an
    in-process peer's ``_dispatch`` — the bench/mxrace shape: no
    sockets, same protocol dicts, same status handling."""

    def __init__(self, addr=None, direct=None, timeout=30.0):
        if addr is None and direct is None:
            raise MXNetError("FleetClient needs addr or direct")
        self.direct = direct
        self.addr = (parse_addr(addr) if isinstance(addr, str)
                     else tuple(addr) if addr is not None else None)
        self.timeout = float(timeout)
        attempts = max(1, _env_int("MXNET_KV_RETRIES", 4))
        self._policy = RetryPolicy(max_attempts=attempts, base_delay=0.05,
                                   max_delay=1.0, jitter=0.25)

    def call(self, op, check=True, **fields):
        """One RPC. ``error`` status raises MXNetError (when
        ``check``); ``full`` and other statuses are protocol answers
        the caller dispatches on."""
        req = dict(fields)
        req["op"] = op
        if self.direct is not None:
            try:
                resp = self.direct._dispatch(dict(req))
            except MXNetError as e:
                resp = {"status": "error", "message": str(e)}
        else:
            def _rpc():
                _faults.point("kv.coord")
                return protocol.call(self.addr, req, timeout=self.timeout)

            _rpc.__name__ = "fleet %s" % op
            if not _tel.ENABLED:
                resp = self._policy.call(_rpc)
            else:
                with _tel.span("fleet.rpc.%s" % op):
                    req["_trace"] = _tel.wire_context()
                    resp = self._policy.call(_rpc)
        if check and resp.get("status") == "error":
            raise MXNetError("fleet peer rejected %s: %s"
                             % (op, resp.get("message", "(no message)")))
        return resp

    # -- one wrapper per protocol op (mxlint --proto reads these) ------------
    def submit(self, prompt, max_new, eos_id=None, temperature=0.0,
               top_k=0, top_p=1.0, seed=0, prefix=None):
        return self.call("fleet_submit", check=False, prompt=prompt,
                         max_new=max_new, eos_id=eos_id,
                         temperature=temperature, top_k=top_k, top_p=top_p,
                         seed=seed, prefix=prefix)

    def stream(self, rid, have=0, wait=0.0):
        return self.call("fleet_stream", rid=rid, have=have, wait=wait)

    def cancel_req(self, rid):
        return self.call("fleet_cancel", rid=rid)

    def drain(self, wait=False, drain_timeout=None):
        return self.call("fleet_drain", wait=wait,
                         drain_timeout=drain_timeout)

    def stats(self):
        return self.call("fleet_stats")

    def register(self, name, addr):
        return self.call("fleet_register", name=name, addr=addr)

    def leave(self, name):
        return self.call("fleet_leave", name=name)


class FleetStream:
    """Router-side token stream: the same surface as the engine's
    :class:`~..engine.StreamHandle`, fed by the router's poll pump —
    redelivery is invisible here (tokens arrive exactly once, in
    order)."""

    def __init__(self, router, rid):
        self._router = router
        self._q = _queue.Queue()
        self.rid = rid
        self.status = "running"

    def _emit(self, token):
        self._q.put(int(token))

    def _end(self, status):
        self.status = status
        self._q.put(_END)

    def cancel(self):
        self._router.cancel(self.rid)

    def tokens(self, timeout=None):
        while True:
            item = self._q.get(timeout=timeout)
            if item is _END:
                return
            yield item

    def result(self, timeout=None):
        return list(self.tokens(timeout=timeout))


class _Replica:
    """Router-side view of one replica."""

    __slots__ = ("name", "addr", "client", "alive", "accepting",
                 "inflight", "stats", "full_until", "last_scrape_t")

    def __init__(self, name, addr, client):
        self.name = name
        self.addr = addr
        self.client = client
        self.alive = True
        self.accepting = True
        self.inflight = set()        # router rids placed here
        self.stats = {}              # last scraped engine stats
        self.full_until = 0.0        # backoff deadline from a "full"
        self.last_scrape_t = 0.0


class _FleetRequest:
    """The redelivery journal entry: everything needed to re-place the
    request on a survivor with nothing the client saw lost."""

    __slots__ = ("rid", "prompt", "max_new", "eos_id", "temperature",
                 "top_k", "top_p", "seed", "session", "tokens", "stream",
                 "replica", "rrid", "placed_tokens", "trace",
                 "pending_trace", "redeliveries", "submit_t",
                 "first_token_t")

    def __init__(self, rid, prompt, max_new, eos_id, temperature, top_k,
                 top_p, seed, session):
        self.rid = rid
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.session = session
        self.tokens = []             # every token streamed so far
        self.stream = None
        self.replica = None          # current placement (name)
        self.rrid = None             # replica-side request id
        self.placed_tokens = 0       # len(tokens) at current placement
        self.trace = None            # request-lifetime trace id
        self.pending_trace = None    # redelivery-transaction trace id
        self.redeliveries = 0
        self.submit_t = None
        self.first_token_t = None


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        try:
            req = protocol.recv_msg(self.request, what="fleet request")
            if req is None:
                return
            wire = req.pop("_trace", None)
            try:
                with _tel.span("fleet.router.%s" % req.get("op"),
                               wire=wire):
                    resp = self.server.router._dispatch(req)
            except MXNetError as e:
                resp = {"status": "error", "message": str(e)}
            if _tel.ENABLED:
                resp.setdefault("_srv_t", time.time())
            protocol.send_msg(self.request, resp)
        except (OSError, protocol.ProtocolError):
            pass  # client went away mid-request — its retry policy heals


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class Router:
    """Health-routed front-end over the live replica set.

    Parameters
    ----------
    bind : (host, port) or None
        Registration RPC endpoint (``fleet_register``/``fleet_leave``;
        port 0 ephemeral). ``None`` builds a socketless router for
        tests/bench that register replicas in-process.
    inflight_cap : int, optional
        Per-replica concurrent placements (``MXNET_FLEET_INFLIGHT``,
        default 8).
    pending_max : int, optional
        Router-level admission cap on unplaced requests
        (``MXNET_FLEET_PENDING_MAX``, default 64); past it ``submit``
        raises :class:`QueueFullError` with a retry-after hint.
    health_interval : float, optional
        Seconds between ``fleet_stats`` scrapes per replica
        (``MXNET_FLEET_HEALTH_INTERVAL``, default 2.0).
    """

    def __init__(self, bind=("127.0.0.1", 0), inflight_cap=None,
                 pending_max=None, health_interval=None):
        self.inflight_cap = (inflight_cap if inflight_cap is not None
                             else _env_int("MXNET_FLEET_INFLIGHT", 8))
        self.pending_max = (pending_max if pending_max is not None
                            else _env_int("MXNET_FLEET_PENDING_MAX", 64))
        self.health_interval = (
            health_interval if health_interval is not None
            else _env_float("MXNET_FLEET_HEALTH_INTERVAL", 2.0))
        self._lock = threading.RLock()
        self._replicas = {}          # name -> _Replica
        self._requests = {}          # rid -> _FleetRequest
        self._pending = collections.deque()
        self._affinity = {}          # session -> replica name
        self._rids = itertools.count()
        self._ttfts = []
        self._rate_window = []       # (t, cumulative tokens)
        self._tokens_total = 0
        self._last_rate = 0.0
        self._counts = {"submitted": 0, "completed": 0, "cancelled": 0,
                        "rejected": 0, "redelivered": 0, "evictions": 0,
                        "registered": 0, "left": 0}
        self._thread = None
        self._stop = False
        self._server = None
        self._srv_thread = None
        if bind is not None:
            self._server = _Server(tuple(bind), _Handler)
            self._server.router = self

    # -- lifecycle -----------------------------------------------------------
    @property
    def addr(self):
        if self._server is None:
            raise MXNetError("router was built socketless (bind=None)")
        return self._server.server_address

    def serve(self):
        """Answer registration RPCs from a daemon thread; returns the
        bound (host, port)."""
        if self._server is None:
            raise MXNetError("router was built socketless (bind=None)")
        if self._srv_thread is None:
            self._srv_thread = threading.Thread(
                target=self._server.serve_forever, name="mx-fleet-router",
                daemon=True)
            self._srv_thread.start()
        return self.addr

    def start(self, interval=0.02):
        """Drive ``step()`` from a background thread (live mode)."""

        def loop():
            while True:
                with self._lock:
                    if self._stop:
                        return
                if not self.step():
                    time.sleep(interval)

        with self._lock:
            if self._thread is not None:
                return
            self._stop = False
            self._thread = threading.Thread(target=loop,
                                            name="mx-fleet-pump",
                                            daemon=True)
            self._thread.start()

    def stop(self):
        with self._lock:
            thread = self._thread
            self._stop = True
        if thread is not None:
            thread.join()
            with self._lock:
                if self._thread is thread:
                    self._thread = None

    def close(self):
        self.stop()
        if self._server is not None and self._srv_thread is not None:
            self._server.shutdown()
            self._server.server_close()
            self._srv_thread = None

    # -- membership ----------------------------------------------------------
    def register(self, name, addr=None, client=None):
        """Add (or revive) a replica. Called by the ``fleet_register``
        arm when a replica finishes warmup (the /readyz-gated
        registration), and directly by tests/bench with ``client=``."""
        if client is None:
            if addr is None:
                raise MXNetError("register needs addr or client")
            client = FleetClient(addr)
        with self._lock:
            self._replicas[str(name)] = _Replica(str(name), addr, client)
            self._counts["registered"] += 1
            if _tel.ENABLED:
                _tel.counter("fleet.replicas_registered_total").inc()
                _tel.event("fleet.replica.register", replica=str(name),
                           addr=str(addr))

    def register_local(self, name, replica):
        """Register an in-process ReplicaServer (no sockets)."""
        self.register(name, addr=None, client=FleetClient(direct=replica))

    def leave(self, name):
        """Graceful departure (the drain-retire contract): the entry is
        REMOVED — unlike a crash eviction, nothing keeps reporting it
        dead, so no liveness rule respawns it."""
        with self._lock:
            rep = self._replicas.pop(str(name), None)
            if rep is None:
                return False
            self._counts["left"] += 1
            if _tel.ENABLED:
                _tel.counter("fleet.replicas_left_total").inc()
                _tel.event("fleet.replica.leave", replica=str(name),
                           inflight=len(rep.inflight))
            # a clean leave should have drained first; anything still
            # in flight is redelivered like a death (belt & braces)
            self._redeliver_locked(rep, "leave")
            self._affinity = {s: n for s, n in self._affinity.items()
                              if n != str(name)}
            return True

    def _dispatch(self, req):
        op = req.get("op")
        if op == "fleet_register":
            self.register(req["name"], addr=req["addr"])
            with self._lock:
                n = len(self._replicas)
            return {"status": "ok", "replicas": n}
        if op == "fleet_leave":
            known = self.leave(req["name"])
            return {"status": "ok", "known": bool(known)}
        return {"status": "error", "message": "unknown op %r" % (op,)}

    # -- intake --------------------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, eos_id=None,
               temperature=0.0, top_k=0, top_p=1.0, seed=0, session=None):
        """Queue one request for placement; returns a FleetStream.
        Raises :class:`QueueFullError` past ``pending_max`` with the
        soonest replica-hinted retry-after."""
        with self._lock:
            depth = len(self._pending)
            if depth >= self.pending_max:
                self._counts["rejected"] += 1
                now = time.monotonic()
                hints = [r.full_until - now
                         for r in self._replicas.values()
                         if r.alive and r.full_until > now]
                if _tel.ENABLED:
                    _tel.counter("fleet.requests_rejected").inc()
                raise QueueFullError(
                    "router admission queue full (%d)" % self.pending_max,
                    queue_depth=depth,
                    retry_after_s=min(hints) if hints else 1.0)
            rid = next(self._rids)
            self._counts["submitted"] += 1
            entry = _FleetRequest(rid, prompt, max_new_tokens, eos_id,
                                  temperature, top_k, top_p, seed, session)
            entry.submit_t = time.monotonic()
            entry.stream = FleetStream(self, rid)
            if _tel.ENABLED:
                entry.trace = _tel.mint_trace()
                _tel.counter("fleet.requests_total").inc()
                _tel.event("fleet.request.submit", trace=entry.trace,
                           rid=rid, prompt_len=len(entry.prompt),
                           max_new_tokens=entry.max_new, session=session)
            self._requests[rid] = entry
            self._pending.append(rid)
            return entry.stream

    def cancel(self, rid):
        with self._lock:
            entry = self._requests.get(rid)
            if entry is None:
                return False
            rep = (self._replicas.get(entry.replica)
                   if entry.replica is not None else None)
            if rep is not None:
                rep.inflight.discard(rid)
                try:
                    rep.client.cancel_req(rid=entry.rrid)
                except Exception:  # noqa: BLE001 - dying replica: moot
                    pass
            if rid in self._pending:
                self._pending.remove(rid)
            self._counts["cancelled"] += 1
            if _tel.ENABLED:
                _tel.counter("fleet.requests_cancelled").inc()
            entry.stream._end("cancelled")
            del self._requests[rid]
            return True

    # -- the pump ------------------------------------------------------------
    def step(self, now=None):
        """One deterministic pump iteration: health scrape, placement,
        stream poll. Returns True when anything happened."""
        now = time.monotonic() if now is None else now
        with self._lock:
            worked = self._scrape_locked(now)
            worked = self._place_locked(now) or worked
            worked = self._poll_locked(now) or worked
            self._update_gauges_locked(now)
            return worked

    def _scrape_locked(self, now):
        worked = False
        for name in sorted(self._replicas):
            rep = self._replicas[name]
            if not rep.alive:
                continue
            if now - rep.last_scrape_t < self.health_interval:
                continue
            rep.last_scrape_t = now
            try:
                resp = rep.client.stats()
            except Exception as e:  # noqa: BLE001 - scrape failure = dead
                self._evict_locked(rep, "scrape_failed: %s"
                                   % type(e).__name__)
                worked = True
                continue
            rep.stats = dict(resp.get("stats") or {})
            rep.accepting = bool(resp.get("accepting", True))
        return worked

    def _candidates_locked(self, now):
        return [r for _, r in sorted(self._replicas.items())
                if r.alive and r.accepting and now >= r.full_until
                and len(r.inflight) < self.inflight_cap]

    def _place_locked(self, now):
        placed = False
        while self._pending:
            cands = self._candidates_locked(now)
            if not cands:
                break
            rid = self._pending[0]
            entry = self._requests[rid]
            rep = None
            if entry.session is not None:
                sticky = self._affinity.get(entry.session)
                rep = next((r for r in cands if r.name == sticky), None)
            if rep is None:
                # least-loaded: router-side in-flight count first, then
                # the scraped engine queue depth, name as tiebreak
                rep = min(cands, key=lambda r: (
                    len(r.inflight), r.stats.get("queue_depth", 0),
                    r.name))
            self._pending.popleft()
            prefix = entry.tokens if entry.tokens else None
            try:
                resp = rep.client.submit(
                    prompt=entry.prompt, max_new=entry.max_new,
                    eos_id=entry.eos_id, temperature=entry.temperature,
                    top_k=entry.top_k, top_p=entry.top_p,
                    seed=entry.seed, prefix=prefix)
            except Exception as e:  # noqa: BLE001 - transport = death
                self._pending.appendleft(rid)
                self._evict_locked(rep, "submit_failed: %s"
                                   % type(e).__name__)
                placed = True
                continue
            if resp.get("status") == "full":
                rep.full_until = now + float(
                    resp.get("retry_after_s") or 1.0)
                self._pending.appendleft(rid)
                continue
            if resp.get("status") != "ok":
                # a rejected placement (e.g. geometry) is terminal for
                # the REQUEST, not the replica
                entry.stream._end("error")
                del self._requests[rid]
                placed = True
                continue
            entry.replica = rep.name
            entry.rrid = resp["rid"]
            entry.placed_tokens = len(entry.tokens)
            rep.inflight.add(rid)
            if entry.session is not None:
                self._affinity[entry.session] = rep.name
            if _tel.ENABLED:
                _tel.event("fleet.request.place",
                           trace=entry.pending_trace or entry.trace,
                           rid=rid, replica=rep.name,
                           redeliveries=entry.redeliveries,
                           prefix_len=entry.placed_tokens)
            entry.pending_trace = None
            placed = True
        return placed

    def _poll_locked(self, now):
        worked = False
        for name in sorted(self._replicas):
            rep = self._replicas[name]
            if not rep.alive:
                continue
            for rid in sorted(rep.inflight):
                entry = self._requests[rid]
                have = len(entry.tokens) - entry.placed_tokens
                try:
                    resp = rep.client.stream(rid=entry.rrid, have=have)
                except Exception as e:  # noqa: BLE001 - transport = death
                    self._evict_locked(rep, "stream_failed: %s"
                                       % type(e).__name__)
                    worked = True
                    break
                toks = resp.get("tokens") or []
                for t in toks:
                    entry.tokens.append(int(t))
                    entry.stream._emit(t)
                    self._tokens_total += 1
                    self._rate_window.append((now, self._tokens_total))
                    if entry.first_token_t is None:
                        entry.first_token_t = now
                        self._ttfts.append(now - entry.submit_t)
                        if _tel.ENABLED:
                            _tel.histogram("fleet.ttft_s").observe(
                                now - entry.submit_t)
                if toks:
                    worked = True
                if resp.get("done"):
                    status = resp.get("final_status") or "finished"
                    rep.inflight.discard(rid)
                    del self._requests[rid]
                    self._counts["completed"] += 1
                    if _tel.ENABLED:
                        _tel.counter("fleet.requests_completed").inc()
                        _tel.event("fleet.request.complete",
                                   trace=entry.trace, rid=rid,
                                   status=status,
                                   tokens=len(entry.tokens),
                                   redeliveries=entry.redeliveries)
                    entry.stream._end(status)
                    worked = True
        return worked

    def _evict_locked(self, rep, reason):
        """Crash eviction: mark dead (the entry STAYS, reporting
        alive=0 to the FleetProbe) and redeliver its in-flight
        requests."""
        if not rep.alive:
            return
        rep.alive = False
        rep.accepting = False
        self._counts["evictions"] += 1
        if _tel.ENABLED:
            _tel.counter("fleet.replica_evictions_total").inc()
            _tel.event("fleet.replica.evict", replica=rep.name,
                       reason=reason, inflight=len(rep.inflight))
        self._redeliver_locked(rep, reason)
        self._affinity = {s: n for s, n in self._affinity.items()
                          if n != rep.name}

    def _redeliver_locked(self, rep, reason):
        """Re-queue everything in flight on ``rep`` at the FRONT of the
        pending queue (original submit order preserved — rids are
        monotonic). Each redelivery is one journal transaction: a fresh
        trace id shared by its ``fleet.redeliver`` event and the
        ``fleet.request.place`` that lands it on a survivor."""
        rids = sorted(rep.inflight)
        rep.inflight.clear()
        for rid in reversed(rids):
            entry = self._requests[rid]
            entry.replica = None
            entry.rrid = None
            entry.redeliveries += 1
            self._counts["redelivered"] += 1
            if _tel.ENABLED:
                entry.pending_trace = _tel.mint_trace()
                _tel.counter("fleet.redeliveries_total").inc()
                _tel.event("fleet.redeliver", trace=entry.pending_trace,
                           rid=rid, from_replica=rep.name, reason=reason,
                           tokens_streamed=len(entry.tokens),
                           redeliveries=entry.redeliveries)
            self._pending.appendleft(rid)

    # -- reporting -----------------------------------------------------------
    def _update_gauges_locked(self, now):
        win = [x for x in self._rate_window if now - x[0] <= 2.0]
        self._rate_window = win
        rate = 0.0
        if len(win) >= 2 and win[-1][0] > win[0][0]:
            rate = (win[-1][1] - win[0][1]) / (win[-1][0] - win[0][0])
        self._last_rate = rate
        if _tel.ENABLED:
            _tel.gauge("fleet.replicas_alive").set(
                sum(1 for r in self._replicas.values() if r.alive))
            _tel.gauge("fleet.queue_depth").set(len(self._pending))
            _tel.gauge("fleet.tokens_per_s").set(rate)

    def stats(self):
        """Aggregate + per-replica view (plain numbers — what the
        FleetProbe turns into mxctl TargetSamples)."""
        def pct(xs, q):
            if not xs:
                return None
            return float(np.percentile(np.asarray(xs), q))

        with self._lock:
            now = time.monotonic()
            self._update_gauges_locked(now)
            reps = {}
            for name, r in sorted(self._replicas.items()):
                reps[name] = {
                    "alive": r.alive,
                    "accepting": r.accepting,
                    "inflight": len(r.inflight),
                    "queue_depth": r.stats.get("queue_depth", 0),
                    "tokens_per_s": r.stats.get("tokens_per_s_window",
                                                0.0),
                    "addr": r.addr,
                }
            out = dict(self._counts)
            out.update({
                "replicas": reps,
                "replicas_alive": sum(
                    1 for r in self._replicas.values() if r.alive),
                "replicas_accepting": sum(
                    1 for r in self._replicas.values()
                    if r.alive and r.accepting),
                "pending": len(self._pending),
                "inflight": sum(len(r.inflight)
                                for r in self._replicas.values()),
                "queue_depth": len(self._pending) + sum(
                    r.stats.get("queue_depth", 0)
                    for r in self._replicas.values() if r.alive),
                "tokens_per_s": self._last_rate,
                "ttft_p50_s": pct(self._ttfts, 50),
                "ttft_p99_s": pct(self._ttfts, 99),
            })
            return out

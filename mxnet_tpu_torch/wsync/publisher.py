"""The wsync publisher: versioned weight sets served over elastic RPC.

Counterpart of ``mxnet_tpu/wsync/publisher.py``. One process-wide
:class:`WeightPublisher` owns a bounded history of complete,
fingerprinted weight versions and answers the four ``wsync_*`` ops
(connection-per-request, ``elastic/protocol.py`` framing):

=================  ===========================================
``wsync_poll``     long-poll for a version newer than ``have``
``wsync_manifest`` per-tensor shape/dtype/fingerprint of a version
``wsync_fetch``    one tensor of one version, full precision
``wsync_ack``      subscriber outcome (applied/rejected/aborted)
=================  ===========================================

Versions arrive from either feed:

- the in-process trainer hook — :meth:`WeightPublisher.publish` called
  with the live params (and draft params) after an eval gate;
- a :class:`CheckpointWatcher` thread polling
  ``model.find_latest_checkpoint`` over a checkpoint directory, so any
  training job that only writes checkpoints still streams (the
  ``python -m mxnet_tpu_torch.wsync.publisher`` entry point).

The store holds CPU tensors of each param's own dtype; a fetch answers
with the numpy array of ``common.to_wire`` (a bf16 tensor's raw bit
patterns as ``uint16``). The publisher does no device work: it runs
beside a trainer or over a checkpoint directory on any host.

A publisher is only ever constructed explicitly (or by the CLI): the
serving-side ``MXNET_WSYNC`` switch gates the subscriber, and with it
unset nothing in this module runs — no thread, no socket.
"""
from __future__ import annotations

import os
import socketserver
import threading
import time

from .. import telemetry as _tel
from ..base import MXNetError
from ..elastic import protocol
from . import common as _wc

__all__ = ["WeightPublisher", "CheckpointWatcher", "main"]

#: server-side cap on one poll's long-poll budget (seconds) — same
#: discipline (and value) as the elastic coordinator's wait cap: a
#: parked request never outlives the client's 30 s RPC timeout
_WSYNC_WAIT_CAP = 25.0


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        try:
            req = protocol.recv_msg(self.request, what="wsync request")
            if req is None:
                return
            wire = req.pop("_trace", None)
            try:
                with _tel.span("wsync.serve.%s" % req.get("op"), wire=wire):
                    resp = self.server.publisher._dispatch(req)
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


class WeightPublisher:
    """Versioned weight-set store + RPC server.

    Parameters
    ----------
    bind : (host, port) or None
        RPC endpoint (port 0 picks an ephemeral port). ``None`` builds
        a socketless publisher for tests that drive ``_dispatch``
        directly.
    history : int, optional
        Complete versions kept fetchable (``MXNET_WSYNC_HISTORY``,
        default 4) — a slow subscriber mid-transaction can still finish
        fetching version N after N+1..N+history-1 landed.
    throttle : float
        Seconds slept inside each ``wsync_fetch`` reply — the chaos
        harness widens the mid-stream kill window with this; 0 (the
        default) for real deployments.
    """

    def __init__(self, bind=("127.0.0.1", 0), history=None, throttle=0.0):
        if history is None:
            history = max(1, int(_wc.env_float("MXNET_WSYNC_HISTORY", 4)))
        self.history = int(history)
        self.throttle = float(throttle)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._versions = {}      # version -> {"tensors": flat, "manifest": m}
        self._order = []         # insertion order, oldest first
        self._latest = 0         # 0 = nothing published yet
        self._acks = []          # (version, rank, outcome) tail, bounded
        self._server = None
        self._thread = None
        if bind is not None:
            self._server = _Server(tuple(bind), _Handler)
            self._server.publisher = self

    # -- lifecycle -------------------------------------------------------------
    @property
    def addr(self):
        if self._server is None:
            raise MXNetError("publisher was built socketless (bind=None)")
        return self._server.server_address

    def start(self):
        """Serve in a daemon thread; returns the bound (host, port)."""
        if self._server is None:
            raise MXNetError("publisher was built socketless (bind=None)")
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever, name="mx-wsync-pub",
                daemon=True)
            self._thread.start()
        return self.addr

    def close(self):
        if self._server is not None and self._thread is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread = None

    # -- the trainer hook ------------------------------------------------------
    def publish(self, params, draft_params=None, version=None):
        """Land one complete version (target + optional draft params in
        ONE version — the same-transaction draft refresh is structural:
        a version either carries both or the subscriber refreshes
        neither). Returns the version number.

        Host-snapshots every tensor at publish time (a copy on the CPU
        of its own dtype), so the trainer may keep mutating its live
        params immediately."""
        flat = {k: _wc.host_tensor(v)
                for k, v in _wc.combine_draft(params, draft_params).items()}
        manifest = _wc.manifest_of(flat)
        nbytes = int(sum(t.numel() * t.element_size()
                         for t in flat.values()))
        with self._lock:
            v = int(version) if version is not None else self._latest + 1
            if v <= self._latest:
                raise MXNetError(
                    "wsync versions are monotonic: publish(version=%d) "
                    "after version %d" % (v, self._latest))
            self._versions[v] = {"tensors": flat, "manifest": manifest}
            self._order.append(v)
            while len(self._order) > self.history:
                del self._versions[self._order.pop(0)]
            self._latest = v
            self._cond.notify_all()
        if _tel.ENABLED:
            _tel.counter("wsync.versions_published_total").inc()
            _tel.gauge("wsync.published_version").set(v)
            _wc.journal("published", v, trace=_tel.mint_trace(),
                        tensors=len(flat), bytes=nbytes,
                        draft=draft_params is not None)
        return v

    # -- RPC dispatch ----------------------------------------------------------
    def _dispatch(self, req):
        op = req.get("op")
        rank = int(req.get("rank", -1))
        if op == "wsync_poll":
            have = int(req.get("have", 0) or 0)
            deadline = time.monotonic() + min(
                float(req.get("wait", 0.0) or 0.0), _WSYNC_WAIT_CAP)
            with self._lock:
                while self._latest <= have:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return {"status": "pending", "version": self._latest}
                    self._cond.wait(min(remaining, 0.5))
                return {"status": "ok", "version": self._latest}
        if op == "wsync_manifest":
            v = int(req["version"])
            with self._lock:
                ent = self._versions.get(v)
                if ent is None:
                    return {"status": "error",
                            "message": "version %d not available (have %s)"
                                       % (v, sorted(self._versions))}
                return {"status": "ok", "version": v,
                        "tensors": ent["manifest"]}
        if op == "wsync_fetch":
            v = int(req["version"])
            key = req["key"]
            with self._lock:
                ent = self._versions.get(v)
                arr = ent["tensors"].get(key) if ent is not None else None
                fp = ent["manifest"][key]["fp"] if arr is not None else None
            if arr is None:
                return {"status": "error",
                        "message": "no tensor %r in version %d" % (key, v)}
            if self.throttle:
                time.sleep(self.throttle)
            # full precision always — the byte-parity contract (a bf16
            # tensor crosses as its raw bit patterns)
            return {"status": "ok", "value": _wc.to_wire(arr), "fp": fp}
        if op == "wsync_ack":
            v = int(req["version"])
            outcome = str(req["outcome"])
            with self._lock:
                self._acks.append((v, rank, outcome))
                del self._acks[:-256]
            if _tel.ENABLED:
                _tel.counter("wsync.acks_total").inc()
                _wc.journal("ack", v, rank=rank, outcome=outcome)
            return {"status": "ok"}
        return {"status": "error", "message": "unknown wsync op %r" % (op,)}

    def acks(self):
        """Recent (version, rank, outcome) subscriber acks (tests and
        the watcher's progress logging)."""
        with self._lock:
            return list(self._acks)


class CheckpointWatcher:
    """Poll a checkpoint prefix and publish every new complete epoch.

    Rides the crash-safe checkpoint discipline end to end:
    ``find_latest_checkpoint`` fences partial writes and validates
    structure, so a torn or in-flight checkpoint is never published.
    The epoch number IS the wsync version — exactly-once, monotonic.
    """

    def __init__(self, publisher, prefix, interval=None):
        self.publisher = publisher
        self.prefix = str(prefix)
        if interval is None:
            interval = _wc.env_float("MXNET_WSYNC_INTERVAL", 2.0)
        self.interval = max(0.05, float(interval))
        self._published = 0
        self._stop = threading.Event()
        self._thread = None

    def poll_once(self):
        """One scan; returns the version published, or None."""
        from ..model import find_latest_checkpoint

        epoch = find_latest_checkpoint(self.prefix)
        if epoch is None or epoch <= self._published:
            return None
        params, draft = _wc.load_weights_checkpoint(self.prefix, epoch)
        v = self.publisher.publish(params, draft, version=epoch)
        self._published = epoch
        return v

    def run(self):
        """Foreground watch loop (the CLI's body)."""
        while not self._stop.is_set():
            try:
                self.poll_once()
            except (OSError, MXNetError):
                pass  # torn/vanishing files heal on the next scan
            self._stop.wait(self.interval)

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self.run,
                                            name="mx-wsync-watch",
                                            daemon=True)
            self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def main(argv=None):
    """``python -m mxnet_tpu_torch.wsync.publisher --bind host:port
    --watch <ckpt_prefix>`` — the standalone publisher over a training
    job's checkpoint directory."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bind", default="127.0.0.1:0",
                   help="host:port to serve on (port 0 = ephemeral)")
    p.add_argument("--watch", required=True,
                   help="checkpoint prefix to poll "
                        "(model.find_latest_checkpoint)")
    p.add_argument("--interval", type=float, default=None,
                   help="watch poll interval (MXNET_WSYNC_INTERVAL)")
    p.add_argument("--throttle", type=float, default=0.0,
                   help="seconds slept per wsync_fetch reply (chaos "
                        "kill-window widener)")
    args = p.parse_args(argv)
    host, _, port = args.bind.rpartition(":")
    pub = WeightPublisher(bind=(host or "127.0.0.1", int(port)),
                          throttle=args.throttle)
    addr = pub.start()
    print("wsync publisher listening on %s:%d pid %d"
          % (addr[0], addr[1], os.getpid()), flush=True)
    watcher = CheckpointWatcher(pub, args.watch, interval=args.interval)
    try:
        watcher.run()
    except KeyboardInterrupt:
        pass
    finally:
        pub.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

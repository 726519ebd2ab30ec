"""Fleet replica: one serving Engine behind ``fleet_*`` RPC arms.

Counterpart of ``mxnet_tpu/serving/fleet/replica.py``. A
:class:`ReplicaServer` wraps an :class:`~..engine.Engine` in the
elastic RPC substrate (connection-per-request ``elastic/protocol.py``
framing, linted by ``mxlint --proto``):

=================  ====================================================
``fleet_submit``   admit one request (optionally with a redelivery
                   ``prefix`` — tokens the client already streamed on a
                   dead replica, folded into the recompute prefill)
``fleet_stream``   short-long-poll new tokens past ``have``
``fleet_cancel``   cancel one request
``fleet_drain``    close admissions; in-flight work runs to completion
``fleet_stats``    engine stats + accepting flag — the router's health
                   scrape (a transport failure here IS the death signal)
=================  ====================================================

The ``python -m mxnet_tpu_torch.serving.fleet.replica`` entry point is
the supervised-process shape: build a seeded demo model on ``cuda:0``
(``--device`` names another; without CUDA it raises), warm it, mark
mxdash ready, register with the router, and on SIGTERM drain
gracefully, send ``fleet_leave``, and exit 0 — the drain contract.
Every replica in a fleet seeds identically (``init_params`` under a
torch generator seeded by ``--seed``), so any survivor can continue any
stream byte-identically; the port's replicas are not the JAX package's
(a torch generator, not threefry, draws the weights). Real deployments
embed :class:`ReplicaServer` around their own Engine the same way.
"""
from __future__ import annotations

import argparse
import os
import signal
import socketserver
import sys
import threading
import time

import numpy as np

from ... import telemetry as _tel
from ...base import MXNetError
from ...elastic import protocol
from ..engine import Engine, QueueFullError, ServingConfig

__all__ = ["ReplicaServer", "build_demo_engine", "main"]

#: server-side cap on one fleet_stream long-poll (seconds) — well under
#: the client's 30 s RPC timeout (the wsync publisher discipline)
_STREAM_WAIT_CAP = 5.0


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        try:
            req = protocol.recv_msg(self.request, what="fleet request")
            if req is None:
                return
            wire = req.pop("_trace", None)
            try:
                with _tel.span("fleet.serve.%s" % req.get("op"),
                               wire=wire):
                    resp = self.server.replica._dispatch(req)
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


class ReplicaServer:
    """One Engine served over ``fleet_*`` RPC.

    Parameters
    ----------
    engine : Engine
        The wrapped engine; the caller owns its step drive
        (``engine.start()`` for a live process, direct ``step()`` for
        deterministic tests).
    name : str
        Fleet-wide replica name (the supervisor/router key).
    bind : (host, port) or None
        RPC endpoint (port 0 ephemeral). ``None`` builds a socketless
        replica whose ``_dispatch`` the router drives in-process (the
        bench/mxrace shape — no sockets, same code path).
    """

    def __init__(self, engine, name="replica0", bind=("127.0.0.1", 0)):
        self.engine = engine
        self.name = str(name)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._streams = {}       # rid -> {"buf": [...], "done", "status"}
        self._server = None
        self._thread = None
        if bind is not None:
            self._server = _Server(tuple(bind), _Handler)
            self._server.replica = self

    # -- lifecycle -----------------------------------------------------------
    @property
    def addr(self):
        if self._server is None:
            raise MXNetError("replica was built socketless (bind=None)")
        return self._server.server_address

    def start(self):
        """Serve in a daemon thread; returns the bound (host, port)."""
        if self._server is None:
            raise MXNetError("replica was built socketless (bind=None)")
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever, name="mx-fleet-rep",
                daemon=True)
            self._thread.start()
        return self.addr

    def close(self):
        if self._server is not None and self._thread is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread = None

    # -- the per-request pump ------------------------------------------------
    def _pump(self, rid, handle):
        """Drain one StreamHandle into its wire buffer (daemon thread
        per request — the replica is the stream's consumer, so the
        engine's idle reaper never fires on fleet traffic; an abandoned
        ROUTER is handled by fleet_cancel / the router's own journal)."""
        try:
            for tok in handle.tokens():
                with self._cond:
                    self._streams[rid]["buf"].append(int(tok))
                    self._cond.notify_all()
        finally:
            with self._cond:
                rec = self._streams[rid]
                rec["done"] = True
                rec["status"] = handle.status
                self._cond.notify_all()

    # -- RPC dispatch --------------------------------------------------------
    def _dispatch(self, req):
        op = req.get("op")
        if op == "fleet_submit":
            try:
                handle = self.engine.submit(
                    np.asarray(req["prompt"], np.int32),
                    max_new_tokens=int(req["max_new"]),
                    eos_id=req.get("eos_id"),
                    temperature=float(req.get("temperature") or 0.0),
                    top_k=int(req.get("top_k") or 0),
                    top_p=float(req.get("top_p") or 1.0),
                    seed=int(req.get("seed") or 0),
                    prefix_tokens=req.get("prefix"))
            except QueueFullError as e:
                # backpressure is a protocol answer, not an error: the
                # router backs off for retry_after_s and sheds elsewhere
                return {"status": "full",
                        "queue_depth": e.queue_depth,
                        "retry_after_s": e.retry_after_s}
            rid = handle.request_id
            with self._cond:
                self._streams[rid] = {"buf": [], "done": False,
                                      "status": None, "handle": handle}
            threading.Thread(target=self._pump, args=(rid, handle),
                             name="mx-fleet-pump-%d" % rid,
                             daemon=True).start()
            return {"status": "ok", "rid": rid, "name": self.name}
        if op == "fleet_stream":
            rid = req["rid"]
            have = int(req.get("have") or 0)
            wait = min(float(req.get("wait") or 0.0), _STREAM_WAIT_CAP)
            deadline = time.monotonic() + wait
            with self._cond:
                rec = self._streams.get(rid)
                if rec is None:
                    return {"status": "error",
                            "message": "unknown rid %r" % (rid,)}
                while (len(rec["buf"]) <= have and not rec["done"]):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(min(remaining, 0.5))
                toks = list(rec["buf"][have:])
                done = rec["done"] and have + len(toks) >= len(rec["buf"])
                out = {"status": "ok", "tokens": toks, "done": done,
                       "final_status": rec["status"]}
                if done:
                    del self._streams[rid]
                return out
        if op == "fleet_cancel":
            rid = req["rid"]
            with self._cond:
                rec = self._streams.get(rid)
            if rec is not None:
                rec["handle"].cancel()
            return {"status": "ok", "known": rec is not None}
        if op == "fleet_drain":
            drained = self.engine.drain(
                wait=bool(req.get("wait")),
                timeout=req.get("drain_timeout"))
            return {"status": "ok", "drained": bool(drained)}
        if op == "fleet_stats":
            return {"status": "ok", "name": self.name,
                    "accepting": self.engine.accepting(),
                    "stats": self.engine.stats()}
        return {"status": "error", "message": "unknown op %r" % (op,)}


# -- the supervised-process entry point --------------------------------------
def build_demo_engine(seed, device=None):
    """A small, deterministic engine for a demo fleet: every replica
    seeded identically serves byte-identical streams, which is what
    makes redelivery provable end to end. On ``device`` (default
    ``cuda:0``)."""
    import torch

    from ...context import resolve_device
    from ...models.transformer import TransformerConfig, init_params

    device = resolve_device(device)
    cfg = TransformerConfig(
        vocab_size=int(os.environ.get("MXNET_FLEET_VOCAB", "61")),
        num_layers=2, d_model=32, num_heads=2, d_ff=64,
        max_seq_len=96, dtype="float32")
    scfg = ServingConfig(block_size=8, num_blocks=97, max_batch=4,
                         max_active=8, prefill_chunk=16,
                         max_queue_depth=int(
                             os.environ.get("MXNET_FLEET_QUEUE", "16")))
    params = init_params(
        cfg, torch.Generator(device=device).manual_seed(int(seed)), device)
    return Engine(params, cfg, scfg, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.serving.fleet.replica",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--router", default=os.environ.get(
        "MXNET_FLEET_ROUTER", ""), help="router host:port to register "
        "with (MXNET_FLEET_ROUTER)")
    ap.add_argument("--name", default=os.environ.get(
        "MXNET_FLEET_NAME", "") or os.environ.get(
        "MXCTL_REPLICA_NAME", "replica0"))
    ap.add_argument("--bind", default=os.environ.get(
        "MXNET_FLEET_BIND", "127.0.0.1:0"), metavar="HOST:PORT")
    ap.add_argument("--seed", type=int, default=int(
        os.environ.get("MXNET_FLEET_SEED", "0") or 0),
        help="model init seed — identical across the fleet")
    ap.add_argument("--device", default=None,
                    help="torch device of the demo engine (default "
                    "cuda:0)")
    args = ap.parse_args(argv)

    _tel.server.mark_ready(False, "starting")
    host, _, port = args.bind.rpartition(":")
    eng = build_demo_engine(args.seed, args.device)
    # warm the step BEFORE advertising ready: lazy CUDA and cuBLAS
    # set-up lands here, not in the first request's TTFT
    eng.generate([np.arange(5, dtype=np.int32),
                  np.arange(23, dtype=np.int32)], max_new_tokens=3)
    eng.start()
    rep = ReplicaServer(eng, name=args.name,
                        bind=(host or "127.0.0.1", int(port or 0)))
    bound = rep.start()
    print("fleet replica %s listening on %s:%d pid %d"
          % (args.name, bound[0], bound[1], os.getpid()), flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_a: stop.set())
    signal.signal(signal.SIGINT, lambda *_a: stop.set())

    client = None
    if args.router:
        from .router import FleetClient

        client = FleetClient(args.router)
        client.register(name=args.name,
                        addr="%s:%d" % (bound[0], bound[1]))
    _tel.server.mark_ready(True)

    while not stop.is_set():
        stop.wait(0.2)

    # SIGTERM -> drain contract: admissions close, in-flight requests
    # finish, THEN we leave the fleet and exit 0 (zero dropped streams)
    _tel.server.mark_ready(False, "stopping")
    eng.drain(wait=True, timeout=float(
        os.environ.get("MXNET_FLEET_DRAIN_TIMEOUT", "30") or 30))
    if client is not None:
        try:
            client.leave(name=args.name)
        except Exception:  # noqa: BLE001 - router may already be gone
            pass
    eng.stop()
    rep.close()
    if _tel.ENABLED:
        _tel.flush(mark="exit")
    return 0


if __name__ == "__main__":
    sys.exit(main())

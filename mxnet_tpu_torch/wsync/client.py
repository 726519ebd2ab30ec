"""Subscriber-side RPC client for the wsync publisher.

The same connection-per-request discipline as
:class:`~..elastic.client.ElasticClient`: each call is one
``protocol.call`` round trip behind the ``kv.coord`` fault-injection
point and ``MXNET_KV_RETRIES`` attempts of jittered exponential
backoff, with the ``elastic.rpc``-style telemetry span
(``wsync.rpc.<op>``) carrying the transaction's trace context over the
wire. A publisher restart mid-transaction heals here; a dead publisher
surfaces after the retry budget and the subscriber aborts the
transaction without touching the engine.
"""
from __future__ import annotations

import os

from .. import telemetry as _tel
from ..base import MXNetError
from ..elastic import protocol
from ..elastic.client import parse_addr
from ..resilience import faults as _faults
from ..resilience.retry import RetryPolicy

__all__ = ["WsyncClient"]


class WsyncClient:
    """One subscriber's handle on a publisher. Stateless between calls
    (survives publisher restarts); holds only the address, the rank,
    and the retry policy."""

    def __init__(self, addr, rank=-1, timeout=30.0):
        self.addr = parse_addr(addr) if isinstance(addr, str) else tuple(addr)
        self.rank = int(rank)
        self.timeout = float(timeout)
        attempts = max(1, int(os.environ.get("MXNET_KV_RETRIES", "4")))
        self._policy = RetryPolicy(max_attempts=attempts, base_delay=0.05,
                                   max_delay=1.0, jitter=0.25)

    def call(self, op, check=True, **fields):
        """One RPC. Transport errors retry under the policy; an
        ``error`` status raises MXNetError (when ``check``); 'pending'
        is a protocol answer the poll loop dispatches on."""
        req = dict(fields)
        req["op"] = op
        req["rank"] = self.rank

        def _rpc():
            _faults.point("kv.coord")
            return protocol.call(self.addr, req, timeout=self.timeout)

        _rpc.__name__ = "wsync %s" % op
        if not _tel.ENABLED:
            resp = self._policy.call(_rpc)
        else:
            with _tel.span("wsync.rpc.%s" % op):
                req["_trace"] = _tel.wire_context()
                resp = self._policy.call(_rpc)
        if check and resp.get("status") == "error":
            raise MXNetError("wsync publisher rejected %s: %s"
                             % (op, resp.get("message", "(no message)")))
        return resp

    # -- op wrappers -----------------------------------------------------------
    def poll_version(self, have, wait=None):
        """Newest published version, long-polling up to ``wait`` s when
        nothing newer than ``have`` exists yet ('pending' reply)."""
        fields = {"have": int(have)}
        if wait:
            fields["wait"] = float(wait)
        return self.call("wsync_poll", **fields)

    def fetch_manifest(self, version):
        """Per-tensor ``{path: {shape, dtype, fp}}`` of one version."""
        return self.call("wsync_manifest", version=int(version))

    def fetch_tensor(self, version, key):
        """One tensor of one version, full precision."""
        return self.call("wsync_fetch", version=int(version), key=key)

    def ack_version(self, version, outcome, check=True):
        """Report this subscriber's transaction outcome (applied /
        rejected:<reason> / aborted) — the publisher's delivery
        ledger."""
        return self.call("wsync_ack", check=check, version=int(version),
                         outcome=str(outcome))

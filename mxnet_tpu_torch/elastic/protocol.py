"""Wire protocol for the elastic coordination service.

One request/response pair per TCP connection, each message a 4-byte
big-endian length prefix followed by a pickled dict. Connection-per-
request is deliberate: a SIGKILLed worker leaves no half-open stream to
poison, and a restarted coordinator serves the very next request without
any session re-establishment — the property the whole elastic layer
exists for. Throughput is bounded by the coordinator's Python loop, not
the handshake (measured ample for heartbeats + per-key round polling on
a training job; bulk tensor traffic stays on this path only for modest
parameter sets, mirroring the dist_async transport note in kvstore.py).

Pickle is the payload codec for the same reason the reference ships its
optimizer as a pickle to the ps-lite server (python/mxnet/kvstore.py:231):
the peers are the job's own cooperating processes.

Framing failures are first-class: a truncated header, an oversized
length prefix, a peer that disconnects mid-frame, or an undecodable
payload all raise :class:`ProtocolError` naming the peer (and, when the
caller supplies it, the op) — never a bare ``struct.error`` or
unpickling garbage. ``ProtocolError`` also subclasses
``ConnectionError`` so the resilience retry discipline treats a torn
frame exactly like any other transient transport failure (a restarting
coordinator tears frames by design). A clean close *between* frames is
still ``None`` from :func:`recv_msg` — that is how a connection ends.

Tracing envelope (telemetry on only): requests may carry a ``_trace``
field — the caller's ``telemetry.wire_context()`` dict
(``{"trace": str, "span": int}``) — which the server handler pops and
adopts so its spans join the caller's trace; replies carry ``_srv_t``
(server wall clock at reply time) for trace_merge's clock-offset
estimation. Both are optional underscore fields: codec-off peers
ignore them entirely.

SECURITY: unpickling executes code, so anyone who can reach the
coordinator port owns the job. Bind the coordinator to a loopback or
cluster-private interface only (the 127.0.0.1 default), exactly as the
reference's ps-lite/ZMQ endpoints and jax.distributed's coordinator
assume a trusted network.
"""
from __future__ import annotations

import pickle
import socket
import struct

from ..base import MXNetError

__all__ = ["send_msg", "recv_msg", "call", "ProtocolError"]

_LEN = struct.Struct(">I")
MAX_MSG = 1 << 30  # a torn/garbage length prefix must not OOM the server


class ProtocolError(MXNetError, ConnectionError):
    """Malformed frame on the elastic coordination socket.

    Also a ``ConnectionError``: callers running under the resilience
    retry policy heal a torn frame the same way they heal a refused
    connection — by retrying against the (possibly restarted) peer."""


def _ctx(peer, what):
    """' (<what> from <peer>)' suffix for framing diagnostics."""
    parts = []
    if what:
        parts.append(str(what))
    if peer:
        parts.append("from %s" % (peer,))
    return (" (%s)" % " ".join(parts)) if parts else ""


def send_msg(sock, obj):
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock, n, peer, what, part, allow_eof):
    """``n`` bytes or, when ``allow_eof`` and the peer closed cleanly
    before the first byte, None. A close partway through ``part`` is a
    torn frame and raises ProtocolError."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if allow_eof and not buf:
                return None  # clean close between frames
            raise ProtocolError(
                "peer disconnected mid-frame: got %d of %d %s bytes%s"
                % (len(buf), n, part, _ctx(peer, what)))
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock, peer=None, what=None):
    """One framed message, or None on a clean close between frames.

    ``peer``/``what`` (e.g. ``"reply to 'push'"``) name the counterparty
    and the op in framing diagnostics so a torn frame is attributable
    without a packet capture. Raises :class:`ProtocolError` on a
    truncated header, an oversized or torn frame, and an undecodable
    payload."""
    head = _recv_exact(sock, _LEN.size, peer, what, "header",
                       allow_eof=True)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > MAX_MSG:
        raise ProtocolError(
            "frame length prefix %d exceeds the %d-byte limit%s — "
            "corrupt or non-protocol peer" % (n, MAX_MSG, _ctx(peer, what)))
    payload = _recv_exact(sock, n, peer, what, "payload", allow_eof=False)
    try:
        return pickle.loads(payload)
    except Exception as e:  # noqa: BLE001 — any unpickling failure
        raise ProtocolError(
            "undecodable frame payload (%d bytes)%s: %s: %s"
            % (n, _ctx(peer, what), type(e).__name__, e))


def call(addr, req, timeout=30.0):
    """One request/response round trip to ``addr`` = (host, port).

    Raises OSError subclasses on transport failure (ProtocolError
    included) — callers wrap this in the resilience retry discipline
    (kvstore._coord_call analog)."""
    peer = "%s:%s" % (addr[0], addr[1])
    what = None
    if isinstance(req, dict) and req.get("op") is not None:
        what = "reply to %r" % (req.get("op"),)
    with socket.create_connection(addr, timeout=timeout) as sock:
        sock.settimeout(timeout)
        send_msg(sock, req)
        resp = recv_msg(sock, peer=peer, what=what)
    if resp is None:
        raise ConnectionError(
            "elastic coordinator closed the connection%s"
            % _ctx(peer, what))
    return resp

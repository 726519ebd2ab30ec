"""The elastic RPC substrate (counterpart of ``mxnet_tpu/elastic/``).

This release carries the wire and the address parser that the serving
fleet (``serving/fleet/``) and live weight sync (``wsync/``) speak:

- :mod:`.protocol` — one length-prefixed pickled dict a message, one
  request/response pair a TCP connection, :class:`ProtocolError` on a
  torn frame (a byte copy of the JAX package's module, so the two
  packages' peers understand each other);
- :func:`.client.parse_addr` — ``"host:port"`` to ``(host, port)``.

The elastic coordinator, its client and the elastic kvstore are not in
this release (ROADMAP Queue 1 item 5); ``MXNET_KV_ELASTIC`` raises at
``kvstore.create``.
"""
from .client import parse_addr
from .protocol import ProtocolError

__all__ = ["ProtocolError", "parse_addr"]

"""Address parsing for the elastic RPC substrate.

Counterpart of ``mxnet_tpu/elastic/client.py``, of which this release
carries :func:`parse_addr` alone: the fleet router and the wsync client
take their peers' addresses in its format. ``ElasticClient`` comes with
the elastic kvstore (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["parse_addr"]


def parse_addr(spec):
    """'host:port' -> (host, port). The MXNET_ELASTIC_COORD format."""
    host, sep, port = str(spec).rpartition(":")
    if not sep or not host:
        raise MXNetError(
            "elastic coordinator address must be host:port, got %r" % spec)
    try:
        return host, int(port)
    except ValueError:
        raise MXNetError(
            "elastic coordinator port must be an integer, got %r" % spec)

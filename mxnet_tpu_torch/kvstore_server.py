"""KVStore server bootstrap: the API-parity facade.

The port's copy of ``mxnet_tpu/kvstore_server.py`` (ref:
python/mxnet/kvstore_server.py:1-68). There is no server role: every
process is a worker, sums cross processes as ``torch.distributed``
all-reduces and the optimizer runs replicated on each worker
(``kvstore.KVStore._global_reduce_many``). The reference's entry points
stay so that launcher scripts and user code importing them keep working:

- ``KVStoreServer`` takes controller commands (the pickled-optimizer
  protocol) and applies them to the local kvstore;
- ``_init_kvstore_server_module()``, called from the package's
  ``__init__``, raises on a legacy ``DMLC_ROLE=server`` launch instead
  of leaving a silent process.
"""
from __future__ import annotations

import os
import pickle

from .base import MXNetError

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


class KVStoreServer:
    """ref: kvstore_server.py:24, the command handler."""

    def __init__(self, kvstore):
        self.kvstore = kvstore
        self.init_logging = False

    def _controller(self, cmd_id, cmd_body):
        """ref: kvstore_server.py:33: head 0 carries a pickled
        optimizer, installed as the server's updater would be."""
        if cmd_id == 0:
            if isinstance(cmd_body, str):
                cmd_body = cmd_body.encode("latin-1")
            optimizer = pickle.loads(cmd_body)
            self.kvstore.set_optimizer(optimizer)
        else:
            raise MXNetError("unknown server command %r" % (cmd_id,))

    def run(self):
        """The reference blocks in the ps-lite event loop here; with no
        server role there is nothing to run."""
        return


def _init_kvstore_server_module():
    """ref: kvstore_server.py:58: a legacy server-role launch fails
    loudly."""
    role = os.environ.get("DMLC_ROLE", "")
    if role == "server":
        raise MXNetError(
            "DMLC_ROLE=server: this framework has no parameter-server "
            "role — every process is a worker and gradients all-reduce "
            "over torch.distributed (launch with tools/torch_launch.py). "
            "Remove the server/scheduler entries from your cluster spec.")

"""mxwsync: gated live trainer→serving weight sync.

The bridge between the framework's two running halves: a
:class:`~.publisher.WeightPublisher` owns versioned full-precision
weight sets (fed by a trainer's in-process ``publish()`` hook or a
checkpoint-directory watcher over ``model.find_latest_checkpoint``) and
serves **per-tensor versioned deltas** over the elastic RPC substrate
(``elastic/protocol.py``). A :class:`~.subscriber.WeightSubscriber`
rides inside each serving process: it long-polls for new versions,
fetches only the tensors whose content fingerprint changed, stages them
into a host-side double buffer, runs the gates (shape/dtype hard
reject, guardian-style finiteness, a pluggable acceptance probe), and
asks the Engine to swap the staged set in **atomically between
scheduled steps** — target and draft params in one transaction, no
drain, no jit recompile.

Every version transition is journaled (``wsync.*`` counters plus
``{"kind": "wsync"}`` records sharing one trace id per transaction),
the Engine keeps a bounded ring of last-good versions, and mxctl's
``rollback_weights`` actuator restores the previous version when the
windowed quality rules (``spec_accept_rate``) fire.

Off by default: with ``MXNET_WSYNC`` unset nothing here starts — no
thread, no socket, no journal records (docs/how_to/weight_sync.md).
"""
from __future__ import annotations

import os

__all__ = ["enabled", "publisher_addr"]


def enabled():
    """Master switch (read live, like the other MXNET_* knobs)."""
    return os.environ.get("MXNET_WSYNC", "0").strip().lower() not in (
        "", "0", "false", "off", "no")


def publisher_addr():
    """``MXNET_WSYNC_PUBLISHER`` (host:port of the publisher), or None.
    With :func:`enabled` on and this set, every constructed serving
    Engine auto-starts a subscriber against it."""
    return os.environ.get("MXNET_WSYNC_PUBLISHER", "").strip() or None

"""The serving-side half of wsync: stage, gate, swap.

Counterpart of ``mxnet_tpu/wsync/subscriber.py``. A
:class:`WeightSubscriber` runs inside the serving process next to one
:class:`~..serving.engine.Engine`. Its loop long-polls the publisher,
and for each new version runs ONE transaction under one trace id:

1. **fetch** the version's manifest and every tensor whose content
   fingerprint differs from the subscriber's host cache (per-tensor
   deltas — unchanged tensors never cross the wire again);
2. **stage** the complete candidate set host-side as CPU tensors of
   each param's own dtype (the double buffer: the engine's live params
   are untouched while the candidate assembles, so a torn fetch aborts
   without a trace on the device);
3. **gate** — the pluggable acceptance probe here, then the engine's
   own hard gates (shape/dtype reject, guardian finiteness) inside
   :meth:`Engine.install_weights`;
4. **swap** — the engine copies the staged set onto its device, then
   installs target + draft params atomically between scheduled steps
   and pushes the outgoing version onto its last-good ring;
5. **ack** the outcome back to the publisher.

Anything that fails mid-transaction (publisher SIGKILL, retry budget
exhausted, a gate) leaves the engine byte-identical on its previous
version: partial application is structurally impossible because the
engine only ever sees complete staged sets.

``maybe_autosync`` is the off-by-default entry: Engine construction
calls it only when ``MXNET_WSYNC=1``, and it starts a thread only when
``MXNET_WSYNC_PUBLISHER`` names an address.
"""
from __future__ import annotations

import threading
import time

from .. import telemetry as _tel
from ..base import MXNetError
from . import common as _wc
from . import enabled as _enabled, publisher_addr as _pub_addr
from .client import WsyncClient

__all__ = ["WeightSubscriber", "maybe_autosync"]


class WeightSubscriber:
    """One engine's sync loop against one publisher.

    Parameters
    ----------
    engine : serving.engine.Engine
    addr : "host:port" or (host, port)
    rank : int
        Identity in the publisher's ack ledger.
    poll_wait : float, optional
        Long-poll budget per poll (``MXNET_WSYNC_POLL_WAIT``, default
        5.0 s; capped server-side at 25 s).
    accept : callable(version, params, draft_params) -> bool, optional
        The pluggable acceptance probe — an eval harness hook that
        refuses quality-regressed versions before they reach the
        engine. None accepts everything (the gates below still apply).
    """

    def __init__(self, engine, addr, rank=-1, poll_wait=None, accept=None):
        self.engine = engine
        self._client = WsyncClient(addr, rank=rank)
        if poll_wait is None:
            poll_wait = _wc.env_float("MXNET_WSYNC_POLL_WAIT", 5.0)
        self.poll_wait = max(0.0, float(poll_wait))
        self.accept = accept
        self._host = {}       # flat key -> CPU tensor of the applied set
        self._fps = {}        # flat key -> fingerprint of that array
        self._cursor = 0      # newest version attempted (applied OR not:
        self._stop = threading.Event()   # a rejected version must not
        self._thread = None              # re-fetch forever)
        #: the newest transaction that reached the engine: version,
        #: outcome, seconds, tensors and bytes fetched
        self.last = None

    @property
    def version(self):
        """Newest version applied to the engine by this subscriber."""
        return self.engine.weight_version()

    # -- one transaction -------------------------------------------------------
    def sync_once(self, wait=0.0):
        """One poll (+ transaction when a new version exists). Returns
        the applied version, or None."""
        resp = self._client.poll_version(self._cursor, wait=wait)
        v = int(resp.get("version", 0) or 0)
        if resp.get("status") != "ok" or v <= self._cursor:
            return None
        return self._transact(v)

    def _transact(self, version):
        trace = _tel.mint_trace() if _tel.ENABLED else None
        t0 = time.monotonic()
        candidate = {}
        fetched = fetched_bytes = 0
        try:
            manifest = self._client.fetch_manifest(version)["tensors"]
            for key in sorted(manifest):
                fp = manifest[key]["fp"]
                held = self._host.get(key)
                if held is not None and self._fps.get(key) == fp:
                    candidate[key] = held      # unchanged — delta skip
                    continue
                arr = _wc.from_wire(
                    self._client.fetch_tensor(version, key)["value"],
                    manifest[key]["dtype"])
                candidate[key] = arr
                fetched += 1
                fetched_bytes += int(arr.numel() * arr.element_size())
        except (MXNetError, ConnectionError, OSError) as e:
            # torn transaction: nothing staged reaches the engine
            self._cursor = max(self._cursor, version)
            if _tel.ENABLED:
                _tel.counter("wsync.aborted_total").inc()
            _wc.journal("aborted", version, trace=trace, reason=str(e),
                        fetched=fetched)
            self._ack(version, "aborted")
            return None
        self._cursor = max(self._cursor, version)
        if _tel.ENABLED:
            _tel.counter("wsync.tensors_fetched_total").inc(fetched)
            _tel.counter("wsync.bytes_fetched_total").inc(fetched_bytes)
        _wc.journal("staged", version, trace=trace, tensors=len(candidate),
                    fetched=fetched, bytes=fetched_bytes)
        target, draft = _wc.split_draft(candidate)
        params = _wc.unflatten_params(target)
        draft_params = _wc.unflatten_params(draft) if draft else None
        if self.accept is not None and not self.accept(version, params,
                                                       draft_params):
            if _tel.ENABLED:
                _tel.counter("wsync.rejected_total").inc()
            _wc.journal("rejected", version, trace=trace,
                        reason="acceptance-probe")
            self._ack(version, "rejected:acceptance-probe")
            return None
        self.last = {"version": version, "outcome": None,
                     "fetched": fetched, "bytes": fetched_bytes,
                     "secs": None}
        try:
            self.engine.install_weights(version, params, draft_params,
                                        trace=trace)
        except MXNetError as e:
            # the engine's gates counted + journaled the reject already
            self.last.update(outcome="rejected",
                             secs=time.monotonic() - t0)
            self._ack(version, "rejected:%s" % e)
            return None
        self._host = candidate
        self._fps = {k: manifest[k]["fp"] for k in manifest}
        secs = time.monotonic() - t0
        self.last.update(outcome="applied", secs=secs)
        if _tel.ENABLED:
            _tel.histogram("wsync.apply_secs").observe(secs)
        self._ack(version, "applied")
        return version

    def _ack(self, version, outcome):
        try:
            self._client.ack_version(version, outcome, check=False)
        except (MXNetError, ConnectionError, OSError):
            pass  # a dead publisher must not take the outcome path down

    # -- the loop --------------------------------------------------------------
    def run(self):
        while not self._stop.is_set():
            try:
                self.sync_once(wait=self.poll_wait)
            except (MXNetError, ConnectionError, OSError):
                # publisher down: back off, keep serving on the current
                # version — sync is strictly additive to availability
                self._stop.wait(min(1.0, self.poll_wait or 1.0))

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self.run,
                                            name="mx-wsync-sub",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def maybe_autosync(engine):
    """Start a subscriber for ``engine`` iff ``MXNET_WSYNC=1`` and
    ``MXNET_WSYNC_PUBLISHER`` is set; returns it (or None). The
    off-by-default contract lives here: unset env ⇒ no thread, no
    socket, no journal records."""
    if not _enabled():
        return None
    addr = _pub_addr()
    if not addr:
        return None
    return WeightSubscriber(engine, addr).start()

"""mxfleet: a fault-isolated serving fleet.

Counterpart of ``mxnet_tpu/serving/fleet/``. N replicas — each one
:class:`~..engine.Engine` in its own process (``replica.py``, ``python
-m mxnet_tpu_torch.serving.fleet.replica``) or in-process — behind a
health-routed front-end (``router.py``). Any replica is a disposable
fault domain: a SIGKILL costs redelivered requests (already-streamed
tokens folded into a recompute prefill on a survivor), never lost
streams. ``router.py`` is a copy of the JAX package's; the control
plane that reads its aggregate view (``control/``) is not in
this release (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

from .replica import ReplicaServer
from .router import FleetClient, FleetStream, Router

__all__ = ["ReplicaServer", "Router", "FleetClient", "FleetStream"]

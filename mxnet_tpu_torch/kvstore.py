"""KVStore: key-value synchronisation of parameters across devices and
processes.

Counterpart of ``mxnet_tpu/kvstore.py`` (``KVStore``, ``create``), with
the same semantics:

- ``init`` stores a copy of each value under its key (a duplicate init
  raises);
- ``push`` groups the values by key, reduces each group (a sum onto the
  first value's device, in list order: the first value, then the others),
  then either stores the sum or calls the updater
  ``updater(key, merged, stored)``;
- ``pull`` writes the stored value into every destination array, in
  place: the arrays an executor bound are the ones it reads next;
- ``set_optimizer`` installs ``optimizer.get_updater`` after a pickle
  round trip (an unpicklable optimizer fails here, as in the JAX
  package).

The store owns its storage: ``init`` copies, and a push of one value
stores a copy, so an executor writing its gradient tensor in place on the
next backward cannot change what the store holds. A reduce never adds
into a pushed value.

Types are the JAX package's (``create``). ``local``, ``device`` and the
other in-process types reduce with torch adds, the copies between cards
ordered by torch on the streams of both devices. The ``dist`` types in
one process keep local semantics. In several processes (the launcher's
``MXNET_COORDINATOR``, ``MXNET_NUM_PROCS`` and ``MXNET_PROC_ID``, set by
``tools/torch_launch.py``) the store joins a ``torch.distributed``
process group at creation and each push's local sums cross processes as
all-reduces: float32, float16 and bfloat16 keys of one context fuse into
float32 buckets of ``_BUCKET_BYTES`` (``MXNET_KVSTORE_BUCKET_BYTES``, 64
MiB), integer and float64 keys take one all-reduce each. Every process
then runs the updater on the same sum, so the weights stay replicated.

The backend is chosen up front, by one rule: when CUDA is visible and
the host has a card for every rank, ``cpu:gloo,cuda:nccl`` (NCCL for
tensors on the cards, gloo for host tensors), and rank ``r`` works on
``cuda:r``; otherwise ``gloo``, whose reduces of card tensors are staged
through host memory here. A failed init raises; nothing retries with
another backend. ``backend()`` says which one ran.

``guardian_vote`` is the training guardian's group skip verdict: the
local verdict on one process, and on ``dist_sync`` in several processes
one all-reduce (max) of the flag over the process group, so a step
poisoned on any rank is skipped on every rank. Telemetry
(``MXNET_TELEMETRY=1``) counts as the JAX package's store does:
``kvstore.push_total``/``push_bytes_total``, ``pull_total``/
``pull_bytes_total``, ``wire_bytes_total``/``logical_bytes_total`` and
the ``compression_ratio`` gauge of the fused all-reduces (1.0: no
quantized wire), and the ``barrier_wait_secs`` histogram.

Not ported, each raising ``MXNetError`` where the port meets it: the
asynchronous dist server (``dist_async`` in several processes warns and
keeps synchronous semantics, as the JAX package does without its
transport), the elastic store (``MXNET_KV_ELASTIC``, and with it its
vote), the sharded update (``MXNET_KV_SHARD_UPDATE``), the quantized
wire (``MXNET_KV_QUANTIZE``), heartbeats and their readers
(``dead_ranks``, ``MXNET_KV_BARRIER_TIMEOUT``).
"""
from __future__ import annotations

import os
import pickle
import time
import warnings
from datetime import timedelta

import torch

from . import telemetry as _tel
from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "create", "backend"]

# gradient dtypes that fuse into one float32 bucket (the JAX package's
# _FUSABLE_DTYPES): half-precision keys are summed in float32
_FUSABLE_DTYPES = (torch.float32, torch.float16, torch.bfloat16)

_KNOWN = (
    "local", "local_allreduce_cpu", "local_allreduce_device", "device",
    "dist", "dist_sync", "dist_async", "dist_sync_device", "dist_async_device",
)

# what the port does not carry over of the JAX store: env knob -> name
_UNPORTED_DIST_KNOBS = (
    ("MXNET_KV_ELASTIC", "the elastic store"),
    ("MXNET_KV_SHARD_UPDATE", "the sharded update (ZeRO-1)"),
    ("MXNET_KV_QUANTIZE", "the quantized wire"),
    ("MXNET_KV_BARRIER_TIMEOUT", "barrier deadlines over heartbeats"),
)


def _nd_bytes(arr):
    """Payload size of one NDArray (telemetry byte counters)."""
    t = arr._data
    return t.numel() * t.element_size()


def _env_on(name):
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "off", "no")


def _dist():
    import torch.distributed as dist

    return dist


def _world():
    """(rank, world size) of the process group, (0, 1) without one."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _backend_rule(nprocs):
    """The backend for ``nprocs`` local ranks: NCCL for card tensors
    when every rank has a card of its own, else gloo."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= nprocs:
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def backend():
    """The process group's backend string, or None in one process."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return _BACKEND[0] or str(dist.get_backend())
    return None


_BACKEND = [None]


def _maybe_init_distributed():
    """Join the launcher's process group (``MXNET_COORDINATOR``,
    ``MXNET_NUM_PROCS``, ``MXNET_PROC_ID``; the JAX package's
    ``_maybe_init_distributed``). No-op in one process or once joined."""
    nprocs = int(os.environ.get("MXNET_NUM_PROCS", "1"))
    if nprocs <= 1:
        return
    dist = _dist()
    if not dist.is_available():
        raise MXNetError("MXNET_NUM_PROCS=%d but this torch has no "
                         "torch.distributed" % nprocs)
    if dist.is_initialized():
        return
    rank = int(os.environ.get("MXNET_PROC_ID", "0"))
    chosen = _backend_rule(nprocs)
    if chosen != "gloo":
        torch.cuda.set_device(rank)
    addr = os.environ.get("MXNET_COORDINATOR", "127.0.0.1:9876")
    dist.init_process_group(chosen, init_method="tcp://" + addr,
                            world_size=nprocs, rank=rank,
                            timeout=timedelta(seconds=300))
    _BACKEND[0] = chosen


class KVStore:
    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._barrier_count = 0

    # -- identity --------------------------------------------------------------
    @property
    def rank(self):
        return _world()[0] if self.type.startswith("dist") else 0

    @property
    def num_workers(self):
        return _world()[1] if self.type.startswith("dist") else 1

    def _multi_process(self):
        return self.type.startswith("dist") and _world()[1] > 1

    # -- init/push/pull --------------------------------------------------------
    def init(self, key, value):
        """Store a copy of each value (ref: python/mxnet/kvstore.py:55)."""
        keys, values = self._key_value(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                raise MXNetError("duplicate init of key %s" % k)
            self._store[k] = v.copyto(v.context)

    def push(self, key, value, priority=0):
        """Reduce each key's values, then store or update
        (ref: python/mxnet/kvstore.py:102; kvstore_local.h:49)."""
        keys, values = self._key_value(key, value)
        grouped = {}
        order = []
        for k, v in zip(keys, values):
            if k not in grouped:
                grouped[k] = []
                order.append(k)
            if isinstance(v, (list, tuple)):
                grouped[k].extend(v)
            else:
                grouped[k].append(v)
        merged_list = []
        for k in order:
            if k not in self._store:
                raise MXNetError("key %s has not been inited" % k)
            merged_list.append(self._reduce(grouped[k]))
        if _tel.ENABLED:
            _tel.counter("kvstore.push_total").inc()
            _tel.counter("kvstore.push_bytes_total").inc(
                sum(_nd_bytes(m) for m in merged_list))
        merged_list = self._global_reduce_many(merged_list)
        for k, merged in zip(order, merged_list):
            stored = self._store[k]
            if self._updater is not None:
                if merged.context != stored.context:
                    merged = merged.copyto(stored.context)
                self._updater(_key_int(k), merged, stored)
            else:
                self._store[k] = merged

    def pull(self, key, out=None, priority=0):
        """Write the stored value into each destination array
        (ref: python/mxnet/kvstore.py:168)."""
        assert out is not None
        keys, outs = self._key_value(key, out)
        for k, o in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %s has not been inited" % k)
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                self._store[k].copyto(t)
        if _tel.ENABLED:
            _tel.counter("kvstore.pull_total").inc()
            _tel.counter("kvstore.pull_bytes_total").inc(sum(
                _nd_bytes(self._store[k])
                * (len(o) if isinstance(o, (list, tuple)) else 1)
                for k, o in zip(keys, outs)))

    @staticmethod
    def _reduce(vals):
        """Sum onto the first value's device in list order (the
        CommDevice/CommCPU reduce, src/kvstore/comm.h), into fresh
        storage: one value is copied, several are added out of place."""
        dev = vals[0].context
        acc = vals[0]._data
        if len(vals) == 1:
            return NDArray(acc.clone(), dev)
        target = acc.device
        for v in vals[1:]:
            acc = acc + v._data.to(target)
        return NDArray(acc, dev)

    # -- the cross-process reduce ------------------------------------------
    @property
    def _BUCKET_BYTES(self):
        """Bucket size of the fused all-reduces, in float32 bytes; read
        per use (``MXNET_KVSTORE_BUCKET_BYTES``)."""
        return int(os.environ.get("MXNET_KVSTORE_BUCKET_BYTES",
                                  64 * 1024 * 1024))

    @staticmethod
    def _all_reduce(t):
        """Sum ``t`` over the processes, in place. A card tensor under
        plain gloo goes through host memory."""
        dist = _dist()
        if t.is_cuda and _BACKEND[0] in (None, "gloo"):
            host = t.cpu()
            dist.all_reduce(host)
            t.copy_(host)
        else:
            dist.all_reduce(t)
        return t

    def _global_reduce(self, merged):
        """One key across processes (``merged`` is the store's own fresh
        sum, so it is reduced in place)."""
        self._all_reduce(merged._data)
        return merged

    def _global_reduce_many(self, merged_list):
        """The push's sums across processes: float32/float16/bfloat16
        keys of one context fused into float32 buckets, one all-reduce
        a bucket, split back and cast to each key's dtype; integer and
        float64 keys one all-reduce each (the JAX package's
        ``_global_reduce_many`` without its quantized wire)."""
        if not self._multi_process():
            return merged_list
        out = [None] * len(merged_list)
        groups = {}
        for idx, m in enumerate(merged_list):
            if m._data.dtype in _FUSABLE_DTYPES:
                groups.setdefault(str(m.context), []).append(idx)
            else:
                out[idx] = self._global_reduce(m)
        bucket_bytes = self._BUCKET_BYTES
        logical_bytes = 0
        for idxs in groups.values():
            buckets, cur, cur_bytes = [], [], 0
            for idx in idxs:
                nbytes = merged_list[idx]._data.numel() * 4
                if cur and cur_bytes + nbytes > bucket_bytes:
                    buckets.append(cur)
                    cur, cur_bytes = [], 0
                cur.append(idx)
                cur_bytes += nbytes
            if cur:
                buckets.append(cur)
            for bucket in buckets:
                parts = [merged_list[i] for i in bucket]
                if len(bucket) == 1 and parts[0]._data.dtype == torch.float32:
                    out[bucket[0]] = self._global_reduce(parts[0])
                    continue
                flat = torch.cat([p._data.float().reshape(-1)
                                  for p in parts])
                self._all_reduce(flat)
                logical_bytes += flat.numel() * 4
                off = 0
                for i, p in zip(bucket, parts):
                    n = p._data.numel()
                    piece = flat[off:off + n].reshape(p._data.shape)
                    out[i] = NDArray(piece.to(p._data.dtype), p.context)
                    off += n
        if _tel.ENABLED and logical_bytes:
            self._account_wire(logical_bytes, logical_bytes)
        return out

    def _account_wire(self, wire, logical):
        """Fold one transfer into the ``kvstore.wire_bytes_total`` /
        ``kvstore.logical_bytes_total`` counters and the running
        ``kvstore.compression_ratio`` gauge (the JAX package's
        ``_account_wire``; the port's wire is never quantized)."""
        self._wire_total = getattr(self, "_wire_total", 0) + int(wire)
        self._logical_total = getattr(self, "_logical_total", 0) + \
            int(logical)
        _tel.counter("kvstore.wire_bytes_total").inc(int(wire))
        _tel.counter("kvstore.logical_bytes_total").inc(int(logical))
        _tel.gauge("kvstore.compression_ratio").set(
            self._wire_total / float(self._logical_total))

    # -- optimizer/updater -----------------------------------------------------
    def set_optimizer(self, optimizer):
        """The updater of ``optimizer`` runs on every push's sum; the
        pickle round trip fails early on an unpicklable optimizer
        (ref: python/mxnet/kvstore.py:231)."""
        from . import optimizer as opt

        pickle.loads(pickle.dumps(optimizer))
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def _set_updater(self, updater):
        """ref: python/mxnet/kvstore.py:255."""
        self._updater = updater

    set_updater = _set_updater

    # -- cluster control -------------------------------------------------------
    def barrier(self):
        """A rendezvous of every process (a one-element host all-reduce,
        which gloo carries under either backend); a no-op in one."""
        self._barrier_count += 1
        if self._multi_process():
            if _tel.ENABLED:
                t0 = time.monotonic()
                try:
                    _dist().all_reduce(torch.zeros(1))
                finally:
                    _tel.histogram("kvstore.barrier_wait_secs").observe(
                        time.monotonic() - t0)
            else:
                _dist().all_reduce(torch.zeros(1))

    def send_command_to_servers(self, head, body):
        """ref: kvstore.py:318. There are no server processes; head 0
        (a pickled optimizer) applies locally, or goes to a controller a
        ``KVStoreServer`` installed."""
        ctrl = getattr(self, "_server_controller", None)
        if ctrl is not None:
            ctrl(head, body)
            return
        if head == 0:
            if isinstance(body, str):
                body = body.encode("latin-1")
            self.set_optimizer(pickle.loads(body))

    @property
    def barrier_before_exit(self):
        return getattr(self, "_barrier_before_exit", True)

    def dead_ranks(self, timeout=None):
        raise MXNetError("dead_ranks: the store's heartbeats are not "
                         "ported")

    def guardian_vote(self, step, poisoned):
        """Group skip verdict for one optimizer step (the training-run
        guardian's coordinated skip, ``mxnet_tpu/kvstore.py:783-835``).
        True when ANY rank voted poisoned — every rank then skips the
        same step, so replicas never diverge. A store of one process
        answers with the local verdict; ``dist`` types in several
        processes take one all-reduce (max) of the flag over the
        process group, a host tensor, which gloo carries under either
        backend. Every rank must call it once a step, as the JAX
        package's rounds require. The elastic store, whose vote rides
        its coordinator, is not ported: ``MXNET_KV_ELASTIC`` raises at
        :func:`create`."""
        if not self._multi_process():
            return bool(poisoned)
        dist = _dist()
        flag = torch.tensor([1.0 if poisoned else 0.0])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item() > 0)

    def save_optimizer_states(self, fname):
        assert self._optimizer is not None
        with open(fname, "wb") as f:
            f.write(pickle.dumps(self._optimizer))

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            self.set_optimizer(pickle.loads(f.read()))

    # -- helpers ---------------------------------------------------------------
    @staticmethod
    def _key_value(key, value):
        if isinstance(key, (int, str)):
            return [key], [value]
        assert isinstance(key, (list, tuple))
        if len(key) != len(value):
            raise MXNetError("mismatched key/value lengths")
        return list(key), list(value)


def _key_int(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


def create(name="local"):
    """A KVStore of type ``name`` (ref: python/mxnet/kvstore.py:349):
    local / local_allreduce_cpu / local_allreduce_device / device /
    dist / dist_sync / dist_async / dist_sync_device / dist_async_device.
    A dist type joins the launcher's process group first."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _KNOWN:
        raise MXNetError("unknown KVStore type %s (known: %s)"
                         % (name, _KNOWN))
    if name.startswith("dist"):
        for knob, what in _UNPORTED_DIST_KNOBS:
            if _env_on(knob):
                raise MXNetError("%s: %s is not ported; unset it"
                                 % (knob, what))
        _maybe_init_distributed()
        if name.startswith("dist_async") and _world()[1] > 1:
            warnings.warn(
                "dist_async: the asynchronous server is not ported; "
                "updates run in lock-step (synchronous all-reduce "
                "semantics)", stacklevel=2)
    return KVStore(name)

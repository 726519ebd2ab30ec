"""Shared wsync plumbing: param flattening, fingerprints, gates,
checkpoint round-trip, the ``{"kind": "wsync"}`` journal record, and
the port's two-way conversion between wire arrays and tensors.

Counterpart of ``mxnet_tpu/wsync/common.py``. The wire unit is a *flat*
param set — ``{"embed": t, "layers/0/wqkv": t, ...}`` with the draft
model's tensors under a ``draft/`` prefix — so the publisher can
manifest, fingerprint, and serve tensors individually (per-tensor
deltas). Weights cross the wire at full precision always: a hot-swapped
engine decodes byte-identically to a cold engine built on the same
version.

**bfloat16.** numpy has no bfloat16, so the port never upcasts one:

- on the host and in the publisher's store a param is a CPU tensor of
  its own dtype;
- on the wire (:func:`to_wire`) a bf16 tensor is the ``uint16`` array of
  its raw bit patterns, and :func:`from_wire` rebuilds it with
  ``.view(torch.bfloat16)``; every other dtype is its numpy array, as
  in the JAX package. Payloads are numpy arrays and Python values only;
- :func:`fingerprint`, :func:`manifest_of` and :func:`param_manifest`
  name a bf16 tensor with ``"<V2"``, the string the JAX package's numpy
  gives ``ml_dtypes.bfloat16``, and hash its raw bytes, so a manifest of
  either package names the same tensors as changed for the same bits.

:func:`nonfinite_keys` checks every floating tensor, bf16 included (the
JAX package's ``np.issubdtype`` test skips ``ml_dtypes.bfloat16``).
"""
from __future__ import annotations

import os
import time
import zlib

import numpy as np
import torch

from .. import telemetry as _tel
from ..base import MXNetError

__all__ = ["flatten_params", "unflatten_params", "split_draft",
           "combine_draft", "fingerprint", "manifest_of", "param_manifest",
           "nonfinite_keys", "save_weights_checkpoint",
           "load_weights_checkpoint", "journal", "env_float", "to_wire",
           "from_wire", "host_tensor", "dtype_str", "BF16_STR"]

#: flat-key prefix carrying the draft model's tensors inside one
#: version (one checkpoint file, one transaction — target and draft
#: can never tear apart)
DRAFT_PREFIX = "draft/"

#: numpy's dtype string for ``ml_dtypes.bfloat16``: the JAX package's
#: manifests and fingerprints name a bf16 tensor with it
BF16_STR = "<V2"


def env_float(name, default):
    raw = os.environ.get(name, "").strip()
    if not raw:
        return float(default)
    try:
        return float(raw)
    except ValueError:
        raise MXNetError("%s must be a number, got %r" % (name, raw))


# -- flat param sets -----------------------------------------------------------

def flatten_params(tree, prefix="", out=None):
    """A params tree (nested dict/list/tuple of tensors or arrays) as one
    flat ``{path: leaf}`` dict with ``/``-joined, sorted-key paths. A
    dict that is already flat round-trips unchanged (leaves are kept
    as-is — no copy is made here)."""
    if out is None:
        out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            flatten_params(tree[k], "%s%s/" % (prefix, k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flatten_params(v, "%s%d/" % (prefix, i), out)
    else:
        out[prefix[:-1]] = tree
    return out


def unflatten_params(flat):
    """Inverse of :func:`flatten_params`: rebuild the nested tree (path
    components that are all decimal become a dense list)."""
    root = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def build(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            idx = sorted(int(k) for k in keys)
            if idx != list(range(len(idx))):
                raise MXNetError("non-dense list indices in flat params: %r"
                                 % sorted(keys))
            return [build(node[str(i)]) for i in idx]
        return {k: build(v) for k, v in node.items()}

    return build(root)


def split_draft(flat):
    """``(target_flat, draft_flat_or_None)`` from one combined flat set
    (the ``draft/`` prefix is the draft half)."""
    target, draft = {}, {}
    for k, v in flat.items():
        if k.startswith(DRAFT_PREFIX):
            draft[k[len(DRAFT_PREFIX):]] = v
        else:
            target[k] = v
    return target, (draft or None)


def combine_draft(params, draft_params=None):
    """One flat set from a target tree plus an optional draft tree
    (draft keys under ``draft/``)."""
    flat = flatten_params(params)
    if draft_params is not None:
        for k, v in flatten_params(draft_params).items():
            flat[DRAFT_PREFIX + k] = v
    return flat


# -- tensors, host arrays and the wire -----------------------------------------

def dtype_str(x):
    """numpy's dtype string of a tensor's or array's dtype, ``"<V2"`` for
    bfloat16 (as numpy names ``ml_dtypes.bfloat16``)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return BF16_STR
        return torch.empty((), dtype=x.dtype).numpy().dtype.str
    return np.dtype(getattr(x, "dtype", np.float32)).str


def host_tensor(x):
    """A CPU tensor of ``x``'s dtype holding a copy of its values: a
    tensor is detached and copied off its device; a numpy array (an
    ``ml_dtypes.bfloat16`` one too) becomes a tensor of its dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).contiguous()
    a = np.asarray(x)
    if a.dtype.str == BF16_STR:
        return torch.from_numpy(
            np.array(a.view(np.int16), copy=True)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _raw(x):
    """``(dtype string, shape, contiguous numpy bytes)`` of a tensor or
    array: a bf16 tensor's bytes are its raw 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        shape = tuple(int(d) for d in t.shape)
        if t.dtype == torch.bfloat16:
            return BF16_STR, shape, t.view(torch.int16).numpy()
        return dtype_str(t), shape, t.numpy()
    a = np.asarray(x)
    return a.dtype.str, a.shape, np.ascontiguousarray(a)


def to_wire(x):
    """The numpy array a tensor crosses the wire as: a bf16 tensor's raw
    bit patterns as ``uint16``, anything else its own dtype."""
    _, shape, a = _raw(x)
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return a.view(np.uint16).reshape(shape)
    return a.reshape(shape)


def from_wire(arr, dtype=None):
    """The CPU tensor for a wire array; ``dtype`` is the manifest's dtype
    string (``"<V2"``: ``arr`` carries bf16 bit patterns as ``uint16``,
    or is an ``ml_dtypes.bfloat16`` array from the JAX package)."""
    a = np.asarray(arr)
    if dtype == BF16_STR or a.dtype.str == BF16_STR:
        if a.dtype.itemsize != 2:
            raise MXNetError("bf16 wire array has dtype %s" % a.dtype)
        return torch.from_numpy(
            np.array(a.view(np.int16), copy=True)).view(torch.bfloat16)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, copy=True)
    return torch.from_numpy(a)


# -- manifests and gates -------------------------------------------------------

def fingerprint(arr):
    """Content fingerprint of one tensor or array (crc32 over
    dtype/shape/bytes, the JAX package's formula) — what makes the
    version stream *delta*-transferable: a subscriber skips every
    tensor whose fingerprint it already holds."""
    dt, shape, a = _raw(arr)
    # the JAX package hashes the shape of np.ascontiguousarray(arr),
    # which makes a 0-d array 1-d
    h = zlib.crc32(("%s:%r" % (dt, shape or (1,))).encode())
    return zlib.crc32(a.tobytes(), h) & 0xFFFFFFFF


def manifest_of(flat):
    """Per-tensor wire manifest: ``{path: {"shape", "dtype", "fp"}}``."""
    out = {}
    for k, v in flat.items():
        dt, shape, _ = _raw(v)
        out[k] = {"shape": tuple(int(d) for d in shape), "dtype": dt,
                  "fp": fingerprint(v)}
    return out


def param_manifest(tree):
    """Shape/dtype map of a tree WITHOUT copying device tensors to the
    host — the Engine-side half of the hard shape/dtype gate (a sync
    never changes the shapes the engine's buffers were sized for)."""
    out = {}
    for k, v in flatten_params(tree).items():
        shape = v.shape if isinstance(v, torch.Tensor) else np.shape(v)
        out[k] = (tuple(int(d) for d in shape), dtype_str(v))
    return out


def nonfinite_keys(flat):
    """Paths of floating tensors (bf16 included) holding a non-finite
    value — the guardian's finiteness discipline applied to a staged
    weight set. One host read for all of a device's tensors."""
    keys, flags = [], []
    for k, v in flat.items():
        t = v if isinstance(v, torch.Tensor) else host_tensor(v)
        if t.is_floating_point():
            keys.append(k)
            flags.append(torch.isfinite(t.detach()).all())
    if not flags:
        return []
    by_dev = {}
    for k, f in zip(keys, flags):
        by_dev.setdefault(f.device, []).append((k, f))
    bad = set()
    for pairs in by_dev.values():
        ok = torch.stack([f for _, f in pairs]).cpu().tolist()
        bad.update(k for (k, _), good in zip(pairs, ok) if not good)
    return [k for k in keys if k in bad]


# -- checkpoint round-trip -----------------------------------------------------

def save_weights_checkpoint(prefix, epoch, params, draft_params=None):
    """Write ``<prefix>-NNNN.params`` holding the combined flat set
    (draft under ``draft/``) via the crash-safe atomic writer — the
    file a :class:`~.publisher.CheckpointWatcher` picks up with
    ``model.find_latest_checkpoint``; bytes equal to the JAX package's
    for the same values, bf16 included. Returns the path."""
    from ..model import _write_params_atomic

    path = "%s-%04d.params" % (prefix, int(epoch))
    flat = combine_draft(params, draft_params)
    _write_params_atomic(path, {k: host_tensor(v) for k, v in flat.items()})
    return path


def load_weights_checkpoint(prefix, epoch):
    """``(params, draft_params_or_None)`` trees of CPU tensors (bf16
    kept) from one epoch's weights checkpoint."""
    from ..ndarray import load as nd_load

    path = "%s-%04d.params" % (prefix, int(epoch))
    flat = {k: v._data for k, v in nd_load(path).items()}
    target, draft = split_draft(flat)
    return (unflatten_params(target),
            unflatten_params(draft) if draft else None)


# -- journal -------------------------------------------------------------------

def journal(event, version, trace=None, **fields):
    """One ``{"kind": "wsync"}`` journal record (no-op with telemetry
    off — the off-by-default contract). Every record of one sync
    transaction shares the trace id minted at transaction start."""
    if not _tel.ENABLED:
        return
    from ..telemetry import export as _export

    rec = {"kind": "wsync", "event": event, "version": version,
           "t": time.time(), "trace": trace}
    rec.update(fields)
    _export.emit(rec)

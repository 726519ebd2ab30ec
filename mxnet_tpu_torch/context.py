"""Device context over ``torch.device``.

Counterpart of ``mxnet_tpu/context.py``: ``gpu(i)`` is
``torch.device("cuda", i)`` and ``cpu()`` the host. The default device
is ``cuda:0``. There is no CPU fallback: resolving the default device,
or any ``gpu(i)``, on a machine without CUDA raises, so a program never
carries on on the CPU when it meant the card. Tests pass
``device="cpu"`` explicitly.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context",
           "num_devices", "resolve_device"]


class Context:
    """Device context; works as a with-scope that sets the default
    device for entry points called inside the block."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}

    _default = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if isinstance(device_type, str):
                device_type = self.devstr2type[device_type]
            self.device_typeid = device_type
            self.device_id = device_id

    @property
    def device_type(self):
        return self.devtype2str[self.device_typeid]

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    @property
    def torch_device(self):
        """The ``torch.device`` this context denotes; raises for a GPU
        context when CUDA is missing or the id is out of range."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        n = num_devices("gpu")
        if self.device_id >= n:
            raise MXNetError(
                "%s: no such CUDA device (%d visible)" % (self, n))
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        if not hasattr(Context._default, "stack"):
            Context._default.stack = []
        Context._default.stack.append(self)
        return self

    def __exit__(self, ptype, value, trace):
        Context._default.stack.pop()


def cpu(device_id=0):
    """The host."""
    return Context(1, device_id)


def gpu(device_id=0):
    """The ``device_id``-th CUDA device."""
    return Context(2, device_id)


def cpu_pinned(device_id=0):
    """Pinned-host context (ref: include/mxnet/base.h:90): host memory,
    kept so reference scripts parse, as in the JAX package."""
    return Context(3, device_id)


def current_context():
    """The innermost ``with`` context, else the process default:
    ``gpu(0)`` unless ``test_utils.set_default_context`` set another."""
    stack = getattr(Context._default, "stack", None)
    if stack:
        return stack[-1]
    return getattr(Context, "_default_bottom", None) or gpu(0)


def num_devices(device_type="gpu"):
    if device_type == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def resolve_device(device=None):
    """``None`` -> the current context (``cuda:0`` by default); a
    Context, string or ``torch.device`` -> that device. A CUDA device
    on a machine without CUDA raises."""
    if device is None:
        device = current_context()
    if isinstance(device, Context):
        return device.torch_device
    device = torch.device(device)
    if device.type == "cuda":
        return gpu(device.index or 0).torch_device
    return device

"""Device mesh, one device for now.

Counterpart of ``mxnet_tpu/parallel/mesh.py``: a :class:`Mesh` names its
axes and gives their sizes through ``.shape``, which is all the
context-parallel serving path reads. Only a one-device mesh exists in
this release; asking for more devices raises until the multi-GPU slice
(ROADMAP queue 1, multi-GPU mesh over NCCL) lands.
"""
from __future__ import annotations

from ..context import resolve_device

__all__ = ["Mesh", "create_mesh", "axis_size"]

_MULTI = ("multi-device meshes are not ported yet: ROADMAP queue 1, "
          "multi-GPU mesh, ring and Ulysses over NCCL")


class Mesh:
    """Named axes over one device. ``shape`` maps axis name -> size."""

    def __init__(self, device, axis_names, axis_sizes):
        if len(axis_names) != len(axis_sizes):
            raise ValueError("mesh: %d axis names for %d sizes"
                             % (len(axis_names), len(axis_sizes)))
        if any(int(s) != 1 for s in axis_sizes):
            raise NotImplementedError(_MULTI)
        self.device = device
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))

    @property
    def size(self):
        return 1

    def __repr__(self):
        return "Mesh(%r, device=%s)" % (self.shape, self.device)


def create_mesh(shape, axis_names, devices=None):
    """Mesh of the given logical shape, e.g. ``create_mesh((1,),
    ("seq",))``. ``devices`` is a one-element list of devices (default:
    the current device, ``cuda:0``); any shape whose product is not 1
    raises ``NotImplementedError``."""
    if devices is not None and len(devices) != 1:
        raise NotImplementedError(_MULTI)
    device = resolve_device(devices[0] if devices is not None else None)
    return Mesh(device, axis_names, shape)


def axis_size(mesh, axis_name):
    """Size of ``axis_name`` in ``mesh``."""
    return mesh.shape[axis_name]

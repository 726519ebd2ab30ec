"""Context-parallel attention and the mesh, at one device."""
from __future__ import annotations

from .mesh import Mesh, axis_size, create_mesh
from .ring_attention import make_ring_attention, ring_attention
from .ulysses import make_ulysses_attention, ulysses_attention

__all__ = ["Mesh", "axis_size", "create_mesh", "make_ring_attention",
           "ring_attention", "make_ulysses_attention", "ulysses_attention"]

"""Context-parallel attention, the mesh and the trainers, at one device."""
from __future__ import annotations

from .mesh import Mesh, axis_size, create_mesh
from .ring_attention import make_ring_attention, ring_attention
from .trainer import ShardedTrainer, data_parallel_spec, make_train_step
from .ulysses import make_ulysses_attention, ulysses_attention

__all__ = ["Mesh", "axis_size", "create_mesh", "make_ring_attention",
           "ring_attention", "make_ulysses_attention", "ulysses_attention",
           "ShardedTrainer", "data_parallel_spec", "make_train_step"]

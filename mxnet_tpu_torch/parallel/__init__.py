"""Context-parallel attention, the mesh, the trainers (the LM's, the
fused Symbol train step and the scanned fit's), at one device."""
from __future__ import annotations

from .mesh import Mesh, axis_size, create_mesh
from .ring_attention import make_ring_attention, ring_attention
from .trainer import ShardedTrainer, data_parallel_spec, make_train_step
from .ulysses import make_ulysses_attention, ulysses_attention
from .symbol_trainer import make_symbol_train_step
from .fit_trainer import FitTrainer, make_fit_trainer, supports_optimizer

__all__ = ["Mesh", "axis_size", "create_mesh", "make_ring_attention",
           "ring_attention", "make_ulysses_attention", "ulysses_attention",
           "ShardedTrainer", "data_parallel_spec", "make_train_step",
           "make_symbol_train_step", "FitTrainer", "make_fit_trainer",
           "supports_optimizer"]

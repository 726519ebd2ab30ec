"""Model definitions of the port."""
from __future__ import annotations

from . import transformer

__all__ = ["transformer"]

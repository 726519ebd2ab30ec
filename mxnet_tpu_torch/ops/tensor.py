"""Elementwise binary and array-scalar ops: the subset that Symbol and
NDArray arithmetic emit.

Counterpart of ``mxnet_tpu/ops/tensor.py:41-60``, with the same names,
aliases and parameters (``scalar``, a float), computed with torch. The
JAX package's unary, reduction, broadcast and matrix ops are a later
slice.
"""
from __future__ import annotations

import torch

from .registry import scalar_op, simple_binary

simple_binary("_plus", torch.add, aliases=("_add", "elemwise_add"))
simple_binary("_minus", torch.sub, aliases=("_sub",))
simple_binary("_mul", torch.mul)
simple_binary("_div", torch.div)
simple_binary("_power", torch.pow)
simple_binary("_maximum", torch.maximum)
simple_binary("_minimum", torch.minimum)

scalar_op("_plus_scalar", lambda x, s: x + s)
scalar_op("_minus_scalar", lambda x, s: x - s)
scalar_op("_rminus_scalar", lambda x, s: s - x)
scalar_op("_mul_scalar", lambda x, s: x * s)
scalar_op("_div_scalar", lambda x, s: x / s)
scalar_op("_rdiv_scalar", lambda x, s: s / x)
scalar_op("_power_scalar", lambda x, s: torch.pow(x, s))
scalar_op("_rpower_scalar", lambda x, s: torch.pow(s, x))
scalar_op("_maximum_scalar", lambda x, s: torch.clamp(x, min=s))
scalar_op("_minimum_scalar", lambda x, s: torch.clamp(x, max=s))

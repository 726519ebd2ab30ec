"""Kernels and operators of the port.

Kernels, each beside its plain PyTorch version:

- :mod:`.flash_attention` — flash attention: the forward (Hopper CUDA
  kernel ``csrc/flash_fwd.cu``), the backward (``csrc/flash_bwd.cu``),
  their plain versions and the ``FlashAttention`` autograd function.
- :mod:`.softmax` — the row softmax (``csrc/softmax.cu``) under
  SoftmaxOutput.
- :mod:`.matmul_stats` — a bf16 matmul whose epilogue also sums each
  output column and its square (``csrc/matmul_stats.cu``), run by
  ``tools/torch_probe_matmul_stats.py``.

The operator registry of the Symbol path: importing this package
registers the ops of :mod:`.tensor`, :mod:`.nn`, :mod:`.loss`,
:mod:`.sequence` and :mod:`.vision`;
:func:`install` then exposes each as an imperative NDArray function and
a Symbol constructor, each with the docstring :func:`.opdoc.build_doc`
renders, as ``mxnet_tpu/ops/__init__.py:27-60`` does.
"""
from __future__ import annotations

import torch

from . import registry
from .registry import REGISTRY, Field, OpDef, get, list_ops, register

# importing these modules registers the ops
from . import tensor  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import sequence  # noqa: F401
from . import vision  # noqa: F401

# prose docs attach inside register(); build_doc renders them per
# wrapper, as in the JAX package
from .opdoc import build_doc

__all__ = ["REGISTRY", "Field", "OpDef", "get", "list_ops", "register",
           "install"]


def _make_imperative(op):
    def fn(*args, **kwargs):
        from .. import random as _random
        from ..context import current_context
        from ..ndarray import NDArray, _as_tensor

        out = kwargs.pop("out", None)
        ctx = None
        inputs = []
        extra_scalars = []
        for a in args:
            if isinstance(a, NDArray):
                if ctx is None:
                    ctx = a.context
                inputs.append(a)
            elif isinstance(a, (int, float)) and "scalar" in op.param_fields:
                extra_scalars.append(a)
            else:
                inputs.append(a)
        if extra_scalars and "scalar" not in kwargs:
            kwargs["scalar"] = extra_scalars[0]
        params = op.parse_params(kwargs)
        ctx = ctx or current_context()
        dev = ctx.torch_device
        if op.need_rng:
            # an inference call: a random op draws nothing, but takes its
            # key from the chain as the JAX package's imperative call does
            _random.next_key()
        with torch.no_grad():
            outs, _ = op.apply(params, [_as_tensor(a, dev) for a in inputs],
                               aux=[], is_train=False, rng=None)
        if out is not None:
            out._set_data(outs[0])
            return out
        res = [NDArray(o, ctx) for o in outs]
        return res[0] if len(res) == 1 else res

    fn.__name__ = op.name
    fn.__doc__ = build_doc(op, op.name, kind="ndarray")
    return fn


def install(ndarray_module, symbol_module):
    """Attach every registered op to the NDArray and Symbol modules."""
    from ..symbol import _make_op_func

    for name, op in sorted(REGISTRY.items()):
        if op.imperative and not hasattr(ndarray_module, name):
            setattr(ndarray_module, name, _make_imperative(op))
        if not hasattr(symbol_module, name):
            setattr(symbol_module, name, _make_op_func(op, name))

"""Operator registry: one declarative definition per op.

The port's copy of ``mxnet_tpu/ops/registry.py``, host-only: ``OpDef``,
``Field`` and the registration helpers are the JAX package's, so every
op's parameter list and defaults, and with them ``Symbol.tojson()``,
are the same bytes in both packages, and ``register`` attaches the
prose docs of ``opdoc`` (a byte copy of the JAX package's), so every
op's docstring is the JAX package's too. Two things differ: ``forward``
is a function of ``torch.Tensor`` inputs (gradients come from
``torch.autograd``; loss ops are ``torch.autograd.Function``s); and
a host op (``host_apply``/``host_grad``: ``Custom`` and ``NumpyOp``)
runs through :class:`_HostOpFn`, the port's counterpart of the JAX
executor's hybrid engine (``mxnet_tpu/executor.py:339-518``): its inputs
go to the host as numpy, ``host_apply`` runs the user's code there, its
outputs come back to the inputs' device, and autograd calls
``host_grad`` with the out-grads as numpy.
``tests/test_torch_symbol.py`` holds every registered op's fields,
inputs, outputs and aux states to the JAX package's.
"""
from __future__ import annotations

import ast

import numpy as _np
import torch

from ..base import MXNetError

__all__ = ["Field", "OpDef", "register", "get", "list_ops", "REGISTRY"]

REGISTRY = {}


def _parse_tuple(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    if isinstance(v, str):
        return tuple(int(x) for x in ast.literal_eval(v))
    if isinstance(v, int):
        return (v,)
    raise MXNetError("cannot parse %r as shape tuple" % (v,))


def _parse_bool(v):
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return v.lower() in ("true", "1")
    return bool(v)


class Field:
    """A single op parameter, the analog of DMLC_DECLARE_FIELD
    (ref: dmlc::Parameter, e.g. src/operator/convolution-inl.h:31).

    type: one of 'int', 'float', 'bool', 'shape', 'str', 'any'
    """

    def __init__(self, type, default=None, required=False, enum=None, doc=""):
        self.type = type
        self.default = default
        self.required = required
        self.enum = enum
        self.doc = doc

    def convert(self, v):
        if v is None:
            return v
        if self.type == "int":
            return int(v)
        if self.type == "float":
            return float(v)
        if self.type == "bool":
            return _parse_bool(v)
        if self.type == "shape":
            return _parse_tuple(v)
        if self.type == "str":
            v = str(v)
            if self.enum is not None and v not in self.enum:
                raise MXNetError("value %r not in %s" % (v, self.enum))
            return v
        return v


class OpDef:
    """Declarative op definition; see module docstring."""

    def __init__(
        self,
        name,
        forward,
        params=None,
        arguments=("data",),
        outputs=("output",),
        aux=(),
        infer_shape=None,
        infer_type=None,
        need_rng=False,
        no_head_grad=False,
        key_var_num_args=None,
        imperative=True,
        init_aux=None,
        host_apply=None,
        host_grad=None,
        doc="",
    ):
        self.name = name
        self.forward = forward
        self.param_fields = dict(params or {})
        self._arguments = arguments
        self._outputs = outputs
        self._aux = aux
        self._infer_shape = infer_shape
        self._infer_type = infer_type
        self.need_rng = need_rng
        # no_head_grad: loss-layer semantics — Backward ignores out_grad
        # (ref: softmax_output-inl.h Backward uses label, not out_grad)
        self.no_head_grad = no_head_grad
        # key_var_num_args: Concat/ElementWiseSum-style variadic input count
        # (ref: include/mxnet/operator.h KeyVarNumArgs)
        self.key_var_num_args = key_var_num_args
        self.imperative = imperative
        self.init_aux = init_aux  # fn(params, aux_shapes)->list of np arrays
        # host-op contract: ops whose kernels are host Python/numpy
        # (Custom, NumpyOp). When set, apply() runs them through
        # _HostOpFn between the device ops — host values in, host
        # values out.
        #   host_apply(params, ins_np, is_train, cache=None)
        #       -> (outs_np, bwd_ctx)   (cache: executor-owned dict for
        #          per-binding operator instances)
        #   host_grad(params, bwd_ctx, out_grads_np) -> in_grads_np
        self.host_apply = host_apply
        self.host_grad = host_grad
        self.is_host_op = host_apply is not None
        self.doc = doc

    def head_no_grad(self, params=None):
        """Whether this node, as a graph head, needs no out_grad (loss
        semantics). May be params-dependent (Custom ops decide per
        need_top_grad of the user Prop)."""
        v = self.no_head_grad
        return bool(v(params or {})) if callable(v) else bool(v)

    # -- params ---------------------------------------------------------------
    def parse_params(self, kwargs):
        unknown = set(kwargs) - set(self.param_fields)
        if unknown:  # report typos before missing-required, the likelier cause
            raise MXNetError(
                "op %s: unknown params %s (accepted: %s)"
                % (self.name, sorted(unknown), sorted(self.param_fields))
            )
        params = {}
        for k, f in self.param_fields.items():
            if k in kwargs:
                params[k] = f.convert(kwargs[k])
            elif f.required:
                raise MXNetError("op %s: required param %s missing" % (self.name, k))
            else:
                params[k] = f.default
        return params

    # -- names ----------------------------------------------------------------
    def list_arguments(self, params=None):
        a = self._arguments
        if callable(a):
            return list(a(params or {}))
        if self.key_var_num_args and params:
            n = params.get(self.key_var_num_args)
            if n:
                return ["arg%d" % i for i in range(int(n))]
        return list(a)

    def list_outputs(self, params=None):
        o = self._outputs
        if callable(o):
            return list(o(params or {}))
        return list(o)

    def list_auxiliary_states(self, params=None):
        a = self._aux
        if callable(a):
            return list(a(params or {}))
        return list(a)

    # -- shape / type inference ----------------------------------------------
    def infer_shape(self, params, in_shapes):
        """Returns (in_shapes, out_shapes, aux_shapes); raises if
        insufficient info (ref: OperatorProperty::InferShape contract)."""
        if self._infer_shape is not None:
            return self._infer_shape(params, list(in_shapes))
        # default: elementwise — all inputs and outputs share one shape
        known = [s for s in in_shapes if s is not None]
        if not known:
            raise MXNetError("op %s: cannot infer shapes, no input known" % self.name)
        shape = known[0]
        for s in known:
            if s != shape:
                raise MXNetError(
                    "op %s: inconsistent input shapes %s vs %s" % (self.name, shape, s)
                )
        n_in = len(self.list_arguments(params))
        n_out = len(self.list_outputs(params))
        return [shape] * n_in, [shape] * n_out, []

    def infer_type(self, params, in_types):
        import numpy as np

        if self._infer_type is not None:
            return self._infer_type(params, list(in_types))
        known = [t for t in in_types if t is not None]
        t = known[0] if known else np.dtype("float32")
        n_in = len(self.list_arguments(params))
        n_out = len(self.list_outputs(params))
        n_aux = len(self.list_auxiliary_states(params))
        return [t] * n_in, [t] * n_out, [t] * n_aux

    # -- execution -------------------------------------------------------------
    def apply(self, params, inputs, aux=None, is_train=False, rng=None,
              host_cache=None):
        """Run forward. Returns (outputs: list, new_aux: list). A host op
        keeps its user operators in ``host_cache`` (the executor's, one
        a binding); without one each call makes a fresh operator."""
        if self.is_host_op:
            outs = _HostOpFn.apply(self, params, host_cache, bool(is_train),
                                   *inputs)
            return list(outs), list(aux or [])
        out = self.forward(
            params, inputs, list(aux or []), bool(is_train), rng
        )
        if isinstance(out, tuple) and len(out) == 2 and isinstance(out[0], (list, tuple)):
            outputs, new_aux = out
        else:
            outputs, new_aux = out, list(aux or [])
        if not isinstance(outputs, (list, tuple)):
            outputs = [outputs]
        return list(outputs), list(new_aux)


def _to_host(t):
    """A tensor as a numpy array the user's code may keep or write: a
    copy (bf16, which numpy lacks, as f32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy() if t.is_cuda else t.numpy().copy()


def _from_host(a, device, dtype=None):
    return torch.from_numpy(_np.ascontiguousarray(a)).to(
        device, dtype, copy=True)


class _HostOpFn(torch.autograd.Function):
    """A host op between device ops: the inputs go to the host, the
    user's ``host_apply`` runs there, the outputs come back to the first
    input's device. The backward gives ``host_grad`` the out-grads as
    numpy (zeros where none arrived) and moves the input gradients back;
    integer inputs get none and integer outputs are not differentiable,
    as in the JAX package's hybrid engine."""

    @staticmethod
    def forward(ctx, op, params, cache, is_train, *ins):
        device = ins[0].device
        outs_np, bwd_ctx = op.host_apply(
            params, [_to_host(t) for t in ins], is_train, cache=cache)
        outs = tuple(_from_host(o, device) for o in outs_np)
        ctx.op, ctx.params, ctx.bwd_ctx = op, params, bwd_ctx
        ctx.in_dtypes = [t.dtype if t.is_floating_point() else None
                         for t in ins]
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *out_grads):
        device = out_grads[0].device
        in_grads = ctx.op.host_grad(ctx.params, ctx.bwd_ctx,
                                    [_to_host(g) for g in out_grads])
        return (None, None, None, None) + tuple(
            None if dt is None else _from_host(g, device, dt)
            for g, dt in zip(in_grads, ctx.in_dtypes))


def register(opdef):
    if opdef.name in REGISTRY:
        raise MXNetError("op %s already registered" % opdef.name)
    REGISTRY[opdef.name] = opdef
    from . import opdoc  # lazy: opdoc imports nothing from here at top level

    opdoc.apply_to(opdef)
    return opdef


def get(name):
    if name not in REGISTRY:
        raise MXNetError("unknown op %s (registered: %d ops)" % (name, len(REGISTRY)))
    return REGISTRY[name]


def list_ops():
    return sorted(REGISTRY)


# -- convenience constructors used by tensor.py / nn.py ------------------------

def simple_unary(name, fn, imperative=True, aliases=(), doc=""):
    """Register a one-input elementwise op, mirroring
    MXNET_REGISTER_SIMPLE_OP unary registrations
    (ref: src/operator/elementwise_unary_op-inl.h)."""
    def forward(params, inputs, aux, is_train, rng):
        return [fn(inputs[0])], []

    op = register(OpDef(name, forward, arguments=("data",), imperative=imperative, doc=doc))
    for a in aliases:
        REGISTRY[a] = op
    return op


def simple_binary(name, fn, infer_shape=None, aliases=(), doc=""):
    """Two-input op (ref: src/operator/elementwise_binary_op-inl.h:213)."""
    def forward(params, inputs, aux, is_train, rng):
        return [fn(inputs[0], inputs[1])], []

    op = register(
        OpDef(name, forward, arguments=("lhs", "rhs"), infer_shape=infer_shape, doc=doc)
    )
    for a in aliases:
        REGISTRY[a] = op
    return op


def scalar_op(name, fn, doc=""):
    """Array-scalar op, scalar passed as param
    (ref: operator_util.h kScalar variants, e.g. _plus_scalar)."""
    def forward(params, inputs, aux, is_train, rng):
        return [fn(inputs[0], params["scalar"])], []

    return register(
        OpDef(
            name,
            forward,
            params={"scalar": Field("float", required=True)},
            arguments=("data",),
            doc=doc,
        )
    )

"""Operator registry: one declarative definition per op.

The port's copy of ``mxnet_tpu/ops/registry.py``, host-only: ``OpDef``,
``Field`` and the registration helpers are the JAX package's, so every
op's parameter list and defaults, and with them ``Symbol.tojson()``,
are the same bytes in both packages. Two things differ: ``forward`` is
a function of ``torch.Tensor`` inputs (gradients come from
``torch.autograd``; loss ops are ``torch.autograd.Function``s), and
``register`` attaches no prose docs (the JAX package's ``opdoc``).
``tests/test_torch_symbol.py`` holds every registered op's fields,
inputs, outputs and aux states to the JAX package's.
"""
from __future__ import annotations

import ast

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
        # (Custom, NumpyOp, torch bridge). When set, the Executor runs
        # them EAGERLY between jitted graph segments — host values in,
        # host values out, no jax.pure_callback inside a compiled
        # program (the callback runtime deadlocks are structural; see
        # executor.py hybrid mode).
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
    def apply(self, params, inputs, aux=None, is_train=False, rng=None):
        """Run forward. Returns (outputs: list, new_aux: list)."""
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


def register(opdef):
    if opdef.name in REGISTRY:
        raise MXNetError("op %s already registered" % opdef.name)
    REGISTRY[opdef.name] = opdef
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

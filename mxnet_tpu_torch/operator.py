"""Custom operators written in Python/numpy.

Counterpart of ``mxnet_tpu/operator.py``: ``CustomOp``/``CustomOpProp``
with ``register`` (ref: python/mxnet/operator.py:394-533), the legacy
``NumpyOp`` with ``NDArrayOp`` and ``PythonOp`` (ref: operator.py:124-222),
and the ``Custom`` op that runs a registered prop's operator. The JAX
package's copy with two parts left out:

- ``_custom_fwd``'s ``jax.pure_callback`` path: the port compiles no
  program, so ``Custom`` is a host op (``host_apply``/``host_grad``)
  everywhere, run by ``ops.registry._HostOpFn`` between device ops;
- ``register_custom_c_op``, the C API's ``MXCustomOpRegister``, which
  waits for the C API's port.

Shape inference (``_custom_infer_shape``: partial inputs as empty lists,
``InferShapeFatal`` once every input was known), the per-binding
operator cache, the saved forward arrays that ``backward`` reuses and
``no_head_grad`` from the prop's ``need_top_grad`` are the JAX
package's, line for line.
"""
from __future__ import annotations

import functools

import numpy as _np

from .base import InferShapeFatal, MXNetError
from .ops.registry import Field, OpDef, register as _register_opdef

__all__ = ["CustomOp", "CustomOpProp", "NumpyOp", "NDArrayOp",
           "PythonOp", "register", "get_all_registered"]

_CUSTOM_REGISTRY = {}


class CustomOp:
    """Base class for user ops (ref: python/mxnet/operator.py:394)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError()

    def assign(self, dst, req, src):
        """ref: operator.py:427 — honor kWriteTo/kAddTo."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] += src


class CustomOpProp:
    """Shape/type declaration for a CustomOp (ref: operator.py:447)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (
            in_type,
            [in_type[0]] * len(self.list_outputs()),
            [in_type[0]] * len(self.list_auxiliary_states()),
        )

    def list_outputs(self):
        return ["output"]

    def list_arguments(self):
        return ["data"]

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError()


class _HostArray:
    """Numpy view handed to user forward/backward; assignment-compatible
    with CustomOp.assign."""

    def __init__(self, arr):
        self._arr = arr

    def asnumpy(self):
        return self._arr

    @property
    def shape(self):
        return self._arr.shape


def register(reg_name):
    """Register a CustomOpProp subclass under a name usable as
    mx.sym.Custom(op_type=reg_name) (ref: operator.py:533 register)."""

    def do_register(prop_cls):
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls

    return do_register


def get_all_registered():
    return dict(_CUSTOM_REGISTRY)


class _HostND:
    """Minimal NDArray-like wrapper over host numpy for user callbacks."""

    def __init__(self, arr):
        self._arr = arr

    def asnumpy(self):
        return self._arr

    @property
    def shape(self):
        return self._arr.shape

    def __getitem__(self, k):
        return self._arr[k]

    def __setitem__(self, k, v):
        if hasattr(v, "asnumpy"):  # mx NDArray / another host view
            v = v.asnumpy()
        self._arr[k] = _np.asarray(v)


def _norm_infer_shape(ret):
    """User infer_shape may return (in, out) — the 2016 API (ref:
    python/mxnet/operator.py:73-90) — or (in, out, aux)."""
    if len(ret) == 2:
        ins, outs = ret
        return ins, outs, []
    return ret


def _custom_infer_shape(params, in_shapes):
    op_type = params["op_type"]
    prop = _CUSTOM_REGISTRY[op_type](**(params.get("__kwargs__") or {}))
    # Partially-known inputs reach the user prop as empty lists (the
    # reference passes default TShapes into the prop's InferShape,
    # custom-inl.h:60-78) so props that derive label/output shapes from
    # the data shape alone can back-fill them — prediction binds without
    # a label (FeedForward._init_predictor) rely on this. A prop that
    # indexes an entry that is still unknown raises; the fixed-point
    # loop treats that as "not yet inferable" and retries next sweep.
    unknown = any(s is None for s in in_shapes)
    try:
        ins, outs, auxs = _norm_infer_shape(prop.infer_shape(
            [list(s) if s is not None else [] for s in in_shapes]))
    except MXNetError as exc:
        if unknown or isinstance(exc, InferShapeFatal):
            raise  # retryable (or already classified) — loop decides
        # every input was known, so the prop's complaint is a REAL
        # error: escalate so the fixed point surfaces it verbatim
        # instead of degrading it to "cannot determine shapes"
        raise InferShapeFatal("Custom(%s) infer_shape: %s" % (op_type, exc))
    except Exception:
        if unknown:
            # the prop indexed a not-yet-known entry: retryable — the
            # fixed point will call again once more inputs resolve
            raise MXNetError(
                "Custom(%s) infer_shape needs more input shapes" % op_type)
        raise  # real prop bug with full information: propagate as-is
    if unknown:
        # Under partial inputs, "not yet known" maps to None; the fixed
        # point skips None entries but KEEPS everything the prop did
        # fill (a back-filled label next to a still-unknown output), so
        # partial progress is never thrown away. Sentinel rule: unknown
        # inputs are passed to the prop as empty LISTS, so an echoed
        # empty list (or None) means "not yet" — while an empty TUPLE
        # () is an intentional 0-d scalar shape (mx.nd scalars exist)
        # and passes through even on partial sweeps.
        def _norm(s):
            if s is None or (isinstance(s, list) and not s):
                return None
            return tuple(s)

        ins = [_norm(s) for s in ins]
        outs = [_norm(s) for s in outs]
        auxs = [_norm(s) for s in auxs]
        if not outs:
            raise MXNetError("Custom(%s): output shapes unknown" % op_type)
        return ins, outs, auxs
    return ([tuple(s) for s in ins], [tuple(s) for s in outs],
            [tuple(s) for s in auxs])


def _custom_arguments(params):
    op_type = params.get("op_type")
    if op_type and op_type in _CUSTOM_REGISTRY:
        prop = _CUSTOM_REGISTRY[op_type](**(params.get("__kwargs__") or {}))
        return prop.list_arguments()
    return ["data"]


def _custom_outputs(params):
    op_type = params.get("op_type")
    if op_type and op_type in _CUSTOM_REGISTRY:
        prop = _CUSTOM_REGISTRY[op_type](**(params.get("__kwargs__") or {}))
        return prop.list_outputs()
    return ["output"]


def _custom_host_apply(params, ins_np, is_train, cache=None):
    """Host execution of a Custom node: the user CustomOp runs directly
    on host numpy (the reference likewise runs Custom as a plain host
    function pushed to the engine, ref: custom-inl.h:1-211).

    `cache` is the owning Executor's per-binding dict: one operator
    instance per (node params, input signature), created once per bind
    like the reference, so stateful user CustomOps keep their state
    across batches and die with their executor."""
    op_type = params["op_type"]
    if op_type not in _CUSTOM_REGISTRY:
        raise MXNetError("Custom op %s not registered" % op_type)
    in_shapes = tuple(tuple(a.shape) for a in ins_np)
    in_dtypes = tuple(_np.dtype(a.dtype).str for a in ins_np)
    key = (id(params), in_shapes, in_dtypes)
    cached = cache.get(key) if cache is not None else None
    if cached is None:
        prop = _CUSTOM_REGISTRY[op_type](**(params.get("__kwargs__") or {}))
        n_out = len(prop.list_outputs())
        _, out_shapes, _ = _norm_infer_shape(
            prop.infer_shape(list(map(list, in_shapes))))
        _, out_dtypes, _ = prop.infer_type([a.dtype for a in ins_np])
        op = prop.create_operator(None, in_shapes, [a.dtype for a in ins_np])
        cached = (op, n_out, out_shapes, out_dtypes)
        if cache is not None:
            cache[key] = cached
    op, n_out, out_shapes, out_dtypes = cached
    outs = [_np.zeros(s, d) for s, d in zip(out_shapes, out_dtypes)]
    in_nd = [_HostND(_np.asarray(a)) for a in ins_np]
    out_nd = [_HostND(a) for a in outs]
    op.forward(bool(is_train), ["write"] * n_out, in_nd, out_nd, [])
    outs = [o._arr for o in out_nd]
    return outs, (op, in_nd, out_nd)


def _custom_host_grad(params, bwd_ctx, out_grads_np):
    """in_grads from the user CustomOp.backward, reusing the saved
    forward arrays (the residuals persist from the forward)."""
    op, in_nd, out_nd = bwd_ctx
    grads = [_np.zeros_like(a._arr) for a in in_nd]
    grad_nd = [_HostND(g) for g in grads]
    op.backward(["write"] * len(in_nd),
                [_HostND(_np.asarray(g)) for g in out_grads_np],
                in_nd, out_nd, grad_nd, [])
    return [g._arr for g in grad_nd]


_register_opdef(
    OpDef(
        "Custom",
        None,   # a host op: OpDef.apply runs host_apply
        params={
            "op_type": Field("str", required=True),
            "__kwargs__": Field("any", default=None),
        },
        arguments=_custom_arguments,
        outputs=_custom_outputs,
        infer_shape=_custom_infer_shape,
        imperative=False,
        # loss-head semantics follow the user Prop's need_top_grad
        no_head_grad=lambda params: (
            params.get("op_type") in _CUSTOM_REGISTRY
            and not _CUSTOM_REGISTRY[params["op_type"]](
                **(params.get("__kwargs__") or {})
            ).need_top_grad_
        ),
        host_apply=_custom_host_apply,
        host_grad=_custom_host_grad,
    )
)


class NumpyOp:
    """Legacy numpy op base (ref: python/mxnet/operator.py:124). Wraps the
    subclass into a CustomOp-backed symbol on get_symbol()."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def forward(self, in_data, out_data):
        raise NotImplementedError()

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError()

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def get_symbol(self, *args, **kwargs):
        numpy_op = self

        class _Prop(CustomOpProp):
            def __init__(self):
                super().__init__(need_top_grad=numpy_op.need_top_grad_)

            def list_arguments(self):
                return numpy_op.list_arguments()

            def list_outputs(self):
                return numpy_op.list_outputs()

            def infer_shape(self, in_shape):
                ins, outs = numpy_op.infer_shape(in_shape)
                return ins, outs, []

            def create_operator(self, ctx, in_shapes, in_dtypes):
                class _Op(CustomOp):
                    def forward(self, is_train, req, in_data, out_data, aux):
                        numpy_op.forward(
                            [a.asnumpy() for a in in_data],
                            [a._arr for a in out_data],
                        )

                    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
                        numpy_op.backward(
                            [a.asnumpy() for a in out_grad],
                            [a.asnumpy() for a in in_data],
                            [a.asnumpy() for a in out_data],
                            [a._arr for a in in_grad],
                        )

                return _Op()

        reg_name = "_numpy_op_%s_%d" % (type(self).__name__, id(self))
        register(reg_name)(_Prop)
        from . import symbol as sym

        return sym.Custom(*args, op_type=reg_name, **kwargs)


NDArrayOp = NumpyOp  # same user surface; arrays arrive as host views
PythonOp = NumpyOp  # the reference's shared base (operator.py:124)

# reference NumpyOp instances are called directly to build the symbol
# (example/numpy-ops/numpy_softmax.py: mysoftmax(data=fc3, name='softmax'))
NumpyOp.__call__ = NumpyOp.get_symbol

# `Custom` is registered above AFTER ops.install() ran in __init__, so
# wire it into the symbol module here (mx.sym.Custom(op_type=...), ref:
# python/mxnet/symbol.py auto-generated Custom)
from . import symbol as _sym_mod  # noqa: E402

if not hasattr(_sym_mod, "Custom"):
    from .ops.registry import REGISTRY as _reg
    from .symbol import _make_op_func as _mk

    _sym_mod.Custom = _mk(_reg["Custom"], "Custom")

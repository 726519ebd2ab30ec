"""Test assertion library shipped inside the package
(ref: python/mxnet/test_utils.py:1-747). Provides the reference's numeric
gradient checker and cross-context consistency checker — the template for
GPU-vs-CPU parity tests (SURVEY §4.2, §4.4).

Counterpart of ``mxnet_tpu/test_utils.py``, copied with its imports
rewritten: the symbolic gradients come from the port's executor
(``torch.autograd``) where the JAX package's come from ``jax.vjp``, and
``default_context()`` is the port's current context (``gpu(0)`` unless a
``with`` scope or :func:`set_default_context` says otherwise)."""
from __future__ import annotations

import numpy as _np

from .base import MXNetError
from .context import cpu, Context
from .ndarray import array, zeros, NDArray
from .symbol import Symbol

def default_context():
    from .context import current_context

    return current_context()


def reldiff(a, b):
    """ref: test_utils.py:92."""
    diff = _np.sum(_np.abs(a - b))
    norm = _np.sum(_np.abs(a)) + _np.sum(_np.abs(b))
    if diff == 0:
        return 0
    return diff / norm


def same(a, b):
    return _np.array_equal(a, b)


def assert_almost_equal(a, b, threshold=None):
    threshold = threshold or 1e-5
    rel = reldiff(a, b)
    if rel > threshold:
        raise AssertionError("reldiff %g > threshold %g\n%s\nvs\n%s" % (rel, threshold, a, b))


def random_arrays(*shapes):
    arrays = [_np.random.randn(*s).astype(default_dtype()) for s in shapes]
    if len(arrays) == 1:
        return arrays[0]
    return arrays


def _parse_location(sym, location, ctx):
    assert isinstance(location, (dict, list, tuple))
    if isinstance(location, dict):
        if set(location.keys()) != set(sym.list_arguments()):
            raise ValueError(
                "Symbol arguments and keys of the given location do not match: %s vs %s"
                % (str(set(sym.list_arguments())), str(set(location.keys())))
            )
    else:
        location = {k: v for k, v in zip(sym.list_arguments(), location)}
    location = {
        k: (array(v, ctx=ctx) if isinstance(v, _np.ndarray) else v)
        for k, v in location.items()
    }
    return location


def _parse_aux_states(sym, aux_states, ctx):
    if aux_states is not None:
        if isinstance(aux_states, dict):
            if set(aux_states.keys()) != set(sym.list_auxiliary_states()):
                raise ValueError("Symbol aux_states names and given aux_states do not match")
        elif isinstance(aux_states, (list, tuple)):
            aux_names = sym.list_auxiliary_states()
            aux_states = {k: v for k, v in zip(aux_names, aux_states)}
        aux_states = {k: array(v, ctx=ctx) for k, v in aux_states.items()}
    return aux_states


def numeric_grad(executor, location, aux_states=None, eps=1e-4, use_forward_train=True):
    """Finite-difference gradients (ref: test_utils.py:169)."""
    approx_grads = {k: _np.zeros(v.shape, dtype=_np.float32) for k, v in location.items()}
    for k, v in location.items():
        executor.arg_dict[k][:] = v
    for k in location:
        old_value = location[k].copy()
        for i in range(int(_np.prod(old_value.shape))):
            # inplace update
            loc = old_value.ravel().copy()
            loc[i] += eps / 2.0
            executor.arg_dict[k][:] = loc.reshape(old_value.shape)
            executor.forward(is_train=use_forward_train)
            f_peps = executor.outputs[0].asnumpy().sum()
            loc[i] -= eps
            executor.arg_dict[k][:] = loc.reshape(old_value.shape)
            executor.forward(is_train=use_forward_train)
            f_neps = executor.outputs[0].asnumpy().sum()
            approx_grads[k].ravel()[i] = (f_peps - f_neps) / eps
        executor.arg_dict[k][:] = old_value
    return approx_grads


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           check_eps=1e-2, grad_nodes=None, use_forward_train=True,
                           ctx=None):
    """Verify the executor's gradients against finite differences
    (ref: test_utils.py:219 check_numeric_gradient)."""
    if ctx is None:
        ctx = default_context()
    location = _parse_location(sym=sym, location=location, ctx=ctx)
    location_npy = {k: v.asnumpy() for k, v in location.items()}
    aux_states = _parse_aux_states(sym=sym, aux_states=aux_states, ctx=ctx)

    if grad_nodes is None:
        grad_nodes = sym.list_arguments()
        grad_req = {k: "write" for k in grad_nodes}
    elif isinstance(grad_nodes, (list, tuple)):
        grad_nodes = list(grad_nodes)
        grad_req = {k: "write" for k in grad_nodes}
    elif isinstance(grad_nodes, dict):
        grad_req = grad_nodes.copy()
        grad_nodes = grad_nodes.keys()
    else:
        raise ValueError

    input_shape = {k: v.shape for k, v in location.items()}
    _, out_shape, _ = sym.infer_shape(**input_shape)
    proj = Variable_like("__random_proj")
    out = _flat_sum(sym * proj)
    args = {
        k: zeros(v.shape, ctx) for k, v in location.items()
    }
    args["__random_proj"] = array(_np.random.normal(0, 0.01, size=out_shape[0]), ctx=ctx)
    args_grad = {k: zeros(v.shape, ctx) for k, v in args.items()}
    executor = out.bind(
        ctx, args=args, args_grad=args_grad,
        grad_req={k: grad_req.get(k, "write") for k in args}, aux_states=aux_states
    )
    inps = executor.arg_dict
    for k, v in location.items():
        inps[k][:] = v.asnumpy()
    executor.forward(is_train=True)
    executor.backward()
    symbolic_grads = {k: executor.grad_dict[k].asnumpy() for k in grad_nodes}

    # finite differences over the same projected scalar output
    numeric_gradients = numeric_grad(
        executor,
        {k: v for k, v in location_npy.items()},
        aux_states, eps=numeric_eps, use_forward_train=use_forward_train,
    )
    for name in grad_nodes:
        fd_grad = numeric_gradients[name]
        sym_grad = symbolic_grads[name]
        rel = reldiff(fd_grad, sym_grad)
        if rel > check_eps:
            raise AssertionError(
                "numeric check failed for %s: reldiff %g > %g\nnumeric:\n%s\nsymbolic:\n%s"
                % (name, rel, check_eps, fd_grad, sym_grad)
            )


def Variable_like(name):
    from .symbol import Variable

    return Variable(name)


def _flat_sum(sym):
    from . import symbol as S

    # MakeLoss head so backward() needs no out_grads (the reference checker
    # relies on the same loss-head semantics)
    return S.MakeLoss(S.sum(S.Flatten(sym)))


def check_symbolic_forward(sym, location, expected, check_eps=1e-5,
                           aux_states=None, ctx=None):
    """ref: test_utils.py:305."""
    if ctx is None:
        ctx = default_context()
    location = _parse_location(sym=sym, location=location, ctx=ctx)
    aux_states = _parse_aux_states(sym=sym, aux_states=aux_states, ctx=ctx)
    if isinstance(expected, dict):
        expected = [expected[k] for k in sym.list_outputs()]
    args = {k: v for k, v in location.items()}
    executor = sym.bind(ctx, args=args, aux_states=aux_states, grad_req="null")
    outputs = [x.asnumpy() for x in executor.forward(is_train=False)]
    for out, exp in zip(outputs, expected):
        assert_almost_equal(out, exp, check_eps)
    return outputs


def check_symbolic_backward(sym, location, out_grads, expected, check_eps=1e-5,
                            aux_states=None, grad_req="write", ctx=None):
    """ref: test_utils.py:353."""
    if ctx is None:
        ctx = default_context()
    location = _parse_location(sym=sym, location=location, ctx=ctx)
    aux_states = _parse_aux_states(sym=sym, aux_states=aux_states, ctx=ctx)
    if isinstance(expected, (list, tuple)):
        expected = {k: v for k, v in zip(sym.list_arguments(), expected)}
    args = {k: v for k, v in location.items()}
    args_grad = {k: zeros(v.shape, ctx) for k, v in expected.items()}
    executor = sym.bind(
        ctx, args=args, args_grad=args_grad, aux_states=aux_states, grad_req=grad_req
    )
    executor.forward(is_train=True)
    if isinstance(out_grads, (tuple, list)):
        out_grads = [array(v, ctx=ctx) if isinstance(v, _np.ndarray) else v for v in out_grads]
    executor.backward(out_grads)
    grads = {k: v.asnumpy() for k, v in executor.grad_dict.items() if k in expected}
    for name in expected:
        assert_almost_equal(grads[name], expected[name], check_eps)
    return grads


def check_consistency(sym, ctx_list, scale=1.0, type_dict=None, grad_req="write",
                      arg_params=None, aux_params=None, tol=None):
    """Bind the same symbol under several contexts/dtypes and require
    outputs & grads to agree within per-dtype tolerance — the reference's
    GPU↔CPU parity harness (ref: test_utils.py:615 check_consistency)."""
    if tol is None:
        tol = {
            _np.dtype(_np.float16): 1e-1,
            _np.dtype(_np.float32): 1e-3,
            _np.dtype(_np.float64): 1e-5,
            _np.dtype(_np.uint8): 0,
            _np.dtype(_np.int32): 0,
        }
    assert len(ctx_list) > 1
    if isinstance(sym, Symbol):
        sym = [sym] * len(ctx_list)
    else:
        assert len(sym) == len(ctx_list)

    output_points = None
    exe_list = []
    for s, ctx in zip(sym, ctx_list):
        ctx = dict(ctx)
        the_ctx = ctx.pop("ctx")
        exe = s.simple_bind(the_ctx, grad_req=grad_req, **ctx)
        exe_list.append(exe)

    arg_names = sym[0].list_arguments()
    # identical random init across contexts
    init_vals = {}
    for name, arr in exe_list[0].arg_dict.items():
        init_vals[name] = _np.random.normal(size=arr.shape, scale=scale)
    for exe in exe_list:
        for name, arr in exe.arg_dict.items():
            arr[:] = init_vals[name].astype(arr.dtype)
        if arg_params:
            for name, v in arg_params.items():
                exe.arg_dict[name][:] = v
        if aux_params:
            for name, v in aux_params.items():
                exe.aux_dict[name][:] = v

    outputs = []
    for exe in exe_list:
        exe.forward(is_train=(grad_req != "null"))
        if grad_req != "null":
            exe.backward(exe.outputs)
        outputs.append([o.asnumpy() for o in exe.outputs])

    # compare all against the highest-precision executor (last one)
    ref = outputs[-1]
    for i, out in enumerate(outputs[:-1]):
        dtype = out[0].dtype
        t = tol.get(_np.dtype(dtype), 1e-3)
        for o, r in zip(out, ref):
            assert_almost_equal(o.astype(_np.float64), r.astype(_np.float64), t)
    if grad_req != "null":
        ref_grads = {k: v.asnumpy() for k, v in exe_list[-1].grad_dict.items() if v is not None}
        for exe in exe_list[:-1]:
            for k, v in exe.grad_dict.items():
                if v is None or k not in ref_grads:
                    continue
                t = tol.get(v.dtype, 1e-3)
                assert_almost_equal(
                    v.asnumpy().astype(_np.float64),
                    ref_grads[k].astype(_np.float64), t,
                )
    return outputs


def default_dtype():
    """Default dtype for regression tests (ref: test_utils.py:27)."""
    return _np.float32


def default_numerical_threshold():
    """Default comparison threshold (ref: test_utils.py:33)."""
    return 1e-6


def set_default_context(ctx):
    """Make ``ctx`` the process default (ref: test_utils.py:23 sets
    Context.default_ctx): the bottom of the with-scope stack, consulted
    by current_context() whenever no `with ctx:` scope is active."""
    from .context import Context

    Context._default_bottom = ctx


def almost_equal(a, b, threshold=None):
    """True iff reldiff(a, b) <= threshold (ref: test_utils.py:110)."""
    rel = reldiff(a, b)
    return not _np.isnan(rel) and rel <= (threshold or
                                          default_numerical_threshold())


def np_reduce(dat, axis, keepdims, numpy_reduce_func):
    """Reduce ``dat`` over ``axis`` with numpy semantics — the oracle the
    reduction-op tests compare against (ref: test_utils.py:49)."""
    if isinstance(axis, int):
        axis = [axis]
    else:
        axis = list(axis) if axis is not None else range(len(dat.shape))
    ret = dat
    for i in reversed(sorted(axis)):
        ret = numpy_reduce_func(ret, axis=i)
    if keepdims:
        keepdims_shape = list(dat.shape)
        for i in axis:
            keepdims_shape[i] = 1
        ret = ret.reshape(tuple(keepdims_shape))
    return ret


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    """Forward a symbol on numpy inputs, returning numpy outputs —
    the doctest convenience (ref: test_utils.py:138)."""
    ctx = ctx or default_context()
    args = {k: array(v, ctx=ctx) for k, v in inputs.items()}
    exe = sym.bind(ctx, args=args)
    exe.forward(is_train=is_train)
    outputs = [x.asnumpy() for x in exe.outputs]
    return outputs[0] if len(outputs) == 1 else outputs


def check_speed(sym, location=None, ctx=None, N=20, grad_req=None,
                typ="whole", **kwargs):
    """Average seconds per forward(+backward) over N runs
    (ref: test_utils.py:537). typ='whole' times fwd+bwd, 'forward' only
    the inference pass."""
    import time as _time

    from .ndarray import waitall

    ctx = ctx or default_context()
    grad_req = grad_req or "write"
    if location is None:
        exe = sym.simple_bind(grad_req=grad_req, ctx=ctx, **kwargs)
        rng = _np.random.RandomState(17)
        location = {k: rng.normal(size=arr.shape, scale=1.0)
                    for k, arr in exe.arg_dict.items()}
    else:
        if not isinstance(location, dict):
            raise TypeError("location must be a dict of name->np.ndarray")
        exe = sym.simple_bind(grad_req=grad_req, ctx=ctx,
                              **{k: v.shape for k, v in location.items()})
    for name, iarr in location.items():
        exe.arg_dict[name][:] = iarr.astype(exe.arg_dict[name].dtype)

    def run_once(train):
        exe.forward(is_train=train)
        if train:
            exe.backward(out_grads=exe.outputs)
        for output in exe.outputs:
            output.wait_to_read()

    if typ not in ("whole", "forward"):
        raise ValueError("typ can only be whole or forward")
    train = typ == "whole"
    run_once(train)  # warm up / compile
    tic = _time.time()
    for _ in range(N):
        run_once(train)
    waitall()
    return (_time.time() - tic) / N

"""Torch plugin: PyTorch modules, criteria and functions inside the graph.

Counterpart of ``mxnet_tpu/torch.py`` (ref: plugin/torch/
torch_module-inl.h, torch_criterion-inl.h, torch_function.cc; Python
surface python/mxnet/torch.py). The JAX package crosses to a CPU torch
through ``jax.pure_callback``; the port already runs on torch, so no
host bridge is needed: each surface runs on the graph's own device.

- ``mx.th.<fn>``: the 31 torch math functions of the JAX package's
  ``_TH_FUNCS`` on NDArrays, in both calling conventions,
  ``res = mx.th.exp(x)`` and ``mx.th.exp(res, x)``; on the arrays'
  device.
- ``TorchModule``: a ``torch.nn.Module`` built from a Python expression
  string (``module_string``, or ``lua_string`` as the reference's
  alias), e.g. ``mx.sym.TorchModule(data_0=d, module_string=
  'torch.nn.Linear(4, 3)', num_data=1, num_params=2, num_outputs=1)``.
  Its parameters are symbol arguments named ``torch_<name>`` (shapes
  from the built module), so initializers and optimizers treat them as
  any weight. The forward is ``torch.func.functional_call`` of the
  module on the graph's device with the graph's parameter tensors, in
  f32, and ``torch.autograd`` gives the gradients.
- ``TorchCriterion``: a torch loss (``torch.nn.MSELoss()``-style
  expression) as a loss head: its output is the loss repeated once a
  sample, and its backward ignores the out-grad and gives
  ``grad_scale`` times the loss's gradient to ``data`` and zeros to
  ``label`` (ref: torch_criterion-inl.h).

Modules run with eval-mode semantics, as in the JAX package: a module
that updates buffers in its forward (BatchNorm's running statistics)
reads them and does not update them; use the native BatchNorm op for
training-time moving statistics. The module is built once a string and
copied once a device; neither op is a host op, so the scanned fit takes
graphs that hold them.
"""
from __future__ import annotations

import copy
import sys

import torch

from .base import MXNetError
from .ops.registry import Field, OpDef, register as _register_opdef

__all__ = ["import_torch", "module_creator"]

_module_cache = {}
_device_modules = {}


def import_torch():
    """The torch module (the JAX package imports it lazily; the port
    always has it)."""
    return torch


def module_creator(module_string):
    """Build (and cache) the torch module from its creation expression —
    the analog of running the lua_string through luaL_loadstring
    (ref: torch_module-inl.h:55-60). The module is f32, on the CPU, in
    eval mode."""
    mod = _module_cache.get(module_string)
    if mod is None:
        scope = {"torch": torch, "nn": torch.nn}
        try:
            mod = eval(module_string, scope)  # pylint: disable=eval-used
        except Exception as e:
            raise MXNetError(
                "TorchModule: cannot build module from %r: %s"
                % (module_string, e)) from e
        mod = mod.float().cpu()
        mod.eval()
        _module_cache[module_string] = mod
    return mod


def _module_on(module_string, device):
    """The module's copy on ``device`` (its buffers live there; its
    parameters are replaced by the graph's in each call)."""
    key = (module_string, str(device))
    mod = _device_modules.get(key)
    if mod is None:
        mod = copy.deepcopy(module_creator(module_string)).to(device)
        mod.eval()
        _device_modules[key] = mod
    return mod


def _resolve_module_string(params):
    s = params.get("module_string") or params.get("lua_string")
    if not s:
        raise MXNetError("TorchModule/TorchCriterion requires module_string")
    return s


# ---------------------------------------------------------------------------
# TorchModule op
# ---------------------------------------------------------------------------

def _torch_module_fwd(params, inputs, aux, is_train, rng):
    mstr = _resolve_module_string(params)
    num_data = int(params["num_data"])
    mod = module_creator(mstr)
    names = [n for n, _ in mod.named_parameters()]
    if len(inputs) != num_data + len(names):
        raise MXNetError(
            "TorchModule %r: expected %d data + %d params, got %d inputs"
            % (mstr, num_data, len(names), len(inputs)))
    f32 = [x.float() for x in inputs]
    dev_mod = _module_on(mstr, f32[0].device)
    outs = torch.func.functional_call(
        dev_mod, dict(zip(names, f32[num_data:])), tuple(f32[:num_data]))
    if not isinstance(outs, (tuple, list)):
        outs = (outs,)
    return list(outs), []


def _torch_out_shapes(mstr, data_shapes, num_outputs):
    """Shape inference by running the module on zeros — the analog of the
    reference materialising torch tensors in InferShape
    (torch_module-inl.h:341-376)."""
    mod = module_creator(mstr)
    with torch.no_grad():
        outs = mod(*[torch.zeros(*s) for s in data_shapes])
    if not isinstance(outs, (tuple, list)):
        outs = (outs,)
    if len(outs) != num_outputs:
        raise MXNetError(
            "TorchModule %r produced %d outputs, declared num_outputs=%d"
            % (mstr, len(outs), num_outputs))
    return [tuple(o.shape) for o in outs]


def _torch_module_arguments(params):
    mstr = params.get("module_string") or params.get("lua_string")
    num_data = int(params.get("num_data", 1) or 1)
    datas = (["data"] if num_data == 1
             else ["data_%d" % i for i in range(num_data)])
    if not mstr:
        return datas
    mod = module_creator(mstr)
    pnames = ["torch_" + name.replace(".", "_")
              for name, _ in mod.named_parameters()]
    return datas + pnames


def _torch_module_outputs(params):
    n = int(params.get("num_outputs", 1) or 1)
    return ["output"] if n == 1 else ["output%d" % i for i in range(n)]


def _torch_module_infer_shape(params, in_shapes):
    mstr = _resolve_module_string(params)
    num_data = int(params["num_data"])
    num_outputs = int(params["num_outputs"])
    mod = module_creator(mstr)
    data_shapes = [tuple(s) if s is not None else None
                   for s in in_shapes[:num_data]]
    if any(s is None for s in data_shapes):
        raise MXNetError("TorchModule: data shapes required")
    param_shapes = [tuple(p.shape) for p in mod.parameters()]
    out_shapes = _torch_out_shapes(mstr, data_shapes, num_outputs)
    return data_shapes + param_shapes, out_shapes, []


_register_opdef(
    OpDef(
        "TorchModule",
        _torch_module_fwd,
        params={
            "module_string": Field("str", default=None),
            "lua_string": Field("str", default=None),  # reference alias
            "num_data": Field("int", default=1),
            "num_params": Field("int", default=0),  # accepted; actual count
            "num_outputs": Field("int", default=1),  # comes from the module
        },
        arguments=_torch_module_arguments,
        outputs=_torch_module_outputs,
        infer_shape=_torch_module_infer_shape,
        imperative=False,
        doc="Run a torch.nn.Module as an operator (ref: plugin/torch/"
            "torch_module-inl.h).",
    )
)


# ---------------------------------------------------------------------------
# TorchCriterion op
# ---------------------------------------------------------------------------

class _CriterionFn(torch.autograd.Function):
    """The loss repeated once a sample; the backward ignores the
    out-grad (a loss head)."""

    @staticmethod
    def forward(ctx, data, label, params):
        crit = _module_on(_resolve_module_string(params), data.device)
        d = data.detach().float().requires_grad_(True)
        lab = label.detach().float()
        with torch.enable_grad():
            loss = crit(d, lab)
            (g,) = torch.autograd.grad(loss, (d,))
        ctx.save_for_backward(g * float(params.get("grad_scale", 1.0)),
                              label)
        ctx.data_dtype = data.dtype
        batch = int(data.shape[0]) if data.dim() > 0 else 1
        return loss.detach().reshape(()).expand(batch).clone()

    @staticmethod
    def backward(ctx, g):
        del g  # loss head: out_grad ignored (ref: torch_criterion-inl.h)
        gd, label = ctx.saved_tensors
        return (gd.to(ctx.data_dtype),
                torch.zeros_like(label) if label.is_floating_point() else None,
                None)


def _torch_criterion_fwd(params, inputs, aux, is_train, rng):
    return [_CriterionFn.apply(inputs[0], inputs[1], params)], []


def _torch_criterion_infer_shape(params, in_shapes):
    d = in_shapes[0]
    if d is None:
        raise MXNetError("TorchCriterion: data shape required")
    label = in_shapes[1] if in_shapes[1] is not None else d
    return [tuple(d), tuple(label)], [(int(d[0]),)], []


_register_opdef(
    OpDef(
        "TorchCriterion",
        _torch_criterion_fwd,
        params={
            "module_string": Field("str", default=None),
            "lua_string": Field("str", default=None),
            "grad_scale": Field("float", default=1.0),
        },
        arguments=("data", "label"),
        infer_shape=_torch_criterion_infer_shape,
        imperative=False,
        no_head_grad=True,
        doc="Run a torch criterion as a loss op (ref: plugin/torch/"
            "torch_criterion-inl.h).",
    )
)


# ---------------------------------------------------------------------------
# mx.th imperative functions (ref: python/mxnet/torch.py)
# ---------------------------------------------------------------------------

# torch function name -> arity; the JAX package's curated set of the
# Torch7 maths functions the reference exposes through its _th_ registry
_TH_FUNCS = {
    "abs": 1, "acos": 1, "asin": 1, "atan": 1, "ceil": 1, "cos": 1,
    "cosh": 1, "exp": 1, "floor": 1, "log": 1, "log1p": 1, "neg": 1,
    "round": 1, "rsqrt": 1, "sigmoid": 1, "sign": 1, "sin": 1, "sinh": 1,
    "sqrt": 1, "tan": 1, "tanh": 1, "trunc": 1,
    "add": 2, "cdiv": 2, "cmul": 2, "cpow": 2, "cmax": 2, "cmin": 2,
    "csub": 2, "dot": 2, "mm": 2,
}

_TORCH_NAME = {"cdiv": "div", "cmul": "mul", "cpow": "pow", "cmax": "maximum",
               "cmin": "minimum", "csub": "sub", "rsqrt": "rsqrt"}


def _make_th_function(name, arity):
    tfn = getattr(torch, _TORCH_NAME.get(name, name))

    def th_function(*args):
        """Torch-backend NDArray function (ref: python/mxnet/torch.py
        generic_torch_function). ``res = fn(args...)`` or
        ``fn(res, args...)``."""
        from .ndarray import NDArray

        res = None
        if len(args) == arity + 1:  # fn(res, inputs...)
            res, args = args[0], args[1:]
        if len(args) != arity:
            raise MXNetError(
                "th.%s expects %d input arrays (optionally preceded by an "
                "output array), got %d args" % (name, arity, len(args)))
        dev = args[0]._data.device
        with torch.no_grad():
            out = tfn(*[a._data.to(dev) for a in args])
        if res is None:
            return NDArray(out, ctx=args[0].context)
        res._set_data(out)
        return res

    th_function.__name__ = name
    return th_function


class _TorchFunctionModule:
    """`mx.th` namespace object: attribute access yields the generated
    torch-backend functions (analog of _init_torch_module,
    ref: python/mxnet/torch.py:120+)."""

    def __init__(self):
        for fname, arity in _TH_FUNCS.items():
            setattr(self, fname, _make_th_function(fname, arity))


th = _TorchFunctionModule()
sys.modules[__name__ + ".th"] = th  # `from mxnet_tpu_torch.torch import th`

# this plugin registers ops after the package-level ops.install ran, so
# refresh the symbol/ndarray namespaces (no-op for already-installed ops)
from . import ndarray as _nd_mod  # noqa: E402
from . import symbol as _sym_mod  # noqa: E402
from .ops import install as _install  # noqa: E402

_install(ndarray_module=_nd_mod, symbol_module=_sym_mod)

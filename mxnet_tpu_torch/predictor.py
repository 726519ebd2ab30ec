"""Standalone prediction API + compiled-model export.

Counterpart of ``mxnet_tpu/predictor.py``: two deployment surfaces,
mirroring the reference's prediction story.

1. ``Predictor`` — the c_predict_api equivalent (ref:
   include/mxnet/c_predict_api.h:60-170 ``MXPredCreate/SetInput/Forward/
   PartialForward/GetOutputShape/GetOutput``, impl
   src/c_api/c_predict_api.cc). Construct from the symbol JSON + raw
   ``.params`` bytes (the checkpoint files ``prefix-symbol.json`` /
   ``prefix-%04d.params``), feed inputs, run forward, read outputs.
   ``set_input``/``forward``/``get_output`` keep the reference's
   stateful call sequence so predict-only clients port 1:1.

2. ``export_compiled``/``load_compiled`` — the amalgamation equivalent
   (ref: amalgamation/, which concatenates the whole library into one
   translation unit so a prediction runs with zero framework deps). Here
   the bound inference walk (``Executor._run(..., is_train=False)``) is
   traced by ``torch.export`` with the weights as buffers of the
   program, and ``load_compiled`` runs it WITHOUT the Symbol graph or
   the op registry — torch and the registration of the one custom op
   the program calls, SoftmaxOutput's row softmax
   (``mxnet_tpu_torch::fused_softmax``, ``ops/softmax.py``; on a CUDA
   tensor the hand-written kernel), are all it needs.

Where the port parts from the JAX package:

- ``ctx=None`` means ``gpu(0)``, as for every entry point of the port
  (the JAX package's default is ``cpu()``); without CUDA it raises.
- The compile layer, as in the JAX ``_bind``
  (``mxnet_tpu/predictor.py:125-141``): predict-time weights never
  change after bind, so under ``MXNET_COMPILE_OPT=1`` the bind hands the
  checkpoint's parameters to the fold pass as ``frozen_params``
  (parameter-only subexpressions become constants on the bind's
  device); the bind arms the persistent cubin cache when
  ``MXNET_COMPILE_CACHE_DIR`` is set. The graph binds with
  ``grad_req="null"``.
- The artifact keeps the JAX package's envelope (``b"MXTC"``, the
  header's length, a JSON header) with a ``torch.export.save`` body; a
  JAX artifact (a StableHLO body) cannot be run here and raises.
"""
from __future__ import annotations

import io as _io
import json

import numpy as _np
import torch

from .base import MXNetError
from .context import Context, gpu
from .ndarray import NDArray, zeros

__all__ = ["Predictor", "load_compiled"]

_FORMAT = "torch.export"


class Predictor:
    """Predict-only executor over a checkpointed model
    (ref: c_predict_api.h MXPredCreate:60).

    Parameters
    ----------
    symbol_json_str : str
        Symbol graph JSON (contents of ``prefix-symbol.json``).
    param_bytes : bytes or dict
        Raw contents of ``prefix-%04d.params`` (NDArray dict with
        ``arg:``/``aux:`` name prefixes), or an already-loaded dict.
    ctx : Context
        Device to run on; ``None`` is ``gpu(0)``.
    input_shapes : dict of name -> tuple
        Shapes of the input nodes (ref MXPredCreate input_keys/shapes).
    output_names : list of str, optional
        Restrict outputs to these heads — the MXPredCreatePartialOut
        variant (c_predict_api.h:93).
    """

    def __init__(self, symbol_json_str, param_bytes, ctx=None,
                 input_shapes=None, output_names=None):
        from . import ndarray as nd
        from .symbol import load_json

        ctx = gpu(0) if ctx is None else Context(ctx)
        ctx.torch_device   # raises for a card that is not there
        if input_shapes is None:
            raise MXNetError("Predictor requires input_shapes")
        sym = load_json(symbol_json_str)
        if output_names is not None:
            from .symbol import Group

            internals = sym.get_internals()
            heads = [internals[n if n.endswith("_output") else n + "_output"]
                     for n in output_names]
            sym = Group(heads) if len(heads) > 1 else heads[0]
        self._symbol = sym
        self._ctx = ctx

        if isinstance(param_bytes, dict):
            loaded = param_bytes
        else:
            loaded = nd.load_frombuffer(param_bytes)
        arg_params, aux_params = {}, {}
        for k, v in loaded.items():
            if k.startswith("arg:"):
                arg_params[k[4:]] = v
            elif k.startswith("aux:"):
                aux_params[k[4:]] = v
            else:  # unprefixed dicts accepted like FeedForward.load does
                arg_params[k] = v

        self._input_names = list(input_shapes.keys())
        self._bind(dict(input_shapes), arg_params, aux_params)

    def _bind(self, input_shapes, arg_params, aux_params):
        arg_names = self._symbol.list_arguments()
        aux_names = self._symbol.list_auxiliary_states()
        # the checkpoint's parameter shapes seed inference beside the
        # declared inputs: a graph whose weights feed through a
        # transformation has no leaf shape inferable from the data side
        known = dict(input_shapes)
        for name in arg_names:
            if name not in known and name in arg_params:
                known[name] = tuple(arg_params[name].shape)
        arg_shapes, out_shapes, aux_shapes = self._symbol.infer_shape(**known)
        # fixed for the life of a binding; reshape() re-binds
        self._out_shapes = [tuple(s) for s in out_shapes]
        args = {}
        for name, shape in zip(arg_names, arg_shapes):
            if name in input_shapes:
                args[name] = zeros(shape, self._ctx)
            elif name in arg_params:
                if tuple(arg_params[name].shape) != tuple(shape):
                    raise MXNetError(
                        "param %s shape %s != expected %s"
                        % (name, tuple(arg_params[name].shape), tuple(shape)))
                args[name] = arg_params[name].as_in_context(self._ctx)
            else:
                # label arguments of loss heads are not in predict-time
                # param files; bind zeros (inference never reads them)
                args[name] = zeros(shape, self._ctx)
        aux = [aux_params[n].as_in_context(self._ctx) if n in aux_params
               else zeros(s, self._ctx)
               for n, s in zip(aux_names, aux_shapes)]
        self._args = args
        self._arg_params = arg_params
        self._aux_params = aux_params
        from . import compile as _compile

        _compile.ensure_jit_cache()
        frozen = {n: args[n] for n in arg_names
                  if n not in input_shapes and n in arg_params}
        self._exe = self._symbol.bind(
            self._ctx, args, aux_states=aux, grad_req="null",
            _compile_opts={"frozen_params": frozen} if frozen else None)
        self._outputs = None

    @classmethod
    def from_checkpoint(cls, prefix, epoch, ctx=None, input_shapes=None,
                        output_names=None):
        """Build from ``prefix-symbol.json`` + ``prefix-%04d.params``
        (the files written by save_checkpoint, ref: model.py:311)."""
        from .model import fence_checkpoint

        fence_checkpoint(prefix)  # in-flight async checkpoint writes
        with open("%s-symbol.json" % prefix) as f:
            sym_json = f.read()
        with open("%s-%04d.params" % (prefix, epoch), "rb") as f:
            params = f.read()
        return cls(sym_json, params, ctx=ctx, input_shapes=input_shapes,
                   output_names=output_names)

    # -- the c_predict_api call sequence --------------------------------------
    def set_input(self, key, value):
        """ref: MXPredSetInput (c_predict_api.h:126)."""
        if key not in self._args or key not in self._input_names:
            raise MXNetError("unknown input %r; inputs are %s"
                             % (key, self._input_names))
        v = value.asnumpy() if hasattr(value, "asnumpy") else _np.asarray(value)
        if tuple(v.shape) != tuple(self._args[key].shape):
            raise MXNetError("input %s shape %s != declared %s"
                             % (key, v.shape, self._args[key].shape))
        self._args[key][:] = v

    def forward(self, **kwargs):
        """Run forward; kwargs are a convenience for set_input
        (ref: MXPredForward c_predict_api.h:135)."""
        for k, v in kwargs.items():
            self.set_input(k, v)
        self._outputs = self._exe.forward(is_train=False)
        return self._outputs

    def get_output_shape(self, index=0):
        """ref: MXPredGetOutputShape (c_predict_api.h:113), from the
        shapes cached at bind time."""
        return self._out_shapes[index]

    def get_output(self, index=0):
        """ref: MXPredGetOutput (c_predict_api.h:161)."""
        if self._outputs is None:
            raise MXNetError("call forward() before get_output()")
        return self._outputs[index].asnumpy()

    def reshape(self, new_input_shapes):
        """Rebind for new input shapes sharing weights
        (ref: MXPredReshape c_predict_api.h:178)."""
        self._bind(dict(new_input_shapes), self._arg_params, self._aux_params)

    # -- compiled export (amalgamation equivalent) ----------------------------
    def export_compiled(self):
        """Serialize the forward program (weights baked in) to bytes via
        ``torch.export``; see module docstring."""
        exe = self._exe
        if exe._hybrid:
            raise MXNetError("export_compiled: a graph with host ops "
                             "(Custom/NumpyOp) runs user Python and cannot "
                             "be exported")
        module = _InferenceProgram(exe, self._symbol.list_arguments(),
                                   self._input_names)
        example = tuple(self._args[n]._data for n in self._input_names)
        with torch.no_grad():
            exported = torch.export.export(module, example, strict=False)
        buf = _io.BytesIO()
        torch.export.save(exported, buf)
        header = json.dumps({"inputs": self._input_names, "format": _FORMAT,
                             "device": str(self._ctx.torch_device)}).encode()
        return (b"MXTC" + len(header).to_bytes(4, "little") + header
                + buf.getvalue())


class _InferenceProgram(torch.nn.Module):
    """The executor's inference walk as a module: the inputs are the
    program's arguments, every other argument (parameters, the labels'
    zeros) and the aux states are its buffers."""

    def __init__(self, exe, arg_names, input_names):
        super().__init__()
        self._exe = exe
        self._slots = []   # an input's position, or a buffer's name
        for i, (name, arr) in enumerate(zip(arg_names, exe.arg_arrays)):
            if name in input_names:
                self._slots.append(input_names.index(name))
            else:
                self.register_buffer("arg%d" % i, arr._data)
                self._slots.append("arg%d" % i)
        for j, arr in enumerate(exe.aux_arrays):
            self.register_buffer("aux%d" % j, arr._data)
        self._n_aux = len(exe.aux_arrays)

    def forward(self, *inputs):
        vals = [inputs[s] if isinstance(s, int) else getattr(self, s)
                for s in self._slots]
        aux = [getattr(self, "aux%d" % j) for j in range(self._n_aux)]
        outs, _ = self._exe._run(vals, aux, False)
        return tuple(outs)


class _CompiledPredictor:
    """Deserialized compiled model: runs without symbol/op machinery."""

    def __init__(self, input_names, program, device):
        self.input_names = list(input_names)
        self._program = program
        self._device = torch.device(device)
        self._outputs = None

    def forward(self, **kwargs):
        vals = []
        for n in self.input_names:
            v = kwargs[n]
            if isinstance(v, NDArray):
                v = v._data
            elif not torch.is_tensor(v):
                v = torch.from_numpy(_np.ascontiguousarray(
                    v, dtype=_np.float32))
            vals.append(v.to(self._device))
        with torch.no_grad():
            self._outputs = self._program(*vals)
        return self._outputs

    def get_output(self, index=0):
        if self._outputs is None:
            raise MXNetError("call forward() before get_output()")
        return self._outputs[index].detach().cpu().numpy()


def load_compiled(blob):
    """Load an export_compiled() artifact; needs torch and the custom
    op's registration (``mxnet_tpu_torch.ops.softmax``) only."""
    from .ops import softmax as _softmax  # noqa: F401  registers the op

    if blob[:4] != b"MXTC":
        raise MXNetError("not a compiled-model artifact")
    hlen = int.from_bytes(blob[4:8], "little")
    header = json.loads(blob[8:8 + hlen].decode())
    if header.get("format") != _FORMAT:
        raise MXNetError(
            "a compiled-model artifact of the JAX package (a StableHLO "
            "body) cannot be loaded by mxnet_tpu_torch; export the model "
            "again with the port's Predictor.export_compiled")
    exported = torch.export.load(_io.BytesIO(blob[8 + hlen:]))
    return _CompiledPredictor(header["inputs"], exported.module(),
                              header["device"])

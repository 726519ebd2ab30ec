"""Runtime kernel compilation on NVRTC: the port of ``mxnet_tpu/rtc.py``.

On a TPU the JAX package stood a Pallas body in for the reference's
runtime-compiled CUDA kernel. On the H100 RTC goes back to the
reference's own contract (``python/mxnet/rtc.py``, ``MXRtc`` in
``src/common/mxrtc.cc``): the user writes a CUDA C kernel **body**;
:func:`_decorate` wraps it in ``extern "C" __global__ void name(const T*
in, ..., T* out, ...)`` with ``<x>_ndim`` and ``<x>_dims[]`` constants
for every array; NVRTC compiles it for ``sm_90a`` at the first ``push``
(:mod:`.ops._nvrtc`), the program is cached, and ``push`` launches it on
the NDArrays' device memory on PyTorch's current stream::

    x = mx.nd.ones((10,), ctx=mx.gpu(0))
    y = mx.nd.zeros((10,), ctx=mx.gpu(0))
    k = mx.rtc.Rtc("abc", [("x", x)], [("y", y)],
                   "y[threadIdx.x] = expf(x[threadIdx.x] * 5.0f);")
    k.push([x], [y], grid_dims=(1, 1, 1), block_dims=(10, 1, 1))

Differences from the JAX package's ``Rtc``, each deliberate:

- the body is CUDA C, not Python/Pallas; ``T`` follows each template
  array's dtype (float32 ``float``, the reference's only type; float64
  ``double``, float16 ``__half``, bfloat16 ``__nv_bfloat16``, int32
  ``int``, int64 ``long long``, int8 ``signed char``, uint8 ``unsigned
  char``), and ``cuda_fp16.h``/``cuda_bf16.h`` are included only where
  a 16-bit type appears;
- ``grid_dims`` and ``block_dims`` are the launch's grid and block, and
  are not part of the cache key (shapes and dtypes are: they are baked
  into the source);
- ``block_shapes`` (a Pallas tiling notion) raises;
- a source body needs CUDA arrays on one device: a CUDA C body has no
  CPU twin, so on CPU arrays only the argument checks run, then it
  raises. A Python **callable** kernel (the JAX package's other form)
  is called once on the arrays' tensors, on any device, with grid
  (1, 1, 1).

``compiles`` and ``launches`` count NVRTC compiles and kernel launches;
``launches`` goes up by one where ``cuLaunchKernel`` is called and
nowhere else.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["Rtc"]

# program cache shared across Rtc instances, keyed by (name, decorated
# source, device index) -- the kernel_registry analog (mxrtc.h:66)
_program_cache = {}
compiles = 0
launches = 0

_CTYPES = {
    torch.float32: "float",
    torch.float64: "double",
    torch.float16: "__half",
    torch.bfloat16: "__nv_bfloat16",
    torch.int32: "int",
    torch.int64: "long long",
    torch.int8: "signed char",
    torch.uint8: "unsigned char",
}
_HEADERS = {torch.float16: "#include <cuda_fp16.h>\n",
            torch.bfloat16: "#include <cuda_bf16.h>\n"}


def _ctype(dtype):
    try:
        return _CTYPES[dtype]
    except KeyError:
        raise MXNetError("Rtc: dtype %s has no CUDA C type here (supported: "
                         "%s)" % (dtype, sorted(str(d) for d in _CTYPES)))


def _decorate(name, inputs, outputs, body):
    """The reference's ``MXRtc::decorate`` (src/common/mxrtc.cc): the
    signature, then ``<x>_ndim``/``<x>_dims[]`` for every array, the
    body and ``}``. ``inputs``/``outputs`` are ``(name, shape, dtype)``
    triples with torch dtypes."""
    inputs, outputs = list(inputs), list(outputs)
    arrays = inputs + outputs
    src = "".join(_HEADERS[d] for d in _HEADERS
                  if any(a[2] == d for a in arrays))
    args = ["const %s* %s" % (_ctype(d), n) for n, _, d in inputs]
    args += ["%s* %s" % (_ctype(d), n) for n, _, d in outputs]
    src += '\nextern "C" __global__ void %s(%s) {\n' % (name, ",".join(args))
    for n, shape, _ in arrays:
        src += "const int %s_ndim = %d;\n" % (n, len(shape))
        if shape:
            src += "const int %s_dims[] = {%s};\n" % (
                n, ",".join(str(int(s)) for s in shape))
    return src + body + "\n}\n"


class Rtc:
    """Runtime-compiled user kernel on NDArrays (ref: python/mxnet/rtc.py:8).

    Parameters
    ----------
    name : str
        Kernel name (the ``__global__`` function's).
    inputs : list of (str, NDArray)
        Input names and template arrays (fix shapes and dtypes, baked
        into the source as ``<x>_dims``).
    outputs : list of (str, NDArray)
        Output names and template arrays.
    kernel : str or callable
        A CUDA C kernel body (see the module docstring), or a Python
        function taking the input tensors then the output tensors.
    """

    def __init__(self, name, inputs, outputs, kernel):
        if not inputs or not outputs:
            raise ValueError("Rtc requires at least one input and one output")
        self.name = name
        self._in_names = [n for n, _ in inputs]
        self._out_names = [n for n, _ in outputs]
        self._in_shapes = [tuple(a.shape) for _, a in inputs]
        self._in_dtypes = [a._data.dtype for _, a in inputs]
        self._out_shapes = [tuple(a.shape) for _, a in outputs]
        self._out_dtypes = [a._data.dtype for _, a in outputs]
        if callable(kernel):
            self._kernel = kernel
            self._source = None
        else:
            self._kernel = None
            self._source = _decorate(
                name, zip(self._in_names, self._in_shapes, self._in_dtypes),
                zip(self._out_names, self._out_shapes, self._out_dtypes),
                kernel)

    @property
    def source(self):
        """The decorated CUDA C source (None for a callable kernel)."""
        return self._source

    def _compile(self, device_index):
        """The cached ``CUfunction`` of this source on the device,
        compiled and loaded at first use."""
        global compiles
        key = (self.name, self._source, device_index)
        fn = _program_cache.get(key)
        if fn is None:
            from .ops import _nvrtc

            cubin = _nvrtc.compile_cubin(self._source, self.name)
            compiles += 1
            # the module goes into the primary context that PyTorch
            # uses on this device, so make sure PyTorch has made it
            with torch.cuda.device(device_index):
                torch.cuda.init()
                fn = _nvrtc.load_function(cubin, self.name, device_index)
            _program_cache[key] = fn
        return fn

    def push(self, inputs, outputs, grid_dims=(1, 1, 1), block_dims=None,
             block_shapes=None):
        """Run the kernel (ref: python/mxnet/rtc.py push:61-95).

        ``inputs``/``outputs`` may differ from the constructor arrays but
        must match their shapes and order (the reference's contract).
        ``grid_dims`` and ``block_dims`` (default (1, 1, 1)) are the
        launch's grid and block."""
        global launches
        if len(inputs) != len(self._in_shapes):
            raise ValueError("kernel takes %d inputs, got %d"
                             % (len(self._in_shapes), len(inputs)))
        if len(outputs) != len(self._out_shapes):
            raise ValueError("kernel produces %d outputs, got %d arrays"
                             % (len(self._out_shapes), len(outputs)))
        for arr, shape in zip(inputs, self._in_shapes):
            if tuple(arr.shape) != shape:
                raise ValueError(
                    "input shape %s does not match kernel template %s"
                    % (tuple(arr.shape), shape)
                )
        for arr, shape in zip(outputs, self._out_shapes):
            if tuple(arr.shape) != shape:
                raise ValueError(
                    "output shape %s does not match kernel template %s"
                    % (tuple(arr.shape), shape)
                )
        if block_shapes is not None:
            raise MXNetError("Rtc.push: block_shapes is a Pallas tiling "
                             "notion with no CUDA meaning; give block_dims")
        grid = tuple(int(g) for g in grid_dims) + (1,) * (3 - len(grid_dims))
        block = tuple(int(b) for b in (block_dims or (1, 1, 1)))
        block += (1,) * (3 - len(block))
        if self._kernel is not None:
            if grid != (1, 1, 1):
                raise MXNetError("Rtc.push: a callable kernel runs once, "
                                 "grid_dims must be (1, 1, 1), got %s"
                                 % (tuple(grid_dims),))
            with torch.no_grad():
                self._kernel(*[a._data for a in inputs],
                             *[a._data for a in outputs])
            return
        tensors = [a._data for a in list(inputs) + list(outputs)]
        dev = tensors[0].device
        dtypes = self._in_dtypes + self._out_dtypes
        for t, want in zip(tensors, dtypes):
            if not t.is_cuda or t.device != dev or t.dtype != want:
                raise MXNetError(
                    "Rtc.push: a CUDA C body runs on CUDA arrays of one "
                    "device with the template dtypes; got %s %s, want "
                    "%s on %s (a CUDA C body has no CPU twin)"
                    % (t.device, t.dtype, want, dev))
        fn = self._compile(dev.index)
        ins = [a._data.contiguous() for a in inputs]
        outs = [o._data if o._data.is_contiguous()
                else torch.empty_like(o._data, memory_format=torch.contiguous_format)
                for o in outputs]
        from .ops import _nvrtc

        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            _nvrtc.launch(fn, dev.index, grid, block,
                          [t.data_ptr() for t in ins + outs],
                          stream.cuda_stream)
            launches += 1
            with torch.no_grad():
                for o, scratch in zip(outputs, outs):
                    if scratch is not o._data:
                        o._data.copy_(scratch)

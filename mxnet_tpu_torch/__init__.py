"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu, for an NVIDIA H100.

The JAX package ``mxnet_tpu`` stays the reference; this package imports
``torch`` and never ``jax`` or anything of ``mxnet_tpu``. It keeps the
JAX package's module names and layout. This release carries these paths
on one card:

- serving the transformer LM: ``serving.Engine``, with long prompts
  prefilled through Ulysses attention on a one-device mesh, whose local
  attention is the hand-written Hopper flash-attention forward kernel
  (``ops/csrc/flash_fwd.cu``);
- training the LM: ``parallel.ShardedTrainer`` (or ``make_train_step``)
  over ``models.transformer.loss_fn``, with gradients from
  ``torch.autograd``; the attention goes through
  ``ops.flash_attention.FlashAttention``, the forward kernel and the
  hand-written backward kernels (``ops/csrc/flash_bwd.cu``);
- the Symbol path: ``sym`` graphs (``models.get_lenet``,
  ``models.get_resnet``), ``nd`` arrays, ``Executor`` and
  ``FeedForward`` fit/predict/score/save/load, with SoftmaxOutput's row
  softmax as a hand-written kernel (``ops/csrc/softmax.cu``)::

      import mxnet_tpu_torch as mx
      train = mx.io.MNISTIter(batch_size=64, num_synthetic=1024, seed=1)
      model = mx.FeedForward(mx.models.get_lenet(), ctx=mx.gpu(0),
                             num_epoch=3, learning_rate=0.1, momentum=0.9,
                             initializer=mx.initializer.Xavier())
      model.fit(X=train)

- the Module API: ``module.Module``, ``SequentialModule``,
  ``PythonLossModule`` and ``BucketingModule`` over the same executor
  (bucketing's shared storage, ``Executor.reshape``, ``Monitor`` taps);
- the fused Symbol train step of ``bench.py``'s ResNet-50 leg:
  ``parallel.make_symbol_train_step`` (``models.get_resnet(stem="s2d")``,
  bf16 products over f32 master weights, ``step.loop`` over K batches),
  and the scanned fit it shares with ``FeedForward.fit`` and
  ``Module.fit`` on one device (``parallel/fit_trainer.py``,
  ``compute_dtype``);
- runtime-compiled kernels: ``rtc.Rtc`` wraps a user's CUDA C kernel
  body, compiles it with NVRTC for ``sm_90a`` and launches it on
  NDArrays on the card;
- the escape hatches: ``operator`` (``CustomOp``/``CustomOpProp`` behind
  ``sym.Custom``, ``NumpyOp``), whose user code runs on the host between
  the card's ops, and ``torch_plugin`` (``sym.TorchModule``,
  ``sym.TorchCriterion`` and ``th``), which runs torch modules on the
  graph's device;
- the image data path: ``recordio`` (RecordIO files byte-equal to the
  JAX package's, ``tools/torch_im2rec.py`` to pack them),
  ``io.ImageRecordIter`` (PIL decode and augmentation on a thread pool)
  with ``io.PrefetchingIter``, ``io.ResizeIter`` and ``io.CSVIter``,
  ``opencv``, and ``stream`` (``mem://``, ``s3://``, ``hdfs://`` URIs
  for ``nd.save``/``load`` and checkpoints); the dependency ``engine``
  (C++, built with ``g++`` at first use) writes checkpoints
  asynchronously;
- several devices and processes: ``kvstore`` (``mx.kv.create``: local,
  device and dist types; the dist types over ``torch.distributed``
  when ``tools/torch_launch.py`` starts the processes),
  ``FeedForward``/``Module`` over a list of contexts (data parallelism,
  the gradients summed through a kvstore), and ``group2ctx`` model
  parallelism in the ``Executor``;
- prediction and deployment: ``Predictor`` (the c_predict_api call
  sequence over a checkpoint, on ``gpu(0)`` unless given ``ctx``) and
  its ``export_compiled``/``predictor.load_compiled`` over
  ``torch.export``; mirroring (``MXNET_BACKWARD_DO_MIRROR``,
  ``force_mirroring``) in the executor; the host modules ``viz``,
  ``test_utils``, ``profiler`` (``torch.profiler``), ``runtime``,
  ``libinfo`` and ``misc``;
- the serving fleet and its operations: ``serving.Engine``'s
  ``drain``/``resume`` and live weight sync (``install_weights``,
  ``rollback_weights``; ``wsync``: a ``WeightPublisher`` serving
  versioned weight sets, a ``WeightSubscriber`` in each serving process
  under ``MXNET_WSYNC=1``), ``serving.fleet`` (a ``Router`` over
  ``ReplicaServer``s, redelivering the streams of a dead replica), and
  ``telemetry`` (``MXNET_TELEMETRY=1``: counters, spans, a JSONL
  journal, ``/metrics`` and ``/servingz`` over HTTP), with the RPC wire
  (``elastic.protocol``) and the retry and fault-injection layer
  (``resilience``) they stand on;
- the training guardian (``resilience.guardian``, ``MXNET_GUARDIAN=1``:
  on-device sentinels in both fit loops, skip-steps, rollback, the
  ``dist_sync`` vote) and mxprof (``telemetry.prof``, ``MXNET_PROF=1``:
  analytic program costs, step breakdowns, MFU on ``/profilez``), with
  the counters of the executor, the fits, the data layer, the kvstore
  and the dependency engine.

Entry points run on ``cuda:0`` unless given a device or context; without
CUDA and without one they raise.
"""
from __future__ import annotations

__version__ = "0.1.0"

from .base import MXNetError
# telemetry first: its atexit journal hook must register before the
# dependency engine's exit drain (atexit runs hooks in reverse order)
from . import telemetry
from . import resilience
from . import elastic
from .context import (Context, cpu, cpu_pinned, current_context, gpu,
                      num_devices)
from . import ndarray
from . import ndarray as nd
from . import random
from .attribute import AttrScope
from .name import NameManager, Prefix
from . import symbol
from . import symbol as sym
from .symbol import Group, Symbol, Variable
from . import ops

ops.install(ndarray_module=ndarray, symbol_module=symbol)

from .ndarray import (NDArray, load, save, load_frombuffer, zeros,  # noqa: E402
                      ones, array, empty, full, arange, concatenate,
                      waitall)
from .executor import Executor  # noqa: E402
from . import initializer  # noqa: E402
from .initializer import init  # noqa: E402
from . import optimizer  # noqa: E402
from . import lr_scheduler  # noqa: E402
from . import metric  # noqa: E402
from . import callback  # noqa: E402
from . import io  # noqa: E402
from . import kvstore  # noqa: E402
from . import kvstore as kv  # noqa: E402
from .kvstore import create as kvstore_create  # noqa: E402
from . import kvstore_server as _kvstore_server  # noqa: E402

# a legacy DMLC_ROLE=server launch fails at import, as the reference
# boots its server loop from package init (kvstore_server.py:58)
_kvstore_server._init_kvstore_server_module()
from . import model  # noqa: E402
from .model import FeedForward  # noqa: E402
from . import models  # noqa: E402
from . import monitor  # noqa: E402
from .monitor import Monitor  # noqa: E402
from . import module  # noqa: E402
from . import rtc  # noqa: E402
from . import operator  # noqa: E402
# the plugin submodule is named ``torch``: this binds the package's
# global ``torch`` to it, so nothing below may mean the torch library
from . import torch as torch_plugin  # noqa: E402
from .torch import th  # noqa: E402
from . import parallel  # noqa: E402
from . import serving  # noqa: E402
from . import engine  # noqa: E402
from . import stream  # noqa: E402
from . import recordio  # noqa: E402
from . import opencv  # noqa: E402
from . import opencv as cv  # noqa: E402
from . import predictor  # noqa: E402
from .predictor import Predictor  # noqa: E402
from . import test_utils  # noqa: E402
from . import visualization  # noqa: E402
from . import visualization as viz  # noqa: E402
from . import profiler  # noqa: E402
from . import runtime  # noqa: E402
from . import libinfo  # noqa: E402
from . import misc  # noqa: E402

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_devices", "nd", "ndarray", "random", "sym", "symbol",
           "array", "zeros", "ones", "empty", "full", "arange",
           "concatenate", "load", "save", "load_frombuffer", "waitall",
           "init",
           "Symbol", "Variable", "Group", "AttrScope", "NameManager",
           "Prefix", "NDArray", "Executor", "initializer", "optimizer",
           "lr_scheduler", "metric", "callback", "io", "kvstore", "kv",
           "kvstore_create", "model",
           "FeedForward", "ops", "models", "monitor", "Monitor", "module",
           "rtc", "operator", "torch_plugin", "th", "parallel", "serving",
           "engine", "stream", "recordio", "opencv", "cv", "cpu_pinned",
           "predictor", "Predictor", "test_utils", "visualization", "viz",
           "profiler", "runtime", "libinfo", "misc", "telemetry",
           "resilience", "elastic"]

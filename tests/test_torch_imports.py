"""mxnet_tpu_torch stands alone: no jax, nothing of mxnet_tpu.

- a fresh interpreter that imports the package and every submodule has
  neither ``jax`` nor ``mxnet_tpu`` in ``sys.modules``;
- no source of the port, nor ``chip_smoke.py``, the profile tools,
  ``tools/torch_im2rec.py``, ``tools/torch_bench_io.py``,
  ``tools/torch_launch.py``, ``tools/torch_bandwidth.py``,
  ``tools/torch_trace_merge.py``, ``tools/torch_telemetry_report.py``,
  the dist
  workers of ``tests/torch_nightly``, the card's
  test files or the port's examples (``examples/rnn_torch``,
  ``examples/ssd_torch``, ``examples/image-classification_torch``,
  ``examples/rcnn_torch``, ``examples/dec_torch``,
  ``examples/numpy-ops_torch``, ``examples/torch_torch``,
  ``examples/memcost_torch``, ``examples/model-parallel-lstm_torch``),
  imports
  either, nor names the JAX package's native runtime
  (``mxnet_tpu/_native``);
- on the CPU path (serving, LM training, a LeNet ``FeedForward`` fit
  and predict, a LeNet ``Module`` fit and predict (both on the scanned
  path), a bf16 ``make_symbol_train_step`` loop, a callable ``Rtc``
  push, ``matmul_stats`` on CPU tensors, ``examples/ssd_torch``'s
  training graph through ``Module.fit`` and its detection graph,
  ``examples/image-classification_torch``'s MLP through its
  ``train_model.fit``, an async checkpoint through the dependency
  engine, a packed ``.rec`` read through ``ImageRecordIter`` under
  ``PrefetchingIter``, ``opencv.resize``, ``nd.save`` to ``mem://``, a
  mirrored LeNet step, a ``Predictor`` and its exported program, a
  profiled ``test_utils.simple_forward``, ``runtime``, a ``local``
  kvstore summing a push from two contexts, a LeNet step bound under
  ``MXNET_COMPILE_OPT=1``) neither
  the kernel build
  module ``ops._build`` nor the NVRTC binding ``ops._nvrtc`` is
  imported; the walk over every submodule
  reaches ``rtc``, ``ops._nvrtc``, ``ops.matmul_stats``, ``monitor``,
  ``module/``, the two Symbol trainers of ``parallel/``, ``operator``,
  the torch plugin (``torch``), ``stream``, ``recordio``, ``opencv``,
  ``engine``, ``predictor``, ``test_utils``, ``visualization``,
  ``profiler``, ``runtime``, ``libinfo``, ``misc``, ``ops.opdoc``,
  ``kvstore``, ``kvstore_server``, ``telemetry``, ``elastic``,
  ``resilience`` (with ``resilience.guardian``), ``telemetry.prof``,
  ``telemetry.merge``, ``wsync``, ``serving.fleet``, ``compile/`` and
  ``analysis/``;
- ``tools/torch_trace_merge.py`` and ``tools/torch_telemetry_report.py``
  run ``--help`` in a fresh interpreter without importing either;
- the two entry points ``python -m mxnet_tpu_torch.serving.fleet.replica``
  and ``python -m mxnet_tpu_torch.wsync.publisher`` import neither;
- every card test file (``tests/test_torch_*_cuda.py``) carries the
  ``cuda`` marker;
- the host-only scheduler copy matches its original below the imports;
  the byte copies of the telemetry registry and journal merger, the RPC
  wire, the retry and fault-injection modules, the wsync client and
  the compile layer's IR walks match their originals
  whole, and the tracer, the exporters, the wsync package and the fleet
  router their originals with named replacements.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "mxnet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


_PROBE = """
import sys, pkgutil, importlib
import numpy as np, torch
from mxnet_tpu_torch.models.transformer import TransformerConfig, init_params
from mxnet_tpu_torch.parallel import create_mesh
from mxnet_tpu_torch.serving import Engine, ServingConfig

def forbidden():
    return sorted(m for m in sys.modules if m.split('.')[0] in %r)

cfg = TransformerConfig(vocab_size=17, num_layers=1, d_model=128,
                        num_heads=2, d_ff=32, max_seq_len=64, dtype='float32')
p = init_params(cfg, torch.Generator().manual_seed(0), 'cpu')
mesh = create_mesh((1,), ('seq',), devices=['cpu'])
e = Engine(p, cfg, ServingConfig(block_size=8, num_blocks=12, mesh=mesh,
                                 cp_kind='ulysses', cp_min_tokens=16),
           device='cpu')
out = e.generate([np.arange(32) %% 17], max_new_tokens=2)
assert len(out[0]) == 2 and e.stats()['cp_prefills'] == 1
from mxnet_tpu_torch.models.transformer import loss_fn
from mxnet_tpu_torch.parallel import ShardedTrainer
tr = ShardedTrainer(loss_fn(cfg), p)
assert np.isfinite(float(tr.step({'tokens': np.arange(66).reshape(2, 33) %% 17})))
import mxnet_tpu_torch as mx
it = mx.io.NDArrayIter(np.random.RandomState(0).rand(16, 1, 28, 28),
                       np.arange(16) %% 10, batch_size=8)
model = mx.FeedForward(mx.models.get_lenet(), ctx=mx.cpu(), num_epoch=1,
                       learning_rate=0.1, momentum=0.9)
model.fit(X=it)
assert model.predict(it).shape == (16, 10)
mod = mx.module.Module(mx.models.get_lenet(), context=mx.cpu())
mod.fit(it, num_epoch=1)
assert mod.predict(it).shape == (16, 10)
from mxnet_tpu_torch.parallel import make_symbol_train_step
from mxnet_tpu_torch import threefry
step, st = make_symbol_train_step(
    mx.models.get_lenet(), {'data': (8, 1, 28, 28), 'softmax_label': (8,)},
    ctx=mx.cpu(), compute_dtype='bfloat16')
st, outs = step.loop(st, {'data': np.zeros((2, 8, 1, 28, 28), 'f'),
                          'softmax_label': np.zeros((2, 8), 'f')},
                     threefry.prng_key(0, device='cpu'))
assert outs[0].shape == (2, 8, 10)
x = mx.nd.array(np.arange(4.0), ctx=mx.cpu())
k = mx.rtc.Rtc('sq', [('x', x)], [('y', x)], lambda a, b: b.mul_(a))
k.push([x], [x])
from mxnet_tpu_torch.ops.matmul_stats import matmul_stats
y, s, s2 = matmul_stats(torch.ones(3, 16, dtype=torch.bfloat16),
                        torch.ones(16, 8, dtype=torch.bfloat16))
assert float(s2.sum()) == 8 * 3 * 256.0 and matmul_stats.launches == 0
sys.path.insert(0, 'examples/ssd_torch')
import train_net as ssd
X, Y = ssd.synthetic_detection_set(4, 32, 3)
with mx.cpu():
    it = mx.io.NDArrayIter(X, Y, batch_size=4, label_name='label')
    mod = mx.module.Module(ssd.get_symbol_train(3), data_names=('data',),
                           label_names=('label',), context=mx.cpu())
    mod.fit(it, eval_metric=ssd.MultiBoxMetric(), num_epoch=1,
            initializer=mx.initializer.Xavier())
    det = mx.module.Module(ssd.get_symbol(3), data_names=('data',),
                           label_names=None, context=mx.cpu())
    det.bind(data_shapes=[('data', (4, 3, 32, 32))], for_training=False)
    det.set_params(*mod.get_params())
    assert ssd.evaluate_detections(det, X, Y, 4, 3) >= 0.0
sys.path.insert(0, 'examples/image-classification_torch')
import train_mnist, train_imagenet, train_cifar10, train_model
sys.argv = ['train_mnist.py', '--ctx', 'cpu', '--num-epochs', '1',
            '--synthetic', '--batch-size', '512']
model = train_model.fit(train_mnist.parse_args(), train_mnist.get_mlp(),
                        train_mnist.get_iterator((784,)))
assert model.arg_params['fc3_weight'].shape == (10, 64)
import tempfile
tmp = tempfile.mkdtemp()
mx.model.save_checkpoint(tmp + '/mlp', 1, model.symbol, model.arg_params,
                         model.aux_params)
assert mx.model.load_checkpoint(tmp + '/mlp', 1)[1].keys() == \
    model.arg_params.keys()
w = mx.recordio.MXRecordIO(tmp + '/t.rec', 'w')
for i in range(4):
    w.write(mx.recordio.pack_img((0, float(i), i, 0),
                                 np.full((40, 50, 3), 9 * i, np.uint8)))
w.close()
it = mx.io.PrefetchingIter(mx.io.ImageRecordIter(
    path_imgrec=tmp + '/t.rec', data_shape=(3, 32, 32), batch_size=2,
    rand_crop=True, random_h=36, mean_r=1.0))
assert [b.data[0].shape for b in it] == [(2, 3, 32, 32)] * 2
with mx.cpu():
    assert mx.cv.resize(mx.nd.array(np.zeros((8, 8, 3), np.uint8),
                                    dtype=np.uint8), (4, 4)).shape == (4, 4, 3)
mx.nd.save('mem://probe.params', [mx.nd.array(np.ones(3), ctx=mx.cpu())])
assert mx.nd.load('mem://probe.params')[0].shape == (3,)
import os
os.environ['MXNET_BACKWARD_DO_MIRROR'] = '1'
exe = mx.models.get_lenet().simple_bind(mx.cpu(), data=(2, 1, 28, 28))
del os.environ['MXNET_BACKWARD_DO_MIRROR']
assert exe._remat
exe.forward(is_train=True)
exe.backward()
pred = mx.Predictor.from_checkpoint(tmp + '/mlp', 1, ctx=mx.cpu(),
                                    input_shapes={'data': (2, 784)})
pred.forward(data=np.zeros((2, 784), 'f'))
compiled = mx.predictor.load_compiled(pred.export_compiled())
compiled.forward(data=np.zeros((2, 784), 'f'))
assert (compiled.get_output(0) == pred.get_output(0)).all()
mx.profiler.profiler_set_config(filename=tmp + '/trace')
mx.profiler.profiler_set_state('run')
with mx.profiler.scope('probe'):
    mx.test_utils.simple_forward(mx.sym.Variable('x') * 2, ctx=mx.cpu(),
                                 x=np.ones(3, 'f'))
mx.profiler.profiler_set_state('stop')
assert mx.runtime.has_feature('TORCH')
kv = mx.kv.create('local')
kv.init(0, mx.nd.zeros((2, 3), ctx=mx.cpu()))
kv.push(0, [mx.nd.ones((2, 3), ctx=mx.cpu(i)) for i in range(2)])
pulled = mx.nd.zeros((2, 3), ctx=mx.cpu())
kv.pull(0, out=pulled)
assert (pulled.asnumpy() == 2).all()
import os
os.environ['MXNET_COMPILE_OPT'] = '1'
mx.compile.reload()
exe = mx.models.get_lenet().simple_bind(mx.cpu(), data=(2, 1, 28, 28),
                                        softmax_label=(2,))
exe.forward(is_train=True)
exe.backward()
assert mx.compile.last_report()['layout'] == 2
del os.environ['MXNET_COMPILE_OPT']
mx.compile.reload()
print('cpu_path', 'mxnet_tpu_torch.ops._build' in sys.modules,
      'mxnet_tpu_torch.ops._nvrtc' in sys.modules, forbidden())
import mxnet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               'mxnet_tpu_torch.')]
assert 'mxnet_tpu_torch.serving.engine' in names, names
for must in ('model', 'rtc', 'ops._nvrtc', 'ops.matmul_stats', 'monitor',
             'ops.sequence', 'ops.vision', 'models.lstm', 'models.gru', 'models.rnn',
             'module', 'module.module', 'module.base_module', 'module.python_module',
             'module.sequential_module', 'module.bucketing_module',
             'parallel.symbol_trainer', 'parallel.fit_trainer',
             'operator', 'torch', 'stream', 'recordio', 'opencv',
             'engine', 'predictor', 'test_utils', 'visualization',
             'profiler', 'runtime', 'libinfo', 'misc', 'ops.opdoc',
             'kvstore', 'kvstore_server', 'telemetry', 'telemetry.registry',
             'telemetry.tracing', 'telemetry.export', 'telemetry.server',
             'elastic', 'elastic.protocol', 'elastic.client', 'resilience',
             'resilience.retry', 'resilience.faults', 'resilience.guardian',
             'telemetry.prof', 'telemetry.merge', 'wsync', 'wsync.common',
             'wsync.client', 'wsync.publisher', 'wsync.subscriber',
             'serving.fleet', 'serving.fleet.router',
             'serving.fleet.replica', 'compile', 'compile.ir',
             'compile.pipeline', 'compile.fold', 'compile.layout',
             'compile.fuse', 'compile.precision', 'compile.autotune',
             'compile.jit_cache', 'analysis', 'analysis.compile_verify'):
    assert 'mxnet_tpu_torch.' + must in names, (must, names)
for n in names:
    importlib.import_module(n)
print('all_modules', forbidden())
""" % (FORBIDDEN,)


def _env():
    """The environment of a fresh interpreter: this one's, without the
    JAX package's lock tracer switch that the suite's conftest sets (the
    port's Engine refuses it)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MXNET_ENGINE_VERIFY", "MXNET_PROF")}
    env["PYTHONPATH"] = str(ROOT)
    return env


@pytest.fixture(scope="module")
def probe():
    """One fresh interpreter: serve on the CPU path, then import every
    submodule; returns its report lines by name."""
    env = _env()
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    return {line.split(" ", 1)[0]: line.split(" ", 1)[1]
            for line in proc.stdout.strip().splitlines()}


def test_import_every_submodule_leaves_jax_out(probe):
    assert probe["all_modules"] == "[]"


def test_cpu_path_never_imports_the_kernel_build_module(probe):
    assert probe["cpu_path"] == "False False []"


_ENTRY = """
import runpy, sys
sys.argv = [%r, '--help']
try:
    runpy.run_module(%r, run_name='__main__', alter_sys=True)
except SystemExit as e:
    assert e.code == 0, e.code
print('forbidden', sorted(m for m in sys.modules
                          if m.split('.')[0] in %r))
"""


@pytest.mark.parametrize("module", ["mxnet_tpu_torch.serving.fleet.replica",
                                    "mxnet_tpu_torch.wsync.publisher"])
def test_entry_point_leaves_jax_out(module):
    """``python -m <module> --help`` runs the entry point as ``-m`` does;
    after it, neither jax nor the JAX package is imported."""
    proc = subprocess.run(
        [sys.executable, "-c", _ENTRY % (module, module, FORBIDDEN)],
        cwd=str(ROOT), env=_env(), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "usage: " in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == "forbidden []"


_TOOL = """
import runpy, sys
sys.argv = [%r, '--help']
try:
    runpy.run_path(%r, run_name='__main__')
except SystemExit as e:
    assert e.code == 0, e.code
print('forbidden', sorted(m for m in sys.modules
                          if m.split('.')[0] in %r))
"""


@pytest.mark.parametrize("tool", ["torch_trace_merge.py",
                                  "torch_telemetry_report.py"])
def test_tool_help_leaves_jax_out(tool):
    """The journal tools' ``--help`` in a fresh interpreter: usage
    printed, exit 0, neither jax nor the JAX package imported."""
    path = str(ROOT / "tools" / tool)
    proc = subprocess.run(
        [sys.executable, "-c", _TOOL % (path, path, FORBIDDEN)],
        cwd=str(ROOT), env=_env(), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "usage: " in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == "forbidden []"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "torch_serve_profile.py",
        ROOT / "tools" / "torch_train_profile.py",
        ROOT / "tools" / "torch_fit_profile.py",
        ROOT / "tools" / "torch_probe_matmul_stats.py",
        ROOT / "tools" / "torch_im2rec.py",
        ROOT / "tools" / "torch_bench_io.py",
        ROOT / "tools" / "torch_launch.py",
        ROOT / "tools" / "torch_bandwidth.py",
        ROOT / "tools" / "torch_trace_merge.py",
        ROOT / "tools" / "torch_telemetry_report.py",
        ROOT / "tests" / "torch_nightly" / "dist_sync_kvstore.py",
        ROOT / "tests" / "torch_nightly" / "dist_lenet.py",
        ROOT / "tests" / "test_torch_kvstore_cuda.py",
        ROOT / "tests" / "test_torch_flash_kernel_cuda.py",
        ROOT / "tests" / "test_torch_flash_bwd_kernel_cuda.py",
        ROOT / "tests" / "test_torch_softmax_kernel_cuda.py",
        ROOT / "tests" / "test_torch_rtc_kernel_cuda.py",
        ROOT / "tests" / "test_torch_matmul_stats_kernel_cuda.py",
        ROOT / "tests" / "test_torch_sampling_cuda.py",
        ROOT / "tests" / "test_torch_rnn_cuda.py",
        ROOT / "tests" / "test_torch_symbol_trainer_cuda.py",
        ROOT / "tests" / "test_torch_vision_cuda.py",
        ROOT / "tests" / "test_torch_zoo_cuda.py",
        ROOT / "tests" / "test_torch_host_ops_cuda.py",
        ROOT / "tests" / "test_torch_recordio_cuda.py",
        ROOT / "tests" / "test_torch_predictor_cuda.py",
        ROOT / "tests" / "test_torch_fleet_cuda.py",
        ROOT / "tests" / "test_torch_guardian_cuda.py",
        ROOT / "tests" / "test_torch_compile_cuda.py"]
    + sorted((ROOT / "examples" / "rnn_torch").glob("*.py"))
    + sorted((ROOT / "examples" / "ssd_torch").glob("*.py"))
    + sorted((ROOT / "examples" / "image-classification_torch").glob(
        "*.py"))
    + [p for d in ("rcnn_torch", "dec_torch", "numpy-ops_torch",
                   "torch_torch", "memcost_torch",
                   "model-parallel-lstm_torch")
       for p in sorted((ROOT / "examples" / d).glob("*.py"))],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, "%s imports %s" % (path, bad)
    text = path.read_text()
    assert "mxnet_tpu._native" not in text
    assert "mxnet_tpu/_native" not in text


@pytest.mark.parametrize(
    "path", sorted((ROOT / "tests").glob("test_torch_*_cuda.py")),
    ids=lambda p: p.name)
def test_card_test_files_carry_the_cuda_marker(path):
    """Every test of a card file is marked ``cuda`` (``pytestmark``), so
    ``-m 'not cuda'`` and the README's card command select them."""
    tree = ast.parse(path.read_text(), filename=str(path))
    marks = [ast.unparse(n.value) for n in tree.body
             if isinstance(n, ast.Assign)
             and [t.id for t in n.targets if isinstance(t, ast.Name)]
             == ["pytestmark"]]
    assert marks == ["pytest.mark.cuda"], (path.name, marks)


def test_scheduler_copy_matches_original():
    def body(p):
        text = p.read_text()
        return text[text.index("from __future__"):]

    assert body(PKG / "serving" / "scheduler.py") == body(
        ROOT / "mxnet_tpu" / "serving" / "scheduler.py")


# host-only modules carried over whole
BYTE_COPIES = ["telemetry/registry.py", "elastic/protocol.py",
               "resilience/retry.py", "resilience/faults.py",
               "wsync/client.py", "telemetry/merge.py", "compile/ir.py"]


@pytest.mark.parametrize("rel", BYTE_COPIES)
def test_byte_copy_matches_original(rel):
    assert (PKG / rel).read_bytes() == (
        ROOT / "mxnet_tpu" / rel).read_bytes()


# edited copies: the original with these lines replaced and no other
# change: {file: [(first, end, new lines)]}, original lines [first, end)
# counted from 0 (the tracer names the port's profiler; the others drop
# the JAX package's change numbers, and the router's note on redelivered
# streams says where bf16 on the card parts from them)
EDITED_COPIES = {
    "telemetry/tracing.py": [
        (16, 19, ["Spans also forward into :func:`mxnet_tpu_torch.profiler"
                  ".scope` while\n",
                  "the profiler is capturing, so the same names land in the "
                  "torch trace \u2014\n",
                  "mxtel is the always-on record, the trace stays the "
                  "deep-dive view.\n"]),
        (132, 134, ["        # forward into the torch trace only while a "
                    "capture runs \u2014\n",
                    "        # record_function costs a torch call per span "
                    "otherwise. The\n"]),
        (137, 138, ['        _profiler = sys.modules.get('
                    '"mxnet_tpu_torch.profiler")\n'])],
    "telemetry/export.py": [
        (226, 227, ["    older quantile-labelled lines (reservoir-exact "
                    "p50/p95/p99)\n"])],
    "wsync/__init__.py": [
        (0, 1, ['"""mxwsync: gated live trainer\u2192serving weight '
                'sync.\n'])],
    "serving/fleet/router.py": [
        (10, 13, ["engine's eviction-recompute fold lifted one tier up). "
                  "The client's\n",
                  "stream never tears and, because sampling is keyed by "
                  "(seed, global\n",
                  "position), the continuation is the uninterrupted "
                  "stream's wherever\n",
                  "the numerics agree (exactly in f32 on the host; bf16 "
                  "products on the\n",
                  "card round by batch shape and can part at a "
                  "near-tie).\n"])],
}


@pytest.mark.parametrize("rel", sorted(EDITED_COPIES))
def test_edited_copy_is_the_original_with_its_replacements(rel):
    lines = (ROOT / "mxnet_tpu" / rel).read_text().splitlines(keepends=True)
    for first, end, new in sorted(EDITED_COPIES[rel], reverse=True):
        lines[first:end] = new
    assert (PKG / rel).read_text() == "".join(lines)

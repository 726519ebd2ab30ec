"""FeedForward estimator and checkpoints.

Counterpart of ``mxnet_tpu/model.py``: ``FeedForward`` with ``fit``,
``predict``, ``score``, ``save`` and ``load``, and
``save_checkpoint``/``load_checkpoint`` (``prefix-symbol.json`` and
``prefix-%04d.params`` with ``arg:``/``aux:`` name prefixes, the JAX
package's files byte for byte). The optimizer is created with
``rescale_grad=1/batch_size``. ``ctx=None`` means ``gpu(0)``.

``fit`` takes one of the JAX package's two loops
(``_train_multi_device``, ``model.py:370-437``):

- **the scanned fit**, the default on one device with no kvstore
  (``MXNET_SCAN_TRAIN``
  unset or on, K = ``MXNET_TRAIN_SCAN_K``, 8): K batches at a time go
  to ``parallel/fit_trainer.py``, whose K steps run with no host
  synchronisation; the chunk's outputs are read after the next chunk
  is queued (``_scan_drain``: Accuracy's argmax is taken on the card
  before the copy), and the metric and the per-batch callbacks then
  run for each of its batches, numbered from 1 as the per-batch loop
  numbers them; an epoch's tail is a smaller chunk. The parameters are
  written back at each epoch's end. This is the one path that honours
  ``FeedForward(compute_dtype=...)`` (default ``MXNET_COMPUTE_DTYPE``):
  f32 master weights, bf16 products. It needs a scannable optimizer
  (``fit_trainer.supports_optimizer``) and no ``sym_gen``. A graph the
  trainer refuses (an ``MXNetError`` at construction: a non-loss head)
  falls back to the per-batch loop with a log line, as in the JAX
  package; any other error raised while the trainer is built
  propagates, where the JAX package falls back on every exception,
  since on the card that would hide a failed device or kernel behind
  the per-batch loop;
- **the per-batch loop** (``model.py:491-566``), on one device or
  several (``ctx`` a list; a context may repeat, ``[gpu(0), gpu(0)]``):
  each device's executor takes its slice of the batch
  (``work_load_list`` weights the slices), forward with ``is_train``,
  backward, then the update in parameter order and the metric. The
  update goes through the kvstore of ``_create_kvstore``
  (``mxnet_tpu/model.py:41-101``): a type name on one device that is
  not a dist type is no store; ``local`` with every parameter under 16M
  elements sums the gradients in the store and updates on each device
  (updater index ``index * num_device + k``); otherwise the store runs
  the optimizer and every device pulls the new weights. The optimizer's
  ``rescale_grad`` is one over the whole batch, times the workers under
  ``dist_sync``. The parameters are each device's copy averaged
  (``sum(...) / len``) at the last epoch's end or when an epoch-end
  callback wants them. A ``compute_dtype`` is then ignored with a
  warning, as in the JAX package.

``symbol`` may be a bucketing symbol generator (``sym_gen(bucket_key)
-> Symbol``, ``mxnet_tpu/model.py:898-910``): ``fit`` builds the default
bucket's symbol first (``data.default_bucket_key``), initialises the
parameters from it, and the executor manager binds each other bucket
over the same storage when its first batch comes; ``predict`` and
``score`` then run the default bucket's symbol, as the JAX package's do.

``save_checkpoint`` writes asynchronously by default: the file write is
pushed to the dependency engine (``engine.py``) under a write variable
of its prefix, so the checkpoints of one prefix land in order while
training goes on; ``keep_n`` keeps the newest epochs; ``load_checkpoint``,
``find_latest_checkpoint`` and ``nd.waitall`` fence the writes, and
``fit`` fences them before it returns. ``fit`` takes ``monitor`` (the
per-batch loop, with the monitor's taps) and ``work_load_list``.

``fit(resume=True)`` (or a prefix) restarts from the newest valid
checkpoint of the prefix, as the JAX package's does.

The training guardian (``MXNET_GUARDIAN=1``, ``resilience/guardian.py``)
guards both loops as the JAX package's do (``model.py:141-278``,
``:379-580``): the per-batch loop reads each step's verdict from the
updater's device sentinel after the metric, the scanned loop from the
chunk's per-step flags at its drain; a poisoned streak of
``MXNET_GUARDIAN_MAX_SKIPS`` rolls back to the in-memory ring (weights,
optimizer states, aux) or the newest checkpoint. ``save_checkpoint``
fires the ``ckpt.write`` fault point between the temporary file and its
rename. Telemetry (``MXNET_TELEMETRY=1``) gets the JAX package's
``epoch``/``batch``/``chunk`` spans and the ``train.step_secs``
histogram and ``train.samples_per_sec`` gauge of the per-batch loop;
mxprof (``MXNET_PROF=1``) a ``step_breakdown`` record per batch
(``train.batch``) or per chunk (``train.scanned``), the first call of a
program left out.
"""
from __future__ import annotations

import logging
import os
import re
import threading
import time
from collections import namedtuple

import numpy as _np
import torch

from . import telemetry as _tel
from .analysis import compile_verify as _cv
from .base import MXNetError
from .context import Context, cpu, current_context
from .resilience import faults as _faults
from .resilience import guardian as _guardian
from .telemetry import prof as _prof
from .ndarray import NDArray, array, load as nd_load, save as nd_save, zeros
from . import io
from . import metric as metric_mod
from . import optimizer as opt
from .executor_manager import DataParallelExecutorManager, _check_arguments
from .initializer import Uniform
from .symbol import Symbol, load as sym_load

__all__ = ["FeedForward", "save_checkpoint", "load_checkpoint",
           "find_latest_checkpoint", "fence_checkpoint", "params_from_numpy",
           "BatchEndParam"]

BatchEndParam = namedtuple(
    "BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])


def params_from_numpy(arg_params, aux_params=None, ctx=None):
    """Numpy dicts of parameters (from the JAX package or anywhere) ->
    NDArray dicts on ``ctx``; returns ``(arg_params, aux_params)``."""
    ctx = ctx or current_context()
    args = {k: array(_np.asarray(v), ctx=ctx) for k, v in arg_params.items()}
    auxs = {k: array(_np.asarray(v), ctx=ctx)
            for k, v in (aux_params or {}).items()}
    return args, auxs


def _desc_name(d):
    return d.name if isinstance(d, io.DataDesc) else d[0]


def _desc_shape(d):
    return tuple(d.shape if isinstance(d, io.DataDesc) else d[1])


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)`` (ref: python/mxnet/model.py:39):
    a name on one device that is not a dist type is no store; a
    ``local`` store whose largest parameter has fewer than 16M elements
    updates on the devices; an object is used as it is."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            from . import kvstore as kvs

            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(_np.prod(param.shape)
                               for param in arg_params.values())
                if max_size < 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        kv = kvstore
    if kv is None:
        update_on_kvstore = False
    return (kv, update_on_kvstore)


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """ref: model.py:87: one key a parameter, pulled into every
    device's copy when the store updates."""
    for idx, param_on_devs in enumerate(param_arrays):
        kvstore.init(idx, arg_params[param_names[idx]])
        if update_on_kvstore:
            kvstore.pull(idx, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore):
    """ref: model.py:97: push the devices' gradients, pull the updated
    weights into every device's copy."""
    for index, pair in enumerate(zip(param_arrays, grad_arrays)):
        arg_list, grad_list = pair
        if grad_list[0] is None:
            continue
        # grad.nan/loss.spike chaos points (no-op unless armed): only
        # for a store with no in-process updater — one with an updater
        # injects inside get_updater already
        if getattr(kvstore, "_updater", None) is None:
            grad_list = [g if g is None else _guardian.corrupt_grad(g)
                         for g in grad_list]
        kvstore.push(index, grad_list, priority=-index)
        kvstore.pull(index, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """ref: model.py:107: with a store, its sum replaces every device's
    gradient first; then one updater call a device, index
    ``index * num_device + k``."""
    for index, pair in enumerate(zip(param_arrays, grad_arrays)):
        arg_list, grad_list = pair
        if grad_list[0] is None:
            continue
        if kvstore:
            kvstore.push(index, grad_list, priority=-index)
            kvstore.pull(index, grad_list, priority=-index)
        for k, p in enumerate(zip(arg_list, grad_list)):
            w, g = p
            updater(index * num_device + k, g, w)


def _multiple_callbacks(callbacks, *args, **kwargs):
    if isinstance(callbacks, list):
        for cb in callbacks:
            cb(*args, **kwargs)
        return
    if callbacks:
        callbacks(*args, **kwargs)


# -- the scanned fit (parallel/fit_trainer.py) ---------------------------------
def _scan_k():
    """Steps fused per chunk in the scanned fit; 0 disables it."""
    if os.environ.get("MXNET_SCAN_TRAIN", "1") in ("0", "false", "off"):
        return 0
    return int(os.environ.get("MXNET_TRAIN_SCAN_K", "8"))


def _buffer_batch(data_batch, input_names):
    """Snapshot one DataBatch for deferred staging (shared by the two
    scanned loops): ``stage_chunk`` reads these values up to K batches
    after the iterator has moved on, and a torch tensor is mutable, so
    each is copied (NDArrays unwrapped to their tensors first)."""
    arrs = [(a._data if isinstance(a, NDArray) else a)
            for a in list(data_batch.data) + list(data_batch.label)]
    arrs = [a.clone() if isinstance(a, torch.Tensor) else _np.array(a)
            for a in arrs]
    return dict(zip(input_names, arrs))


def _sync_event(device):
    """A CUDA event recorded on ``device``'s current stream (None on
    the host): the mxprof clock for when queued device work ends."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _scan_flush(trainer, buf, epoch, nbatch0, guardian=None):
    """Queue one K-batch chunk; returns the pending record drained
    after the NEXT chunk is queued (shared by FeedForward's
    ``_train_scanned`` and ``Module._try_scanned_fit``). The "chunk"
    span covers staging + queueing. Guardian snapshots are captured
    HERE, before the chunk mutates the trainer state: the state is then
    the previous chunk's result, which the drain running alongside
    verifies, and the payload joins the ring only after that
    verification passes (``commit_snapshot``). Under mxprof the staging
    is the host phase and ``run_chunk`` the dispatch phase; the drain
    measures the device and D2H phases. A chunk whose program was
    attributed on this call is not recorded."""
    with _tel.span("chunk"):
        snap = None
        if guardian is not None and guardian.snapshot_due():
            snap = trainer.snapshot_state()
        if _prof.ENABLED:
            n_attr = _prof.attribution_count()
            t0 = time.monotonic()
            staged = trainer.stage_chunk(buf)
            t1 = time.monotonic()
            outs = trainer.run_chunk(staged)
            t2 = time.monotonic()
            prof_ctx = (trainer.last_program_key, t1 - t0, t2 - t1,
                        _sync_event(trainer._device)) \
                if _prof.attribution_count() == n_attr else None
        else:
            outs = trainer.run_chunk(trainer.stage_chunk(buf))
            prof_ctx = None
        return (outs, trainer.take_step_flags(), snap, buf, epoch, nbatch0,
                prof_ctx)


def _scan_epoch(trainer, batches, epoch, K, drain, guardian=None):
    """Queue an epoch's batches K at a time (the tail a smaller chunk),
    each chunk drained after the next is queued (shared by the two
    scanned loops)."""
    pending, buf, nbatch = None, [], 0

    def flush():
        nonlocal pending, buf
        queued = _scan_flush(trainer, buf, epoch, nbatch - len(buf),
                             guardian=guardian)
        drain(pending)
        pending, buf = queued, []

    for data_batch in batches:
        buf.append(_buffer_batch(data_batch, trainer.input_names))
        nbatch += 1
        if len(buf) == K:
            flush()
    if buf:
        flush()
    drain(pending)
    if guardian is not None:
        guardian.end_epoch()  # no chunk in flight across the boundary


def _host_pull(tensors):
    """Device tensors as host numpy arrays (bf16 as f32, which numpy
    lacks), with one synchronisation for all of them: on a card every
    copy is queued without blocking and the stream is waited on once."""
    tensors = [t.float() if t.dtype == torch.bfloat16 else t
               for t in tensors]
    dev = tensors[0].device if tensors else None
    if dev is None or dev.type != "cuda":
        return [t.cpu().numpy() for t in tensors]
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(dev).synchronize()
    return [h.numpy() for h in host]


def _scan_drain(pending, eval_metric, label_names, batch_end_callback,
                nbatch_base, guardian=None):
    """The metric and the per-batch callbacks of a queued chunk; the
    copy of its outputs (and of the guardian's per-step flags) to the
    host is the chunk's one synchronisation. ``nbatch_base``:
    FeedForward numbers batches from 1, Module from 0. Accuracy needs
    only each sample's argmax, so a single [K, N, C] head is reduced to
    [K, N] class ids on the card first. Returns the guardian's chunk
    verdict ("ok"/"skip"/"rollback"; "ok" when unguarded) — the caller
    owns acting on a rollback."""
    if pending is None:
        return "ok"
    outs, flags, snap, bufs, epoch, nbatch0, prof_ctx = pending
    if guardian is not None:
        # the snapshot captured at this chunk's flush is the PREVIOUS
        # chunk's result, verified by the drain that ran alongside that
        # flush — commit it before accounting this chunk's flags
        guardian.commit_snapshot(snap)
    if prof_ctx is not None:
        # device phase: how long the drain truly waits on the chunk's
        # kernels (zero when the card finished while the host staged
        # the next chunk)
        td = time.monotonic()
        if prof_ctx[3] is not None:
            prof_ctx[3].synchronize()
        t_device = time.monotonic() - td
        td = time.monotonic()
    if (type(eval_metric) is metric_mod.Accuracy and len(outs) == 1
            and outs[0].dim() == 3):
        pulled = [outs[0].argmax(dim=-1)]
    else:
        pulled = list(outs)
    # the chunk's heads: one D2H a head (the guardian's flags ride along)
    _cv.note_d2h(sum(t.numel() * t.element_size() for t in pulled),
                 "mxnet_tpu_torch/model.py::_scan_drain")
    if flags is not None:
        pulled += [flags[0], flags[1]]
    host_outs = _host_pull(pulled)
    if flags is not None:
        host_outs, flags = host_outs[:-2], (host_outs[-2], host_outs[-1])
    if prof_ctx is not None:
        key, t_host, t_dispatch, _ev = prof_ctx
        samples = None
        if host_outs and getattr(host_outs[0], "ndim", 0) >= 2:
            samples = int(host_outs[0].shape[0] * host_outs[0].shape[1])
        _prof.note_step(
            "train.scanned",
            {"host": t_host, "dispatch": t_dispatch, "device": t_device,
             "d2h": time.monotonic() - td},
            key=key, batches=len(bufs), samples=samples)
    losses = [] if guardian is not None else None
    for k, b in enumerate(bufs):
        labels = [NDArray(b[n], cpu()) for n in label_names]
        preds = [NDArray(h[k], cpu()) for h in host_outs]
        eval_metric.update(labels, preds)
        if losses is not None:
            losses.append(guardian.metric_step_loss())
        if batch_end_callback is not None:
            _multiple_callbacks(batch_end_callback, BatchEndParam(
                epoch=epoch, nbatch=nbatch0 + k + nbatch_base,
                eval_metric=eval_metric, locals=locals()))
    if guardian is not None:
        return guardian.drain_chunk(flags, losses)
    return "ok"


def _train_scanned(trainer, symbol, ctx0, param_names, aux_names, arg_params,
                   aux_params, begin_epoch, end_epoch, epoch_size, optimizer,
                   train_data, eval_data, eval_metric, epoch_end_callback,
                   batch_end_callback, logger, eval_batch_end_callback, K,
                   guardian=None):
    """The scanned single-device loop: the per-batch loop's metrics,
    callbacks (after their chunk) and epoch checkpoints, with the steps
    run K at a time by ``trainer``."""
    label_names = [_desc_name(d) for d in train_data.provide_label]
    eval_exe = None

    def _drain(pending):
        action = _scan_drain(pending, eval_metric, label_names,
                             batch_end_callback, nbatch_base=1,
                             guardian=guardian)
        if guardian is not None and action == "rollback":
            guardian.rollback(trainer.restore_state,
                              disk_restore_fn=trainer.load_params,
                              data_iter=train_data)

    def _epoch_batches(epoch):
        """The per-batch loop's epoch: ``epoch_size`` batches, resetting
        the iterator at its end as often as that takes."""
        nbatch = 0
        while True:
            do_reset = True
            for data_batch in train_data:
                nbatch += 1
                yield data_batch
                if epoch_size is not None and nbatch >= epoch_size:
                    do_reset = False
                    break
            if do_reset:
                logger.info("Epoch[%d] Resetting Data Iterator", epoch)
                train_data.reset()
            if epoch_size is None or nbatch >= epoch_size:
                break

    train_data.reset()
    for epoch in range(begin_epoch, end_epoch):
        tic = time.time()
        eval_metric.reset()
        with _tel.span("epoch"):
            _scan_epoch(trainer, _epoch_batches(epoch), epoch, K, _drain,
                        guardian=guardian)
        logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)
        trainer.write_back(arg_params, aux_params, aux_names)
        _multiple_callbacks(epoch_end_callback, epoch, symbol, arg_params,
                            aux_params)
        if eval_data:
            if eval_exe is None:
                eval_shapes = {
                    _desc_name(d): _desc_shape(d)
                    for d in list(eval_data.provide_data)
                    + list(eval_data.provide_label)}
                eval_exe = symbol.simple_bind(ctx0, grad_req="null",
                                              **eval_shapes)
            eval_exe.copy_params_from(arg_params, aux_params)
            eval_metric.reset()
            eval_data.reset()
            eval_label_names = [_desc_name(d)
                                for d in eval_data.provide_label]
            eval_data_names = [_desc_name(d) for d in eval_data.provide_data]
            for i, eval_batch in enumerate(eval_data):
                for n, a in zip(eval_data_names, eval_batch.data):
                    a.copyto(eval_exe.arg_dict[n])
                for n, a in zip(eval_label_names, eval_batch.label):
                    if n in eval_exe.arg_dict:
                        a.copyto(eval_exe.arg_dict[n])
                eval_exe.forward(is_train=False)
                eval_metric.update(eval_batch.label, eval_exe.outputs)
                if eval_batch_end_callback is not None:
                    _multiple_callbacks(eval_batch_end_callback, BatchEndParam(
                        epoch=epoch, nbatch=i, eval_metric=eval_metric,
                        locals=locals()))
            for name, value in eval_metric.get_name_value():
                logger.info("Epoch[%d] Validation-%s=%f", epoch, name, value)
            eval_data.reset()


def _train_multi_device(symbol, ctx, arg_names, param_names, aux_names,
                        arg_params, aux_params, begin_epoch, end_epoch,
                        epoch_size, optimizer, train_data, eval_data=None,
                        eval_metric=None, epoch_end_callback=None,
                        batch_end_callback=None, logger=None,
                        eval_batch_end_callback=None, sym_gen=None,
                        compute_dtype=None, work_load_list=None,
                        monitor=None, kvstore=None, update_on_kvstore=False):
    """The scanned fit where it applies (one device, no kvstore), else
    the per-batch loop over every device."""
    if logger is None:
        logger = logging
    # training-run guardian (MXNET_GUARDIAN=1): None when off — every
    # hook below reduces to a None check
    guard = _guardian.TrainingGuardian.create(
        kvstore=kvstore, epoch_end_callback=epoch_end_callback, logger=logger)
    if guard is not None:
        if eval_metric is not None:
            guard.attach_metric(eval_metric)  # loss-like metrics only
        guard.attach_data_iter(train_data)
    K = _scan_k()
    scan_attempted = False
    if (K > 1 and len(ctx) == 1 and kvstore is None and not update_on_kvstore
            and sym_gen is None and monitor is None
            and work_load_list is None):
        from .parallel.fit_trainer import make_fit_trainer, supports_optimizer

        if supports_optimizer(optimizer):
            input_shapes = {
                _desc_name(d): _desc_shape(d)
                for d in (list(train_data.provide_data)
                          + list(train_data.provide_label))}
            # only an ineligible graph falls back: any other error while
            # the trainer is built on the card propagates
            try:
                trainer = make_fit_trainer(
                    symbol, ctx[0], input_shapes, optimizer, arg_params,
                    aux_params, param_names, compute_dtype=compute_dtype)
            except MXNetError as e:
                logger.debug("scanned fit unavailable (%s); using the "
                             "per-batch loop", e)
                trainer = None
            if trainer is not None:
                return _train_scanned(
                    trainer, symbol, ctx[0], param_names, aux_names,
                    arg_params, aux_params, begin_epoch, end_epoch,
                    epoch_size, optimizer, train_data, eval_data,
                    eval_metric, epoch_end_callback, batch_end_callback,
                    logger, eval_batch_end_callback, K, guardian=guard)
            scan_attempted = True
    if compute_dtype is not None:
        # mixed precision rides the scanned trainer; the per-batch loop
        # trains in the arrays' dtype (f32)
        logger.warning(
            "compute_dtype=%s requested but the scanned fit fast path is "
            "unavailable (%s); training proceeds in the parameter dtype",
            compute_dtype,
            "construction failed" if scan_attempted else "eligibility")
    _train_per_batch(symbol, ctx, arg_names, param_names, aux_names,
                     arg_params, aux_params, begin_epoch, end_epoch,
                     epoch_size, optimizer, train_data, eval_data,
                     eval_metric, epoch_end_callback, batch_end_callback,
                     logger, eval_batch_end_callback, sym_gen,
                     work_load_list, monitor, kvstore, update_on_kvstore,
                     guard=guard)


def _train_per_batch(symbol, ctx, arg_names, param_names, aux_names,
                     arg_params, aux_params, begin_epoch, end_epoch,
                     epoch_size, optimizer, train_data, eval_data,
                     eval_metric, epoch_end_callback, batch_end_callback,
                     logger, eval_batch_end_callback, sym_gen,
                     work_load_list=None, monitor=None, kvstore=None,
                     update_on_kvstore=False, guard=None):
    """The per-batch training loop over the devices of ``ctx``
    (``mxnet_tpu/model.py:491-566``): gradients are summed and the
    weights updated through ``kvstore`` when it updates, else through
    it and a local updater, else by the local updater alone; a
    ``monitor`` is installed on the executors and ticks around each
    step."""
    executor_manager = DataParallelExecutorManager(
        symbol=symbol, sym_gen=sym_gen, ctx=ctx, train_data=train_data,
        param_names=param_names, arg_names=arg_names, aux_names=aux_names,
        work_load_list=work_load_list, logger=logger)
    if monitor:
        executor_manager.install_monitor(monitor)
    executor_manager.set_params(arg_params, aux_params)
    updater = None if update_on_kvstore else opt.get_updater(optimizer)
    if kvstore:
        _initialize_kvstore(
            kvstore=kvstore, param_arrays=executor_manager.param_arrays,
            arg_params=arg_params, param_names=executor_manager.param_names,
            update_on_kvstore=update_on_kvstore)
    if update_on_kvstore:
        kvstore.set_optimizer(optimizer)

    # the updater whose device sentinel the guardian reads per step:
    # the local closure, or the one kvstore.set_optimizer installed
    guard_updater = None
    if guard is not None:
        guard_updater = getattr(kvstore, "_updater", None) \
            if update_on_kvstore else updater

    def _guard_snapshot():
        executor_manager.copy_to(arg_params, aux_params)
        return ({k: _guardian._host_copy(v) for k, v in arg_params.items()},
                {k: _guardian._host_copy(v) for k, v in aux_params.items()},
                _guardian.snapshot_updater_states(guard_updater))

    def _guard_restore(payload):
        args, auxs, opt_states = payload
        for k, v in args.items():
            arg_params[k][:] = v
        for k, v in auxs.items():
            aux_params[k][:] = v
        executor_manager.set_params(arg_params, aux_params)
        _guardian.restore_updater_states(guard_updater, opt_states)

    def _guard_disk_restore(args, auxs):
        for k, v in args.items():
            if k in arg_params:
                arg_params[k][:] = v
        for k, v in auxs.items():
            if k in aux_params:
                aux_params[k][:] = v
        executor_manager.set_params(arg_params, aux_params)
        # no optimizer state in a .params checkpoint: drop the momenta
        _guardian.zero_updater_states(guard_updater)

    devices = sorted({c.torch_device for c in ctx}, key=str)

    def _train_one_batch(data_batch, epoch, nbatch, eval_metric):
        """One optimizer step, in a "batch" span nested under the epoch
        span; step walltime and samples/sec feed the train.* metrics."""
        step_tic = time.monotonic() if _tel.ENABLED else 0.0
        # mxprof: fenced sub-phase stamps — host input prep, fwd/bwd
        # dispatch, the wait on the card, optimizer update, metric D2H
        prof_t = {"update": 0.0, "d2h": 0.0} if _prof.ENABLED else None
        n_attr = _prof.attribution_count() if prof_t is not None else 0

        def _timed(fn, slot):
            if prof_t is None:
                return fn()
            t = time.monotonic()
            try:
                return fn()
            finally:
                prof_t[slot] += time.monotonic() - t

        t0 = time.monotonic() if prof_t is not None else 0.0
        executor_manager.load_data_batch(data_batch)
        if monitor is not None:
            monitor.tic()
        t1 = time.monotonic() if prof_t is not None else 0.0
        executor_manager.forward(is_train=True)
        executor_manager.backward()
        if prof_t is not None:
            t2 = time.monotonic()
            prof_t["host"] = t1 - t0
            prof_t["dispatch"] = t2 - t1
            # device phase: the kernels are queued; without this wait
            # their time would land in update/d2h and a compute-bound
            # run would read host-bound (paid only under MXNET_PROF=1)
            for dev in devices:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            prof_t["device"] = time.monotonic() - t2

        def _do_update():
            if update_on_kvstore:
                _update_params_on_kvstore(executor_manager.param_arrays,
                                          executor_manager.grad_arrays,
                                          kvstore)
            else:
                _update_params(executor_manager.param_arrays,
                               executor_manager.grad_arrays, updater=updater,
                               num_device=len(ctx), kvstore=kvstore)

        if guard is None:
            _timed(_do_update, "update")
            if monitor is not None:
                monitor.toc_print()
            _timed(lambda: executor_manager.update_metric(
                eval_metric, data_batch.label), "d2h")
        else:
            # metric BEFORE the guarded update: outputs don't depend on
            # it, and the guardian's loss feed reads this batch's delta
            _timed(lambda: executor_manager.update_metric(
                eval_metric, data_batch.label), "d2h")
            action = _timed(lambda: guard.guard_batch(
                _do_update,
                grad_arrays_fn=lambda: [
                    g[0] for g in executor_manager.grad_arrays
                    if g and g[0] is not None],
                updater=guard_updater), "update")
            if action == "rollback":
                guard.rollback(_guard_restore,
                               disk_restore_fn=_guard_disk_restore,
                               data_iter=train_data)
            else:
                guard.maybe_snapshot(_guard_snapshot)
            if monitor is not None:
                monitor.toc_print()
        if prof_t is not None and _prof.attribution_count() == n_attr:
            # a batch whose forward attributed a program is left out
            _prof.note_step("train.batch", prof_t, batches=1,
                            samples=train_data.batch_size)
        if _tel.ENABLED:
            dt = time.monotonic() - step_tic
            _tel.histogram("train.step_secs").observe(dt)
            if dt > 0:
                _tel.gauge("train.samples_per_sec").set(
                    train_data.batch_size / dt)
        if batch_end_callback is not None:
            batch_end_params = BatchEndParam(
                epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                locals=dict(locals(), executor_manager=executor_manager,
                            symbol=symbol, arg_params=arg_params,
                            aux_params=aux_params))
            _multiple_callbacks(batch_end_callback, batch_end_params)

    def _train_one_epoch(epoch):
        tic = time.time()
        eval_metric.reset()
        nbatch = 0
        while True:
            do_reset = True
            for data_batch in train_data:
                nbatch += 1
                with _tel.span("batch"):
                    _train_one_batch(data_batch, epoch, nbatch, eval_metric)
                if epoch_size is not None and nbatch >= epoch_size:
                    do_reset = False
                    break
            if do_reset:
                logger.info("Epoch[%d] Resetting Data Iterator", epoch)
                train_data.reset()
            if epoch_size is None or nbatch >= epoch_size:
                break
        toc = time.time()
        logger.info("Epoch[%d] Time cost=%.3f", epoch, toc - tic)

        if epoch_end_callback or epoch + 1 == end_epoch:
            executor_manager.copy_to(arg_params, aux_params)
        _multiple_callbacks(epoch_end_callback, epoch, symbol, arg_params,
                            aux_params)

        if eval_data:
            eval_metric.reset()
            eval_data.reset()
            for i, eval_batch in enumerate(eval_data):
                executor_manager.load_data_batch(eval_batch)
                executor_manager.forward(is_train=False)
                executor_manager.update_metric(eval_metric, eval_batch.label)
                if eval_batch_end_callback is not None:
                    _multiple_callbacks(eval_batch_end_callback, BatchEndParam(
                        epoch=epoch, nbatch=i, eval_metric=eval_metric,
                        locals=locals()))
            for name, value in eval_metric.get_name_value():
                logger.info("Epoch[%d] Validation-%s=%f", epoch, name, value)
            eval_data.reset()

    train_data.reset()
    for epoch in range(begin_epoch, end_epoch):
        with _tel.span("epoch"):
            _train_one_epoch(epoch)


_ckpt_vars = {}  # prefix -> engine write-var serializing its checkpoints
_ckpt_vars_lock = threading.Lock()  # guards check-then-insert on _ckpt_vars


def fence_checkpoint(prefix):
    """Block until all queued async checkpoint writes of `prefix` have
    landed (no-op when none are pending)."""
    with _ckpt_vars_lock:
        var = _ckpt_vars.get(prefix)
    if var is not None:
        var._engine.wait_for_var(var)


def _write_params_atomic(param_name, save_dict):
    """Crash-safe params write: tmp file → fsync → atomic rename →
    best-effort directory fsync, so ``param_name`` is always absent, the
    previous complete file or the new one. Stream URIs (s3:// etc.) have
    no rename; they keep the plain write."""
    if "://" in param_name:
        nd_save(param_name, save_dict)
        return
    tmp = "%s.tmp-%d" % (param_name, os.getpid())
    nd_save(tmp, save_dict)
    # the injected crash window: tmp written, final name untouched —
    # recovery must see the previous epoch, never a torn file
    _faults.point("ckpt.write")
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, param_name)
    dirfd = None
    try:  # durability of the rename itself
        dirfd = os.open(os.path.dirname(os.path.abspath(param_name)),
                        os.O_RDONLY)
        os.fsync(dirfd)
    except OSError:
        pass
    finally:
        if dirfd is not None:
            os.close(dirfd)


_CKPT_RE = re.compile(r"-(\d{4,})\.params")


def _checkpoint_epochs(prefix):
    """Epochs with an existing `prefix-NNNN.params`, newest first.
    The suffix is FULL-matched so a sibling run's longer prefix
    ('model-ft-0006.params' while scanning 'model') can neither inject
    phantom epochs nor get its files pruned by this run."""
    d = os.path.dirname(os.path.abspath(prefix)) or "."
    base = os.path.basename(prefix)
    epochs = []
    try:
        names = os.listdir(d)
    except OSError:
        return []
    for fn in names:
        if not fn.startswith(base + "-"):
            continue
        m = _CKPT_RE.fullmatch(fn[len(base):])
        if m is not None:
            epochs.append(int(m.group(1)))
    return sorted(set(epochs), reverse=True)


def _prune_checkpoints(prefix, keep_n):
    """Rolling retention: keep the newest `keep_n` epochs of `prefix`,
    delete the rest — including stranded tmp siblings from crashed
    writes and the epoch's optimizer `.states` sidecar. Best-effort —
    retention must never fail a training step."""
    import glob as _glob

    for epoch in _checkpoint_epochs(prefix)[keep_n:]:
        path = "%s-%04d.params" % (prefix, epoch)
        try:
            os.remove(path)
            logging.info('Pruned old checkpoint "%s"', path)
        except OSError:
            pass
        stale = _glob.glob(_glob.escape(path) + ".tmp-*")
        stale.append("%s-%04d.states" % (prefix, epoch))
        for f in stale:
            try:
                os.remove(f)
            except OSError:
                pass


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    sync=False, keep_n=None):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``
    (ref: python/mxnet/model.py:311).

    Async by default: the parameters are copied to the host now, and the
    file write is pushed to the dependency engine under a write variable
    of ``prefix`` (checkpoints of one prefix land in order; different
    prefixes overlap), fenced by ``fence_checkpoint``, ``nd.waitall()``
    and the end of ``fit``. ``sync=True`` or ``MXNET_ENGINE_TYPE=
    NaiveEngine`` writes before returning. The params file lands via tmp
    + fsync + atomic rename; ``keep_n`` keeps only the newest ``keep_n``
    epochs of this prefix after a successful write."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    # snapshot the parameters now: later updates must not leak into the
    # checkpoint being written
    save_dict = {("arg:%s" % k): v._data.detach().to("cpu", copy=True)
                 for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v._data.detach().to("cpu", copy=True)
                      for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)

    def _write():
        _write_params_atomic(param_name, save_dict)
        logging.info('Saved checkpoint to "%s"', param_name)
        if keep_n is not None and keep_n >= 1:
            _prune_checkpoints(prefix, int(keep_n))

    if sync:
        fence_checkpoint(prefix)
        _write()
        return
    from . import engine as _engine

    eng = _engine.Engine.get()
    with _ckpt_vars_lock:
        var = _ckpt_vars.get(prefix)
        if var is None or var._engine is not eng:
            var = _ckpt_vars[prefix] = eng.new_variable()
    eng.push(_write, mutable_vars=[var])


def find_latest_checkpoint(prefix):
    """The newest epoch whose ``prefix-NNNN.params`` loads, or None;
    a corrupt or partial file is skipped with a warning (the JAX
    package's ``find_latest_checkpoint``, checked by loading). Fences
    the prefix's in-flight writes first."""
    fence_checkpoint(prefix)
    for epoch in _checkpoint_epochs(prefix):
        path = "%s-%04d.params" % (prefix, epoch)
        try:
            nd_load(path)
        except (MXNetError, OSError):
            logging.warning('Skipping corrupt/partial checkpoint "%s"', path)
            continue
        return epoch
    return None


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` with the arrays on the
    host (ref: python/mxnet/model.py:341). Fences any in-flight async
    checkpoint of this prefix before reading."""
    fence_checkpoint(prefix)
    symbol = sym_load("%s-symbol.json" % prefix)
    save_dict = nd_load("%s-%04d.params" % (prefix, epoch))
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return (symbol, arg_params, aux_params)


def _load_data(batch, targets):
    for d_src, d_target in zip(batch.data, targets):
        d_src.copyto(d_target)


class FeedForward:
    """The estimator API (ref: python/mxnet/model.py:378)."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=Uniform(0.01),
                 numpy_batch_size=128, arg_params=None, aux_params=None,
                 allow_extra_params=False, begin_epoch=0, compute_dtype=None,
                 **kwargs):
        if isinstance(symbol, Symbol):
            self.symbol = symbol
            self.sym_gen = None
        elif callable(symbol):
            self.symbol = None
            self.sym_gen = symbol
        else:
            raise MXNetError("FeedForward takes a Symbol or a bucketing "
                             "symbol generator, got %r" % (symbol,))
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.argument_checked = False
        if self.sym_gen is None:
            self._check_arguments()
        if ctx is None:
            ctx = [current_context()]
        elif isinstance(ctx, Context):
            ctx = [ctx]
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = kwargs.copy()
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self._pred_exec = None
        self.begin_epoch = begin_epoch
        # mixed precision through the scanned fit (f32 master weights,
        # ``compute_dtype`` products; parallel/fit_trainer.py); None is
        # f32, or MXNET_COMPUTE_DTYPE=bfloat16 process-wide
        self.compute_dtype = (
            compute_dtype if compute_dtype is not None
            else os.environ.get("MXNET_COMPUTE_DTYPE") or None)

    def _check_arguments(self):
        if self.argument_checked:
            return
        assert self.symbol is not None
        self.argument_checked = True
        _check_arguments(self.symbol)
        if self.allow_extra_params:
            if self.arg_params:
                arg_names = set(self.symbol.list_arguments())
                self.arg_params = {k: v for k, v in self.arg_params.items()
                                   if k in arg_names}
            if self.aux_params:
                aux_names = set(self.symbol.list_auxiliary_states())
                self.aux_params = {k: v for k, v in self.aux_params.items()
                                   if k in aux_names}

    def _init_params(self, inputs, overwrite=False):
        inputs = [x if isinstance(x, io.DataDesc) else io.DataDesc(*x)
                  for x in inputs]
        input_shapes = {item.name: item.shape for item in inputs}
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        assert arg_shapes is not None
        arg_names = self.symbol.list_arguments()
        input_names = input_shapes.keys()
        param_names = [key for key in arg_names if key not in input_names]
        aux_names = self.symbol.list_auxiliary_states()

        ctx = self.ctx[0]
        arg_params = {k: zeros(s, ctx) for k, s in zip(arg_names, arg_shapes)
                      if k in param_names}
        aux_params = {k: zeros(s, ctx) for k, s in zip(aux_names, aux_shapes)}

        for k, v in arg_params.items():
            if self.arg_params and k in self.arg_params and not overwrite:
                arg_params[k][:] = self.arg_params[k]
            else:
                self.initializer(k, v)
        for k, v in aux_params.items():
            if self.aux_params and k in self.aux_params and not overwrite:
                aux_params[k][:] = self.aux_params[k]
            else:
                self.initializer(k, v)

        self.arg_params = arg_params
        self.aux_params = aux_params
        return (arg_names, list(param_names), aux_names)

    def _init_predictor(self, input_shapes, type_dict=None):
        if self._pred_exec is not None:
            arg_shapes, _, _ = self.symbol.infer_shape(**dict(input_shapes))
            assert arg_shapes is not None, "Incomplete input shapes"
            pred_shapes = [x.shape for x in self._pred_exec.arg_arrays]
            if arg_shapes == pred_shapes:
                return
        pred_exec = self.symbol.simple_bind(
            self.ctx[0], grad_req="null", type_dict=type_dict,
            **dict(input_shapes))
        pred_exec.copy_params_from(self.arg_params, self.aux_params)
        self._pred_exec = pred_exec

    def _init_iter(self, X, y, is_train):
        if isinstance(X, (_np.ndarray, NDArray)):
            if y is None:
                if is_train:
                    raise ValueError("y must be specified when X is numpy.ndarray")
                y = _np.zeros(X.shape[0])
            if not isinstance(y, (_np.ndarray, NDArray)):
                raise TypeError("y must be ndarray when X is numpy.ndarray")
            X = X.asnumpy() if isinstance(X, NDArray) else X
            y = y.asnumpy() if isinstance(y, NDArray) else y
            if X.shape[0] != y.shape[0]:
                raise ValueError("The numbers of data points and labels not equal")
            if y.ndim == 2 and y.shape[1] == 1:
                y = y.flatten()
            if y.ndim != 1:
                raise ValueError("Label must be 1D or 2D (with 2nd dimension being 1)")
            if is_train:
                return io.NDArrayIter(
                    X, y, int(min(X.shape[0] // 2, self.numpy_batch_size)),
                    shuffle=is_train, last_batch_handle="roll_over")
            return io.NDArrayIter(
                X, y, int(min(X.shape[0], self.numpy_batch_size)),
                shuffle=False)
        if not isinstance(X, io.DataIter):
            raise TypeError("X must be DataIter, NDArray or numpy.ndarray")
        return X

    def _type_dict(self, X):
        type_dict = {k: v.dtype for k, v in self.arg_params.items()}
        for x in X.provide_data:
            type_dict[_desc_name(x)] = (x.dtype if isinstance(x, io.DataDesc)
                                        else _np.float32)
        return type_dict

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        X = self._init_iter(X, None, is_train=False)
        if reset:
            X.reset()
        data_shapes = X.provide_data
        data_names = [x[0] for x in data_shapes]
        self._init_predictor(data_shapes, self._type_dict(X))
        batch_size = X.batch_size
        data_arrays = [self._pred_exec.arg_dict[name] for name in data_names]
        output_list = [[] for _ in range(len(self._pred_exec.outputs))]
        if return_data:
            data_list = [[] for _ in X.provide_data]
            label_list = [[] for _ in X.provide_label]
        i = 0
        for batch in X:
            _load_data(batch, data_arrays)
            self._pred_exec.forward(is_train=False)
            real_size = batch_size - batch.pad
            for o_list, o_nd in zip(output_list, self._pred_exec.outputs):
                o_list.append(o_nd[0:real_size].asnumpy())
            if return_data:
                for j, x in enumerate(batch.data):
                    data_list[j].append(x[0:real_size].asnumpy())
                for j, x in enumerate(batch.label):
                    label_list[j].append(x[0:real_size].asnumpy())
            i += 1
            if num_batch is not None and i == num_batch:
                break
        outputs = [_np.concatenate(x) for x in output_list]
        if len(outputs) == 1:
            outputs = outputs[0]
        if return_data:
            data = [_np.concatenate(x) for x in data_list]
            label = [_np.concatenate(x) for x in label_list]
            if len(data) == 1:
                data = data[0]
            if len(label) == 1:
                label = label[0]
            return outputs, data, label
        return outputs

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        X = self._init_iter(X, None, is_train=False)
        if reset:
            X.reset()
        data_names = [x[0] for x in X.provide_data]
        self._init_predictor(X.provide_data, self._type_dict(X))
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        data_arrays = [self._pred_exec.arg_dict[name] for name in data_names]
        for i, batch in enumerate(X):
            if num_batch is not None and i == num_batch:
                break
            _load_data(batch, data_arrays)
            self._pred_exec.forward(is_train=False)
            eval_metric.update(batch.label, self._pred_exec.outputs)
            if batch_end_callback is not None:
                _multiple_callbacks(batch_end_callback, BatchEndParam(
                    epoch=0, nbatch=i, eval_metric=eval_metric,
                    locals=locals()))
        return eval_metric.get()[1]

    def _resume_from_checkpoint(self, resume, epoch_end_callback, logger):
        """Preemption-safe restart (``mxnet_tpu/model.py:1142-1173``):
        load the newest valid checkpoint of the prefix and continue from
        its epoch. ``resume`` is the prefix, or True to take it from a
        ``do_checkpoint`` epoch-end callback's ``.prefix``. With no
        checkpoint yet the fit starts fresh."""
        prefix = resume if isinstance(resume, str) else None
        if prefix is None:
            cbs = epoch_end_callback if isinstance(epoch_end_callback, list) \
                else [epoch_end_callback]
            for cb in cbs:
                p = getattr(cb, "prefix", None)
                if isinstance(p, str):
                    prefix = p
                    break
        if prefix is None:
            raise MXNetError(
                "fit(resume=True) needs a checkpoint prefix: pass "
                "resume='<prefix>' or a callback.do_checkpoint(prefix) "
                "epoch_end_callback")
        epoch = find_latest_checkpoint(prefix)
        if epoch is None:
            logger.info("resume: no valid checkpoint under prefix %r; "
                        "starting fresh", prefix)
            return
        _sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = epoch
        logger.info("resume: restarting from checkpoint %r epoch %d",
                    prefix, epoch)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_batch_end_callback=None, resume=False):
        """Train for ``num_epoch`` epochs. ``kvstore`` is a KVStore, a
        type name (``_create_kvstore``) or None; ``work_load_list``
        weights the devices' slices of each batch; ``monitor`` installs
        its taps on the per-batch loop; ``resume`` (True or a checkpoint
        prefix) first reloads the newest valid checkpoint and continues
        from its epoch."""
        if logger is None:
            logger = logging
        if resume:
            self._resume_from_checkpoint(resume, epoch_end_callback, logger)
        if work_load_list is not None and (
                not isinstance(work_load_list, list)
                or len(work_load_list) != len(self.ctx)):
            raise MXNetError("work_load_list %r: one entry a device of %s"
                             % (work_load_list, self.ctx))
        data = self._init_iter(X, y, is_train=True)
        if isinstance(eval_data, (tuple, list)) and len(eval_data) == 2:
            eval_data = self._init_iter(eval_data[0], eval_data[1],
                                        is_train=True)
        if self.sym_gen:
            self.symbol = self.sym_gen(data.default_bucket_key)
            self._check_arguments()
        self.kwargs["sym"] = self.symbol

        arg_names, param_names, aux_names = self._init_params(
            data.provide_data + data.provide_label)
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        (kvstore, update_on_kvstore) = _create_kvstore(
            kvstore, len(self.ctx), self.arg_params)
        param_idx2name = {}
        if update_on_kvstore:
            param_idx2name.update(enumerate(param_names))
        else:
            for i, n in enumerate(param_names):
                for k in range(len(self.ctx)):
                    param_idx2name[i * len(self.ctx) + k] = n
        self.kwargs["param_idx2name"] = param_idx2name

        # the rescale is over the whole batch: every device's slice, and
        # every worker's under dist_sync
        if isinstance(self.optimizer, str):
            batch_size = data.batch_size
            if kvstore and "dist" in kvstore.type and "_sync" in kvstore.type:
                batch_size *= kvstore.num_workers
            optimizer = opt.create(self.optimizer,
                                   rescale_grad=(1.0 / batch_size),
                                   **self.kwargs)
        else:
            optimizer = self.optimizer

        _train_multi_device(
            self.symbol, self.ctx, arg_names, param_names, aux_names,
            self.arg_params, self.aux_params,
            begin_epoch=self.begin_epoch, end_epoch=self.num_epoch,
            epoch_size=self.epoch_size, optimizer=optimizer,
            train_data=data, eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback, logger=logger,
            eval_batch_end_callback=eval_batch_end_callback,
            sym_gen=self.sym_gen, compute_dtype=self.compute_dtype,
            work_load_list=work_load_list, monitor=monitor,
            kvstore=kvstore, update_on_kvstore=update_on_kvstore)
        # fence host tasks (async epoch checkpoints): a failed write
        # surfaces here, at the training call site
        from . import engine as _engine

        if _engine.Engine._instance is not None:
            _engine.Engine._instance.wait_for_all()

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        assert epoch is not None
        # explicit save → durable on return (async path is the epoch-end
        # do_checkpoint callback)
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params,
                        self.aux_params, sync=True)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=Uniform(0.01), eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_batch_end_callback=None, **kwargs):
        """Build a FeedForward and fit it (ref: model.py:862)."""
        model = FeedForward(
            symbol, ctx=ctx, num_epoch=num_epoch, epoch_size=epoch_size,
            optimizer=optimizer, initializer=initializer, **kwargs)
        model.fit(
            X, y, eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback,
            kvstore=kvstore, logger=logger, work_load_list=work_load_list,
            eval_batch_end_callback=eval_batch_end_callback)
        return model

"""Module: symbol + contexts + optimizer state
(ref: python/mxnet/module/module.py:1-622).

The port's copy of ``mxnet_tpu/module/module.py``: one executor a
context (a context may repeat: ``[gpu(0), gpu(0)]``), each bound by
``simple_bind`` over its slice of the batch (``work_load_list``
weights the slices; ``shared_exec`` when a ``shared_module`` is given,
as bucketing does), the module's own copies of the parameters on the
first context, and the update through a kvstore or a local updater as
``mxnet_tpu/model.py``'s ``_create_kvstore`` decides
(``init_optimizer``, ``mxnet_tpu/module/module.py:244-288``: the
rescale is one over the whole batch, times the workers under
``dist_sync``; updater indices ``i * num_device + k`` when the devices
update). ``get_outputs``/``get_input_grads`` concatenate the devices'
slices on the host, and the parameters read back are the devices'
copies averaged. What differs from the JAX package, each in so many
words:

- ``fit`` takes the JAX package's scanned path
  (``_try_scanned_fit``, ``parallel/fit_trainer.py``) where it applies:
  ``MXNET_SCAN_TRAIN`` on (the default), one context and no kvstore, a
  scannable optimizer, ``grad_req="write"``, no monitor, labels;
  ``MXNET_COMPUTE_DTYPE`` sets its precision; batches are numbered
  from 0. An ineligible graph (an ``MXNetError`` from the trainer's
  construction) falls back to the per-batch loop with a log line; any
  other error propagates, where the JAX package falls back on every
  exception;
- ``save_optimizer_states`` pickles the port's optimizer object (as the
  JAX package pickles its own), so a ``.states`` file round-trips
  within the port only; like the JAX package's, it holds no momentum
  (that lives in the updater), so a resumed run restarts it at zero;
- ``bind`` of a module whose parameters are initialized (``Module.load``,
  a re-bind) copies them into the new executors, as the reference's
  ``module.py`` does; the JAX package's ``bind`` does not, so there a
  loaded module predicts with zero weights until ``set_params``.
"""
from __future__ import annotations

import logging
import pickle

from ..base import MXNetError
from ..context import Context, cpu, current_context
from ..initializer import Uniform
from ..ndarray import concatenate, zeros
from .. import optimizer as opt
from .. import telemetry as _tel
from ..executor_manager import _split_input_slice
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore)
from .base_module import BaseModule


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, work_load_list=None):
        super().__init__(logger=logger)
        if context is None:
            context = [current_context()]
        if isinstance(context, Context):
            context = [context]
        self._context = context
        if work_load_list is None:
            work_load_list = [1] * len(self._context)
        assert len(work_load_list) == len(self._context)
        self._work_load_list = work_load_list

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._preload_opt_states = None
        self._execs = []
        self._data_shapes = None
        self._label_shapes = None
        self._slices = None

    @staticmethod
    def load(prefix, epoch=None, load_optimizer_states=False, **kwargs):
        """ref: module.py:86. ``epoch=None`` resumes from the newest
        ``prefix-NNNN.params`` that loads (``model.find_latest_checkpoint``)."""
        from ..model import find_latest_checkpoint, load_checkpoint

        if epoch is None:
            epoch = find_latest_checkpoint(prefix)
            if epoch is None:
                raise MXNetError(
                    "Module.load(%r, epoch=None): no valid checkpoint found"
                    % (prefix,))
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        keep_n=None):
        """ref: module.py:119: ``prefix-symbol.json``, ``prefix-NNNN.params``
        (written before returning: tmp file, fsync, atomic rename) and, if
        asked, ``prefix-NNNN.states``; ``keep_n`` keeps only the newest N
        epochs on disk."""
        from ..model import save_checkpoint as _save_ckpt

        self._sync_params_from_devices()
        arg_params, aux_params = self.get_params()
        _save_ckpt(prefix, epoch, self.symbol, arg_params, aux_params,
                   sync=True, keep_n=keep_n)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    # -- properties ------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return [
            (name, tuple(o.shape))
            for name, o in zip(self._output_names, self._execs[0].outputs)
        ]

    def get_params(self):
        """ref: module.py:175. While a scanned fit runs, the freshest
        parameters are the trainer's: they are written back first, so a
        mid-epoch callback never reads the epoch's first weights."""
        live = getattr(self, "_scan_live", None)
        if live is not None:
            trainer, ap, xp = live
            trainer.write_back(ap, xp, self._aux_names)
            return (ap, xp)
        assert self.binded or self._arg_params is not None
        if self.binded and self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    # -- bind ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """ref: module.py:235."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        if not for_training:
            assert not inputs_need_grad

        from ..io import DataDesc

        data_shapes = [
            x if isinstance(x, DataDesc) else DataDesc(*x) for x in data_shapes
        ]
        label_shapes = [
            x if isinstance(x, DataDesc) else DataDesc(*x) for x in (label_shapes or [])
        ]
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes

        batch_size = data_shapes[0].shape[0]
        self._slices = _split_input_slice(batch_size, self._work_load_list)

        self._grad_req = grad_req
        shared_execs = (
            shared_module._execs if shared_module is not None else [None] * len(self._context)
        )
        self._execs = []
        for i, ctx in enumerate(self._context):
            dev_batch = self._slices[i].stop - self._slices[i].start
            shapes = {}
            for d in data_shapes + label_shapes:
                shapes[d.name] = (dev_batch,) + tuple(d.shape[1:])
            reqs = {}
            for name in self._symbol.list_arguments():
                if name in self._param_names:
                    reqs[name] = grad_req if for_training else "null"
                elif inputs_need_grad and name in self._data_names:
                    reqs[name] = grad_req
                else:
                    reqs[name] = "null"
            exec_ = self._symbol.simple_bind(
                ctx, grad_req=reqs, shared_exec=shared_execs[i], **shapes
            )
            self._execs.append(exec_)

        if shared_module is not None and shared_module.params_initialized:
            self.set_params(*shared_module.get_params())
        elif self.params_initialized:
            # a loaded or re-bound module: its parameters go into the new
            # executor (ref: python/mxnet/module/module.py bind; the JAX
            # package's bind leaves them out)
            for exec_ in self._execs:
                exec_.copy_params_from(self._arg_params, self._aux_params)

    def _reset_bind(self):
        self.binded = False
        self._execs = []

    # -- params ----------------------------------------------------------------
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        """ref: module.py:155. The module's own copies of the parameters
        live on its context."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None:
            initializer = Uniform(0.01)

        ctx = self._context[0]
        if self._arg_params is None:
            self._arg_params = {
                name: zeros(self._execs[0].arg_dict[name].shape, ctx,
                            dtype=self._execs[0].arg_dict[name].dtype)
                for name in self._param_names
            }
        if self._aux_params is None:
            self._aux_params = {
                name: zeros(arr.shape, ctx, dtype=arr.dtype)
                for name, arr in zip(self._aux_names, self._execs[0].aux_arrays)
            }

        for name, arr in self._arg_params.items():
            if arg_params is not None and name in arg_params:
                arr[:] = arg_params[name]
            elif not allow_missing or initializer is not None:
                if initializer is not None:
                    initializer(name, arr)
        for name, arr in self._aux_params.items():
            if aux_params is not None and name in aux_params:
                arr[:] = aux_params[name]
            elif initializer is not None:
                initializer(name, arr)

        self.params_initialized = True
        self._params_dirty = False
        for exec_ in self._execs:
            exec_.copy_params_from(self._arg_params, self._aux_params)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        """ref: module.py:422."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        (kvstore, update_on_kvstore) = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        batch_size = self._data_shapes[0].shape[0]
        if kvstore and "dist" in kvstore.type and "_sync" in kvstore.type:
            batch_size *= kvstore.num_workers
        rescale_grad = 1.0 / batch_size

        if isinstance(optimizer, str):
            idx2name = {}
            if update_on_kvstore:
                idx2name.update(enumerate(self._param_names))
            else:
                for k in range(len(self._context)):
                    idx2name.update(
                        {i * len(self._context) + k: n
                         for i, n in enumerate(self._param_names)})
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt.create(
                optimizer, sym=self.symbol, param_idx2name=idx2name, **optimizer_params
            )
        else:
            assert isinstance(optimizer, opt.Optimizer)

        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore:
            _initialize_kvstore(
                kvstore=kvstore, param_arrays=self._param_arrays(),
                arg_params=self._arg_params, param_names=self._param_names,
                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Share another module's optimizer and updater (its state),
        as bucketing does (ref: module.py borrow_optimizer)."""
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    def _param_arrays(self):
        arg_names = self._symbol.list_arguments()
        idx = [arg_names.index(n) for n in self._param_names]
        return [[e.arg_arrays[i] for e in self._execs] for i in idx]

    def _grad_arrays(self):
        arg_names = self._symbol.list_arguments()
        idx = [arg_names.index(n) for n in self._param_names]
        return [[e.grad_arrays[i] for e in self._execs] for i in idx]

    # -- compute ---------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """ref: module.py:459."""
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        self._load_batch(data_batch)
        for exec_ in self._execs:
            exec_.forward(is_train=is_train)

    def _load_batch(self, data_batch):
        for name_list, arrays in (
            (self._data_names, data_batch.data),
            (self._label_names, data_batch.label or []),
        ):
            for name, src in zip(name_list, arrays):
                for exec_, sl in zip(self._execs, self._slices):
                    src[sl].copyto(exec_.arg_dict[name])

    def backward(self, out_grads=None):
        """ref: module.py:468."""
        assert self.binded and self.params_initialized
        for exec_ in self._execs:
            exec_.backward(out_grads=out_grads)

    def update(self):
        """ref: module.py:480: through the kvstore, or one updater call
        a parameter and device, in place."""
        assert self.binded and self.params_initialized and self.optimizer_initialized
        self._params_dirty = True
        if self._update_on_kvstore:
            _update_params_on_kvstore(self._param_arrays(),
                                      self._grad_arrays(), self._kvstore)
        else:
            _update_params(self._param_arrays(), self._grad_arrays(),
                           updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore)

    @staticmethod
    def _merge(per_device):
        """One array an output: the devices' slices concatenated on the
        host (one device: its own arrays)."""
        if len(per_device) == 1:
            return list(per_device[0])
        return [concatenate([per_device[d][i].as_in_context(cpu())
                             for d in range(len(per_device))])
                for i in range(len(per_device[0]))]

    def get_outputs(self, merge_multi_context=True):
        """ref: module.py:500."""
        assert self.binded and self.params_initialized
        outputs = [exec_.outputs for exec_ in self._execs]
        if merge_multi_context:
            return self._merge(outputs)
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        """ref: module.py:518."""
        assert self.binded and self.params_initialized and self.inputs_need_grad
        arg_names = self._symbol.list_arguments()
        idx = [arg_names.index(n) for n in self._data_names]
        grads = [[e.grad_arrays[i] for i in idx] for e in self._execs]
        if merge_multi_context:
            return self._merge(grads)
        return grads

    def update_metric(self, eval_metric, labels):
        """ref: module.py:537."""
        for exec_, sl in zip(self._execs, self._slices):
            labels_slice = [label[sl] for label in labels]
            eval_metric.update(labels_slice, exec_.outputs)

    def _sync_params_from_devices(self):
        """The devices' copies averaged into the module's: the first
        copied, the others added in device order, divided by the count
        (ref: module.py:546)."""
        for names, dicts, dst in (
                (self._param_names, [e.arg_dict for e in self._execs],
                 self._arg_params),
                (self._aux_names, [e.aux_dict for e in self._execs],
                 self._aux_params)):
            for name in names:
                blocks = [d[name] for d in dicts]
                w = blocks[0].copy()
                for b in blocks[1:]:
                    w += b.as_in_context(w.context)
                if len(blocks) > 1:
                    w /= len(blocks)
                w.copyto(dst[name])
        self._params_dirty = False

    def save_optimizer_states(self, fname):
        """ref: module.py:569."""
        assert self.optimizer_initialized
        with open(fname, "wb") as fout:
            fout.write(pickle.dumps(self._optimizer))

    def load_optimizer_states(self, fname):
        """ref: module.py:581."""
        assert self.optimizer_initialized
        with open(fname, "rb") as f:
            self._optimizer = pickle.loads(f.read())
        self._updater = opt.get_updater(self._optimizer)

    def install_monitor(self, mon):
        """ref: module.py:594."""
        assert self.binded
        for exec_ in self._execs:
            mon.install(exec_)

    # -- scanned fast path (parallel/fit_trainer.py) ---------------------------
    def _try_scanned_fit(self, train_data, eval_data, eval_metric,
                         validation_metric, epoch_end_callback,
                         batch_end_callback, eval_end_callback,
                         eval_batch_end_callback, begin_epoch, num_epoch,
                         monitor, guardian=None):
        """Run fit() as K-step chunks when eligible (the path FeedForward
        takes, ``model._train_scanned``): one device, no kvstore, a
        scannable optimizer, ``grad_req="write"``, no monitor. Per-batch
        metrics and callbacks (numbered from 0), per-epoch Train-*
        logging, epoch_end callbacks with written-back parameters, eval
        through score(). Returns False to fall back."""
        import os as _os
        import time as _time

        from ..model import (_desc_name, _desc_shape, _multiple_callbacks,
                             _scan_drain, _scan_epoch, _scan_k)
        from ..parallel.fit_trainer import make_fit_trainer, supports_optimizer

        K = _scan_k()
        if (K <= 1 or len(self._context) != 1 or monitor is not None
                or self._kvstore is not None or self._update_on_kvstore
                or not train_data.provide_label
                or getattr(self, "_grad_req", "write") != "write"
                or not supports_optimizer(self._optimizer)):
            return False
        input_shapes = {
            _desc_name(d): _desc_shape(d)
            for d in (list(train_data.provide_data)
                      + list(train_data.provide_label))
        }
        arg_params, aux_params = self.get_params()
        try:
            trainer = make_fit_trainer(
                self._symbol, self._context[0], input_shapes,
                self._optimizer, arg_params, aux_params, self._param_names,
                compute_dtype=_os.environ.get("MXNET_COMPUTE_DTYPE") or None)
        except MXNetError as e:
            self.logger.debug("scanned fit unavailable (%s); per-batch "
                              "loop", e)
            return False
        label_names = [_desc_name(d) for d in train_data.provide_label]

        def _drain(pending):
            action = _scan_drain(pending, eval_metric, label_names,
                                 batch_end_callback, nbatch_base=0,
                                 guardian=guardian)
            if guardian is not None and action == "rollback":
                guardian.rollback(trainer.restore_state,
                                  disk_restore_fn=trainer.load_params,
                                  data_iter=train_data)

        self._scan_live = (trainer, arg_params, aux_params)
        try:
            for epoch in range(begin_epoch, num_epoch):
                tic = _time.time()
                eval_metric.reset()
                with _tel.span("epoch"):
                    _scan_epoch(trainer, train_data, epoch, K, _drain,
                                guardian=guardian)
                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                 _time.time() - tic)
                trainer.write_back(arg_params, aux_params, self._aux_names)
                self.set_params(arg_params, aux_params)
                if epoch_end_callback is not None:
                    _multiple_callbacks(epoch_end_callback, epoch,
                                        self.symbol, arg_params, aux_params)
                if eval_data:
                    res = self.score(eval_data, validation_metric,
                                     score_end_callback=eval_end_callback,
                                     batch_end_callback=eval_batch_end_callback,
                                     epoch=epoch)
                    for name, val in res:
                        self.logger.info("Epoch[%d] Validation-%s=%f",
                                         epoch, name, val)
                train_data.reset()
        finally:
            self._scan_live = None
        return True

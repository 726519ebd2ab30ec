"""BaseModule: the abstract intermediate-level training API
(ref: python/mxnet/module/base_module.py:1-900, BaseModule.fit at :275).

The port's copy of ``mxnet_tpu/module/base_module.py``. ``fit`` first
offers the epochs to ``_try_scanned_fit`` (``Module``'s scanned path,
``parallel/fit_trainer.py``; other module kinds decline), else runs the
per-batch loop (forward_backward, update, update_metric, the
callbacks), under the JAX package's ``epoch``/``batch`` telemetry spans
and ``train.*`` metrics. With ``MXNET_GUARDIAN=1`` both loops are
guarded (``resilience/guardian.py``; the plumbing of
``mxnet_tpu/module/base_module.py:208-241``, ``:274-323``): the metric
first, then the guarded update, whose verdict the updater's device
sentinel gives; a rollback restores weights, aux and optimizer states.
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from .. import telemetry as _tel
from ..model import BatchEndParam, _multiple_callbacks
from ..resilience import guardian as _guardian


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- properties every subclass provides ------------------------------------
    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    @property
    def symbol(self):
        return self._symbol

    # -- core abstract ops -----------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def install_monitor(self, mon):
        raise NotImplementedError()

    # -- conveniences (ref: base_module.py) ------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False, force_init=True):
        self.init_params(
            initializer=None, arg_params=arg_params, aux_params=aux_params,
            allow_missing=allow_missing, force_init=force_init,
        )

    def save_params(self, fname):
        """ref: base_module.py:485."""
        from ..ndarray import save as nd_save

        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        nd_save(fname, save_dict)

    def load_params(self, fname):
        """ref: base_module.py:498."""
        from ..ndarray import load as nd_load

        save_dict = nd_load(fname)
        arg_params = {}
        aux_params = {}
        for k, value in save_dict.items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

    def score(self, eval_data, eval_metric, num_batch=None, batch_end_callback=None,
              score_end_callback=None, reset=True, epoch=0):
        """ref: base_module.py:170."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                batch_end_params = BatchEndParam(
                    epoch=epoch, nbatch=nbatch, eval_metric=eval_metric, locals=locals()
                )
                _multiple_callbacks(batch_end_callback, batch_end_params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(
                epoch=epoch, nbatch=actual_num_batch, eval_metric=eval_metric,
                locals=locals(),
            )
            _multiple_callbacks(score_end_callback, params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """ref: base_module.py:222."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - pad] for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True, reset=True,
                always_output_list=False):
        """ref: base_module.py:241."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - pad].copy() for out in self.get_outputs()]
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                assert len(out) == num_outputs, \
                    "Cannot merge batches, as num of outputs is not the same in mini-batches."
            from ..ndarray import concatenate

            output_list2 = [
                concatenate([out[i] for out in output_list]) for i in range(num_outputs)
            ]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

    def _try_scanned_fit(self, *args, **kwargs):
        """Overridden by Module; other module kinds use the per-batch
        loop unconditionally."""
        return False

    # -- guardian plumbing -----------------------------------------------------
    def _guardian_updater(self):
        """The updater whose device sentinel carries this module's
        per-step verdicts: the local one, or the kvstore-installed one."""
        upd = getattr(self, "_updater", None)
        if upd is not None:
            return upd
        kv = getattr(self, "_kvstore", None)
        return getattr(kv, "_updater", None) if kv is not None else None

    def _guardian_grads(self):
        """First-device gradient NDArrays (vote-path stats); [] when the
        module kind exposes no grad arrays."""
        fn = getattr(self, "_grad_arrays", None)
        if fn is None:
            return []
        return [g[0] for g in fn() if g and g[0] is not None]

    def _guardian_snapshot(self):
        arg_params, aux_params = self.get_params()
        return ({k: _guardian._host_copy(v) for k, v in arg_params.items()},
                {k: _guardian._host_copy(v) for k, v in aux_params.items()},
                _guardian.snapshot_updater_states(self._guardian_updater()))

    def _guardian_restore(self, payload):
        args, auxs, opt_states = payload
        self.set_params(args, auxs)
        _guardian.restore_updater_states(self._guardian_updater(), opt_states)

    def _guardian_disk_restore(self, args, auxs):
        self.set_params(args, auxs)
        # a .params checkpoint has no optimizer state; stale (possibly
        # poisoned) momenta must not survive the rollback
        _guardian.zero_updater_states(self._guardian_updater())

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None, monitor=None):
        """ref: python/mxnet/module/base_module.py:275."""
        assert num_epoch is not None, "please specify number of epochs"
        from ..initializer import Uniform

        if initializer is None:
            initializer = Uniform(0.01)
        self.bind(
            data_shapes=train_data.provide_data, label_shapes=train_data.provide_label,
            for_training=True, force_rebind=force_rebind,
        )
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(
            initializer=initializer, arg_params=arg_params, aux_params=aux_params,
            allow_missing=allow_missing, force_init=force_init,
        )
        self.init_optimizer(
            kvstore=kvstore, optimizer=optimizer, optimizer_params=optimizer_params
        )
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        # training-run guardian (MXNET_GUARDIAN=1): non-finite sentinel,
        # skip-steps, rollback-to-last-good — None when off
        guard = _guardian.TrainingGuardian.create(
            kvstore=getattr(self, "_kvstore", None),
            epoch_end_callback=epoch_end_callback, logger=self.logger)
        if guard is not None:
            # loss z-score channel: live when the eval metric is
            # loss-like (ce/perplexity/mse/...), inert for accuracy
            guard.attach_metric(eval_metric)
            guard.attach_data_iter(train_data)

        # the scanned path (parallel/fit_trainer.py): plain one-device
        # Module only; False falls through to the per-batch loop
        if self._try_scanned_fit(
                train_data, eval_data, eval_metric, validation_metric,
                epoch_end_callback, batch_end_callback, eval_end_callback,
                eval_batch_end_callback, begin_epoch, num_epoch, monitor,
                guardian=guard):
            return

        def _fit_one_batch(epoch, nbatch, data_batch):
            step_tic = time.monotonic() if _tel.ENABLED else 0.0
            if monitor is not None:
                monitor.tic()
            self.forward_backward(data_batch)
            if guard is None:
                self.update()
                self.update_metric(eval_metric, data_batch.label)
            else:
                # metric BEFORE the guarded update: the outputs do not
                # depend on the update, and the guardian's loss feed
                # reads this batch's metric delta
                self.update_metric(eval_metric, data_batch.label)
                action = guard.guard_batch(
                    self.update, grad_arrays_fn=self._guardian_grads,
                    updater=self._guardian_updater())
                if action == "rollback":
                    guard.rollback(
                        self._guardian_restore,
                        disk_restore_fn=self._guardian_disk_restore,
                        data_iter=train_data)
                else:
                    guard.maybe_snapshot(self._guardian_snapshot)
            if monitor is not None:
                monitor.toc_print()
            if _tel.ENABLED:
                dt = time.monotonic() - step_tic
                _tel.histogram("train.step_secs").observe(dt)
                if dt > 0 and getattr(train_data, "batch_size", 0):
                    _tel.gauge("train.samples_per_sec").set(
                        train_data.batch_size / dt)
            if batch_end_callback is not None:
                batch_end_params = BatchEndParam(
                    epoch=epoch, nbatch=nbatch, eval_metric=eval_metric, locals=locals()
                )
                _multiple_callbacks(batch_end_callback, batch_end_params)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            with _tel.span("epoch"):
                for nbatch, data_batch in enumerate(train_data):
                    with _tel.span("batch"):
                        _fit_one_batch(epoch, nbatch, data_batch)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            toc = time.time()
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, (toc - tic))

            arg_params, aux_params = self.get_params()
            self.set_params(arg_params, aux_params)
            if epoch_end_callback is not None:
                _multiple_callbacks(
                    epoch_end_callback, epoch, self.symbol, arg_params, aux_params
                )
            if eval_data:
                res = self.score(
                    eval_data, validation_metric,
                    score_end_callback=eval_end_callback,
                    batch_end_callback=eval_batch_end_callback, epoch=epoch,
                )
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name, val)
            train_data.reset()

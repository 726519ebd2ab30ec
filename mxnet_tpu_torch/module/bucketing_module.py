"""BucketingModule: one executor per bucket with shared parameters/memory
(ref: python/mxnet/module/bucketing_module.py:16-336, switch_bucket:195).

The port's copy of ``mxnet_tpu/module/bucketing_module.py``. A bucket
binds with ``shared_module`` set to the default bucket, so its executor
holds the default bucket's parameter, gradient and aux NDArray objects
wherever name, shape and dtype match (``Executor.simple_bind``'s
``shared_exec``): one storage for every bucket, and an update through
one bucket is what the next bucket's forward reads.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._buckets = {}
        self._curr_module = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._call_sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def _call_sym_gen(self, bucket_key):
        res = self._sym_gen(bucket_key)
        if isinstance(res, tuple):
            return res
        return (res, ("data",), ("softmax_label",))

    def get_params(self):
        assert self.binded and self.params_initialized
        return self._curr_module.get_params()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        """ref: bucketing_module.py:128."""
        if self.params_initialized and not force_init:
            return
        assert self.binded
        self._curr_module.init_params(
            initializer=initializer, arg_params=arg_params, aux_params=aux_params,
            allow_missing=allow_missing, force_init=force_init,
        )
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """ref: bucketing_module.py:150 — binds the default bucket."""
        assert shared_module is None, "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        self.binded = True

        symbol, data_names, label_names = self._call_sym_gen(self._default_bucket_key)
        module = Module(
            symbol, data_names, label_names, logger=self.logger,
            context=self._context, work_load_list=self._work_load_list,
        )
        module.bind(
            data_shapes, label_shapes, for_training, inputs_need_grad,
            force_rebind=False, shared_module=None, grad_req=grad_req,
        )
        self._curr_module = module
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """ref: bucketing_module.py:195."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            symbol, data_names, label_names = self._call_sym_gen(bucket_key)
            module = Module(
                symbol, data_names, label_names, logger=self.logger,
                context=self._context, work_load_list=self._work_load_list,
            )
            module.bind(
                data_shapes, label_shapes, self._curr_module.for_training,
                self._curr_module.inputs_need_grad, force_rebind=False,
                shared_module=self._buckets[self._default_bucket_key],
                grad_req=getattr(self, "_grad_req", "write"),
            )
            # a bucket created after init_optimizer must share the live
            # optimizer state too (ref bucketing_module.py:219-221)
            if self.optimizer_initialized:
                module.borrow_optimizer(
                    self._buckets[self._default_bucket_key])
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        """ref: bucketing_module.py:230."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(
            kvstore, optimizer, optimizer_params, force_init=force_init
        )
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        """ref: bucketing_module.py:255."""
        assert self.binded and self.params_initialized
        bucket_key = getattr(data_batch, "bucket_key", None)
        if bucket_key is None:
            # batches from plain (non-bucket) iterators — e.g. an eval
            # iterator passed to score() — run under the default key
            bucket_key = self._default_bucket_key
        default_mod = self._buckets[self._default_bucket_key]
        provide_data = data_batch.provide_data
        if provide_data is None:
            provide_data = [(n, tuple(a.shape)) for n, a in zip(
                default_mod.data_names, data_batch.data)]
        provide_label = getattr(data_batch, "provide_label", None)
        if provide_label is None and getattr(data_batch, "label", None):
            provide_label = [(n, tuple(a.shape)) for n, a in zip(
                default_mod._label_names, data_batch.label)]
        self.switch_bucket(bucket_key, provide_data, provide_label)
        # share latest params into the switched module
        if self._curr_module.params_initialized is False:
            src = self._buckets[self._default_bucket_key]
            if src.params_initialized:
                self._curr_module.init_params(*(), arg_params=src.get_params()[0],
                                              aux_params=src.get_params()[1],
                                              force_init=True)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized and self.optimizer_initialized
        self._curr_module.update()
        # Sibling buckets alias the same parameter NDArrays (the shared
        # memory pool in executor._simple_bind), so the update is already
        # visible to them — no per-step propagation. Only a bucket whose
        # executor did NOT share a buffer (shape/dtype mismatch) needs a
        # copy; detect by identity and copy just those.
        cur_execs = self._curr_module._execs
        for mod in self._buckets.values():
            if mod is self._curr_module or not mod.params_initialized:
                continue
            data_like = set(mod.data_names) | set(mod._label_names or ())
            stale = [
                name
                for name, arr in mod._execs[0].arg_dict.items()
                if name in cur_execs[0].arg_dict
                and arr is not cur_execs[0].arg_dict[name]
                and name not in data_like
            ] + [
                name
                for name, arr in mod._execs[0].aux_dict.items()
                if name in cur_execs[0].aux_dict
                and arr is not cur_execs[0].aux_dict[name]
            ]
            if stale:
                arg, aux = self._curr_module.get_params()
                mod.set_params(arg, aux)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for mod in self._buckets.values():
            mod.install_monitor(mon)


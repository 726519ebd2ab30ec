"""Executor management for ``FeedForward``
(counterpart of ``mxnet_tpu/executor_manager.py``).

The JAX package's group and manager, copied: each device of ``ctx``
binds one executor over its slice of the batch (``FeedForward`` passes
one device), with ``grad_req`` write for parameters and null for data
and labels. Bucketing follows ``mxnet_tpu/executor_manager.py:141-203``:
with a ``sym_gen`` the manager starts from the default bucket's group,
and a batch of a new ``bucket_key`` binds ``sym_gen(key)`` with
``simple_bind(shared_exec=...)`` over the default group's executors, so
every bucket holds the same parameter and gradient arrays; a monitor
under bucketing raises, as there.
"""
from __future__ import annotations

import logging

from .ndarray import NDArray

__all__ = ["_split_input_slice", "_check_arguments",
           "DataParallelExecutorGroup", "DataParallelExecutorManager"]


def _split_input_slice(batch_size, work_load_list):
    """Split batch into per-device slices weighted by work load
    (ref: executor_manager.py:15)."""
    total_work_load = sum(work_load_list)
    batch_num_list = [
        round(work_load * batch_size / total_work_load) for work_load in work_load_list
    ]
    batch_num_sum = sum(batch_num_list)
    if batch_num_sum < batch_size:
        batch_num_list[-1] += batch_size - batch_num_sum
    slices = []
    end = 0
    for batch_num in batch_num_list:
        begin = int(min(end, batch_size))
        end = int(min(begin + batch_num, batch_size))
        if begin >= end:
            raise ValueError("Too many slices such that some splits are empty")
        slices.append(slice(begin, end))
    return slices


def _check_arguments(symbol):
    """Reject duplicate names (ref: executor_manager.py:43)."""
    arg_names = symbol.list_arguments()
    if len(set(arg_names)) != len(arg_names):
        raise ValueError(
            "Find duplicated argument name, please make the weight name non-duplicated"
        )
    aux_names = symbol.list_auxiliary_states()
    if len(set(aux_names)) != len(aux_names):
        raise ValueError("Find duplicated auxiliary param name")


def _load_general(data, targets):
    for d_src, d_targets in zip(data, targets):
        if isinstance(d_targets, NDArray):
            d_src.copyto(d_targets)
        else:
            for slice_idx, d_dst in d_targets:
                d_src[slice_idx].copyto(d_dst)


class DataParallelExecutorGroup:
    """One executor per device over sliced batches
    (ref: executor_manager.py:185 and module/executor_group.py:68)."""

    def __init__(self, sym, arg_names, param_names, ctx, slices, train_data,
                 shared_group=None):
        _check_arguments(sym)
        self.arg_names = arg_names
        self.param_names = param_names
        self.ctx = ctx
        self.slices = slices
        data_shapes = {
            k: tuple([slices[0].stop - slices[0].start] + list(v[1:]))
            for k, v in train_data.provide_data + train_data.provide_label
        }
        self.data_names = [x[0] for x in train_data.provide_data]
        self.label_names = [x[0] for x in train_data.provide_label]
        self.aux_names = sym.list_auxiliary_states()

        self.train_execs = []
        for i, ctxi in enumerate(ctx):
            batch_size = slices[i].stop - slices[i].start
            shapes = {
                k: tuple([batch_size] + list(v[1:]))
                for k, v in train_data.provide_data + train_data.provide_label
            }
            grad_req = {
                name: ("write" if name in param_names else "null") for name in arg_names
            }
            shared = shared_group.train_execs[i] if shared_group else None
            exec_ = sym.simple_bind(ctxi, grad_req=grad_req,
                                    shared_exec=shared, **shapes)
            self.train_execs.append(exec_)

        self.data_arrays = [
            [(self.slices[i], e.arg_dict[name]) for i, e in enumerate(self.train_execs)]
            for name in self.data_names
        ]
        self.label_arrays = [
            [(self.slices[i], e.arg_dict[name]) for i, e in enumerate(self.train_execs)]
            for name in self.label_names
        ]
        self.param_idx = [i for i in range(len(arg_names)) if arg_names[i] in param_names]
        self.param_arrays = [
            [e.arg_arrays[i] for e in self.train_execs] for i in self.param_idx
        ]
        self.grad_arrays = [
            [e.grad_arrays[i] for e in self.train_execs] for i in self.param_idx
        ]
        self.aux_arrays = [
            [e.aux_arrays[i] for e in self.train_execs] for i in range(len(self.aux_names))
        ]

    def load_data_batch(self, data_batch):
        _load_general(data_batch.data, self.data_arrays)
        _load_general(data_batch.label, self.label_arrays)

    def forward(self, is_train=False):
        for texec in self.train_execs:
            texec.forward(is_train=is_train)

    def backward(self):
        for texec in self.train_execs:
            texec.backward()

    def update_metric(self, metric, labels):
        for texec, islice in zip(self.train_execs, self.slices):
            labels_slice = [label[islice] for label in labels]
            metric.update(labels_slice, texec.outputs)


class DataParallelExecutorManager:
    """One executor group over the batch, or one a bucket over shared
    storage (ref: executor_manager.py:279)."""

    def __init__(self, symbol, ctx, train_data, param_names, arg_names,
                 aux_names, work_load_list=None, logger=None, sym_gen=None):
        if logger is None:
            logger = logging
        num_device = len(ctx)
        logger.info("Start training with %s", str(ctx))
        if work_load_list is None:
            work_load_list = [1] * num_device
        assert isinstance(work_load_list, list) and len(work_load_list) == num_device
        self.slices = _split_input_slice(train_data.batch_size, work_load_list)
        self.arg_names = arg_names
        self.param_names = param_names
        self.aux_names = aux_names
        self.ctx = ctx
        self.execgrp = DataParallelExecutorGroup(
            symbol, self.arg_names, self.param_names, self.ctx, self.slices, train_data
        )
        self.symbol = symbol
        self.sym_gen = sym_gen
        self.curr_execgrp = None
        if self.sym_gen is not None:
            self.execgrp_bucket = {train_data.default_bucket_key: self.execgrp}

    def install_monitor(self, monitor):
        if self.sym_gen is not None:
            raise ValueError("Monitoring is not implemented with bucketing")
        for train_exec in self.execgrp.train_execs:
            monitor.install(train_exec)

    def set_params(self, arg_params, aux_params):
        for texec in self.execgrp.train_execs:
            texec.copy_params_from(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        for name, block in zip(self.param_names, self.param_arrays):
            weight = sum(w.copyto(block[0].context) for w in block) / len(block)
            weight.copyto(arg_params[name])
        for name, block in zip(self.aux_names, self.aux_arrays):
            weight = sum(w.copyto(block[0].context) for w in block) / len(block)
            weight.copyto(aux_params[name])

    @property
    def param_arrays(self):
        return self.execgrp.param_arrays

    @property
    def grad_arrays(self):
        return self.execgrp.grad_arrays

    @property
    def aux_arrays(self):
        return self.execgrp.aux_arrays

    def load_data_batch(self, data_batch):
        if self.sym_gen is not None:
            key = data_batch.bucket_key
            if key not in self.execgrp_bucket:
                symbol = self.sym_gen(key)
                execgrp = DataParallelExecutorGroup(
                    symbol, self.arg_names, self.param_names, self.ctx,
                    self.slices, data_batch, shared_group=self.execgrp,
                )
                self.execgrp_bucket[key] = execgrp
            self.curr_execgrp = self.execgrp_bucket[key]
        else:
            self.curr_execgrp = self.execgrp
        self.curr_execgrp.load_data_batch(data_batch)

    def forward(self, is_train=False):
        self.curr_execgrp.forward(is_train=is_train)

    def backward(self):
        self.curr_execgrp.backward()

    def update_metric(self, metric, labels):
        self.curr_execgrp.update_metric(metric, labels)

"""Training callbacks (ref: python/mxnet/callback.py:1-123).

Counterpart of ``mxnet_tpu/callback.py``: ``do_checkpoint`` (with
rolling retention, ``keep_n``), ``log_train_metric``, ``Speedometer``
and ``ProgressBar``; ``Speedometer`` sets the ``train.samples_per_sec``
gauge under ``MXNET_TELEMETRY=1``, as the JAX package's does.
"""
from __future__ import annotations

import logging
import math
import time

from . import telemetry as _tel


def do_checkpoint(prefix, period=1, keep_n=None):
    """Epoch-end checkpoint callback (ref: callback.py:10).

    ``keep_n`` enables rolling retention (only the newest ``keep_n``
    epochs stay on disk). The returned closure carries ``.prefix``."""
    from .model import save_checkpoint

    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux,
                            keep_n=keep_n)

    _callback.prefix = prefix
    return _callback


def log_train_metric(period, auto_reset=False):
    """ref: callback.py:38."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info(
                    "Iter[%d] Batch[%d] Train-%s=%f", param.epoch, param.nbatch, name, value
                )
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer:
    """Log samples/sec every `frequent` batches (ref: callback.py:59)."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                elapsed = time.time() - self.tic
                if elapsed <= 0:
                    # a fast synthetic iterator can tick twice inside one
                    # clock quantum (and wall clocks can step backwards);
                    # an unmeasurable interval yields no speed line, not
                    # a ZeroDivisionError mid-training
                    self.tic = time.time()
                    return
                speed = self.frequent * self.batch_size / elapsed
                if _tel.ENABLED:
                    _tel.gauge("train.samples_per_sec").set(speed)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    for name, value in name_value:
                        logging.info(
                            "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\tTrain-%s=%f",
                            param.epoch, count, speed, name, value,
                        )
                else:
                    logging.info(
                        "Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                        param.epoch, count, speed,
                    )
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class ProgressBar:
    """ref: callback.py:104."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")

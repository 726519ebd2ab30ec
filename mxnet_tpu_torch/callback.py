"""Training callbacks: ``Speedometer`` and ``do_checkpoint``.

Counterpart of ``mxnet_tpu/callback.py``, without telemetry gauges and
without rolling checkpoint retention (``keep_n``).
"""
from __future__ import annotations

import logging
import time


def do_checkpoint(prefix, period=1):
    """Epoch-end checkpoint callback (ref: callback.py:10).

    The returned closure carries ``.prefix``."""
    from .model import save_checkpoint

    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    _callback.prefix = prefix
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

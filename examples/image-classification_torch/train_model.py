"""Shared fit() used by the image-classification examples, on
mxnet_tpu_torch.

examples/image-classification/train_model.py with its import rewritten
and its contexts made the port's: ``--ctx`` is ``auto`` (``gpu(0)``,
with no fallback to the CPU when there is no card), ``gpu`` or ``cpu``,
and the chosen context is the current one while the model is built and
fitted. The port has no kvstore yet: ``--kv-store`` goes to
``FeedForward.fit`` as a string, which takes a local kind (``local``,
``device``) for none on one device and refuses a ``dist`` kind; the
data loaders and the epoch size see rank 0 of 1 worker where the
original reads ``kv.rank`` and ``kv.num_workers``.

Mirrors the reference's example/image-classification/train_model.py:6-89:
build FeedForward, wire checkpoint / speedometer callbacks, call .fit().
"""
import logging
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import mxnet_tpu_torch as mx  # noqa: E402


class _OneWorker:
    """What the data loaders read of a kvstore: rank 0 of 1 worker."""
    rank = 0
    num_workers = 1


def _contexts(args):
    dev = mx.cpu if args.ctx == "cpu" else mx.gpu
    n = max(1, args.num_devices)
    return [dev(i) for i in range(n)]


def fit(args, network, data_loader, batch_end_callback=None):
    # kvstore: 'local' | 'device' on one device; no kvstore is ported
    kv = _OneWorker()

    head = "%(asctime)-15s Node[" + str(kv.rank) + "] %(message)s"
    logging.basicConfig(level=logging.DEBUG, format=head)
    logging.info("start with arguments %s", args)

    (train, val) = data_loader(args, kv)

    devs = _contexts(args)

    epoch_size = args.num_examples // args.batch_size
    if 'dist' in args.kv_store:
        # each worker sees 1/num_workers of the data (ref train_model.py:60)
        epoch_size //= kv.num_workers
    checkpoint = None
    if args.model_prefix is not None:
        dirname = os.path.dirname(args.model_prefix)
        if dirname and not os.path.isdir(dirname):
            os.makedirs(dirname, exist_ok=True)
        checkpoint = mx.callback.do_checkpoint(args.model_prefix)

    arg_params = aux_params = None
    begin_epoch = 0
    if args.load_epoch is not None:
        assert args.model_prefix is not None
        _, arg_params, aux_params = mx.model.load_checkpoint(
            args.model_prefix, args.load_epoch)
        begin_epoch = args.load_epoch

    lr_scheduler = None
    if args.lr_factor is not None and args.lr_factor < 1:
        lr_scheduler = mx.lr_scheduler.FactorScheduler(
            step=max(int(epoch_size * args.lr_factor_epoch), 1),
            factor=args.lr_factor)

    with devs[0]:
        model = mx.FeedForward(
            ctx=devs,
            symbol=network,
            num_epoch=args.num_epochs,
            begin_epoch=begin_epoch,
            learning_rate=args.lr,
            momentum=0.9,
            wd=0.00001,
            lr_scheduler=lr_scheduler,
            initializer=mx.initializer.Xavier(factor_type="in", magnitude=2.34),
            arg_params=arg_params,
            aux_params=aux_params,
        )

        batch_cbs = [mx.callback.Speedometer(args.batch_size, 50)]
        if batch_end_callback is not None:
            batch_cbs.insert(0, batch_end_callback)

        model.fit(
            X=train,
            eval_data=val,
            kvstore=args.kv_store,
            batch_end_callback=batch_cbs,
            epoch_end_callback=checkpoint,
        )
    return model

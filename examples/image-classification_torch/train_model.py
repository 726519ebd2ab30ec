"""Shared fit() used by the image-classification examples, on
mxnet_tpu_torch.

examples/image-classification/train_model.py with its import rewritten
and its contexts made the port's: ``--ctx`` is ``auto`` or ``gpu``
(``gpu(i)`` for ``i < --num-devices``, no fallback to the CPU when there
is no card) or ``cpu``, and the first context is the current one while
the model is built and fitted. With more devices asked for than there
are cards, the contexts wrap around the cards (``--num-devices 2`` on
one card is ``[gpu(0), gpu(0)]``: two executors on one card, reduced
through the kvstore as two cards would be); the mapping is logged.

The kvstore is created from ``--kv-store`` as in the original
(``kv = mx.kvstore.create(args.kv_store)``), and the data loaders and
the epoch size read its ``rank`` and ``num_workers``. ``FeedForward.fit``
gets that one store on several devices or under a dist type, as in the
original, and None on one device otherwise: ``model._create_kvstore``
makes no store of a type name there either, and a fit with no store
keeps the scanned path, where one with a store updates through it in
the per-batch loop.

Mirrors the reference's example/image-classification/train_model.py:6-89:
create the kvstore from --kv-store, build FeedForward, wire checkpoint /
speedometer callbacks, call .fit().
"""
import logging
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import mxnet_tpu_torch as mx  # noqa: E402


def _contexts(args):
    n = max(1, args.num_devices)
    if args.ctx == "cpu":
        return [mx.cpu(i) for i in range(n)]
    cards = mx.context.num_devices("gpu")
    devs = [mx.gpu(i % cards if cards else i) for i in range(n)]
    if cards and n > cards:
        logging.info("%d devices on %d card(s): %s", n, cards, devs)
    return devs


def fit(args, network, data_loader, batch_end_callback=None):
    # kvstore: 'local' | 'device' | 'dist_sync' | 'dist_async'
    # (ref train_model.py:8  kv = mx.kvstore.create(args.kv_store))
    kv = mx.kvstore.create(args.kv_store)

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
            kvstore=kv if len(devs) > 1 or "dist" in args.kv_store
            else None,
            batch_end_callback=batch_cbs,
            epoch_end_callback=checkpoint,
        )
    return model

"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter`` and ``MNISTIter``.

Counterpart of ``mxnet_tpu/io.py:47-79`` and ``:118-362``, copied: the
same numpy shuffling (the global numpy generator), padding and
roll-over, so both packages visit batches in the same order. Batches
are NDArrays on the host (``cpu()``); the executor copies them onto its
device. ``MNISTIter`` reads the idx files when present and otherwise
makes the JAX package's seeded synthetic digits. Not carried over:
distributed sharding (``num_parts``), telemetry and the JAX package's
other iterators.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as _np

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataBatch", "DataIter", "NDArrayIter", "MNISTIter", "DataDesc"]


class DataDesc:
    """Name+shape(+dtype,layout) of one input (io.py provides name/shape
    pairs; layout mapping ref: python/mxnet/io.py LayoutMapper:24)."""

    def __init__(self, name, shape, dtype=_np.float32, layout="NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = dtype
        self.layout = layout

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype, self.layout)

    def __iter__(self):  # unpack like a (name, shape) tuple
        yield self.name
        yield self.shape

    def __getitem__(self, i):  # index like a (name, shape) tuple
        return (self.name, self.shape)[i]

    def __len__(self):
        return 2


class DataBatch:
    """ref: python/mxnet/io.py:48."""

    def __init__(self, data, label, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """ref: python/mxnet/io.py:80."""

    def __init__(self):
        self.batch_size = 0

    def reset(self):
        pass

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    next = __next__

    def next(self):  # noqa: F811
        if self.iter_next():
            return DataBatch(
                data=self.getdata(), label=self.getlabel(),
                pad=self.getpad(), index=self.getindex(),
            )
        raise StopIteration

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()


def _init_data(data, allow_empty, default_name):
    """Convert arbitrary data to list of (name, numpy) (ref: io.py:456)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {("_%d_%s" % (i, default_name)): d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them or dict")
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, _np.asarray(v, dtype=v.dtype if hasattr(v, "dtype") else _np.float32)))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (ref: python/mxnet/io.py:475)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data", label_name="softmax_label"):
        super().__init__()
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        assert self.num_data >= batch_size, "batch_size needs to be smaller than data size."
        self.idx = _np.arange(self.num_data)
        if shuffle:
            _np.random.shuffle(self.idx)
        if last_batch_handle == "discard":
            new_n = self.num_data - self.num_data % batch_size
            self.idx = self.idx[:new_n]
            self.num_data = new_n
        self.data_list = [x[1] for x in self.data] + [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle
        self.shuffle = shuffle

    @property
    def provide_data(self):
        return [
            DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
            for k, v in self.data
        ]

    @property
    def provide_label(self):
        return [
            DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
            for k, v in self.label
        ]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.shuffle:
            _np.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor - self.num_data)
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(
                data=self.getdata(), label=self.getlabel(),
                pad=self.getpad(), index=None,
            )
        raise StopIteration

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        if self.cursor + self.batch_size <= self.num_data:
            sel = self.idx[self.cursor:self.cursor + self.batch_size]
        else:
            pad = self.batch_size - self.num_data + self.cursor
            sel = _np.concatenate([self.idx[self.cursor:], self.idx[:pad]])
        return [array(x[sel], ctx=cpu()) for _, x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


def _read_idx_images(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, "not an MNIST image file: %s" % path
        data = _np.frombuffer(f.read(), dtype=_np.uint8)
        return data.reshape(num, rows, cols)


def _read_idx_labels(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, num = struct.unpack(">II", f.read(8))
        assert magic == 2049, "not an MNIST label file: %s" % path
        return _np.frombuffer(f.read(), dtype=_np.uint8).astype(_np.float32)


class MNISTIter(NDArrayIter):
    """MNIST idx-format iterator (ref: src/io/iter_mnist.cc, registered as
    MNISTIter). Reads the same idx files the reference reads; if the files
    are absent and ``allow_synthetic``, generates a deterministic synthetic
    digit-like dataset so tests run hermetically."""

    def __init__(self, image="train-images-idx3-ubyte", label="train-labels-idx1-ubyte",
                 batch_size=128, shuffle=True, flat=False, silent=False, seed=0,
                 input_shape=None, allow_synthetic=True, num_synthetic=2048,
                 **kwargs):
        if os.path.exists(image) and os.path.exists(label):
            images = _read_idx_images(image).astype(_np.float32) / 255.0
            labels = _read_idx_labels(label)
        elif allow_synthetic:
            rng = _np.random.RandomState(seed)
            n = num_synthetic
            labels = rng.randint(0, 10, size=n).astype(_np.float32)
            # deterministic class-dependent blobs: classifiable synthetic digits
            images = rng.rand(n, 28, 28).astype(_np.float32) * 0.1
            for i in range(n):
                c = int(labels[i])
                images[i, 2 + c * 2: 6 + c * 2, 4:24] += 0.9
            images = _np.clip(images, 0, 1)
        else:
            raise MXNetError("MNIST files not found: %s" % image)
        if flat:
            images = images.reshape(images.shape[0], -1)
        else:
            images = images.reshape(images.shape[0], 1, 28, 28)
        super().__init__(
            images, labels, batch_size=batch_size, shuffle=shuffle,
            last_batch_handle="discard",
            data_name=kwargs.pop("data_name", "data"),
            label_name=kwargs.pop("label_name", "softmax_label"),
        )

"""Data iterators: ``DataDesc`` (with ``get_list``), ``LayoutMapper``,
``DefaultLayoutMapper``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``MNISTIter``, ``CSVIter``, ``ResizeIter``,
``PrefetchingIter`` and ``ImageRecordIter``.

Counterpart of ``mxnet_tpu/io.py``, copied: the same numpy shuffling
(the global numpy generator, or the iterator's own ``RandomState``),
padding and roll-over, so both packages visit batches in the same
order. Batches are NDArrays on the host (``cpu()``); the executor or
the scanned fit copies them onto its device. ``MNISTIter`` reads the
idx files when present and otherwise makes the JAX package's seeded
synthetic digits.

``ImageRecordIter`` reads a packed RecordIO file (``recordio.py``) and
decodes and augments each image with PIL and numpy on a thread pool
(``preprocess_threads``): the JAX package's PIL route, bit for bit, the
eight uniforms of each image drawn on the iterator's thread in the same
order. The JAX package's native decoder (``src/imagedec.cc``, built
against libjpeg) is not carried over: the port has this one route.
``PrefetchingIter`` runs its iterators on a background thread; its
``reset`` waits for the thread's batch in progress, so no batch crosses
an epoch, and an error on the thread is raised to the consumer.
``NDArrayIter`` (and ``MNISTIter`` through it) shards by
``num_parts``/``part_index`` as the JAX package's does. Telemetry
(``MXNET_TELEMETRY=1``): ``io.batch_fetch_secs`` for every batch of
``NDArrayIter``, ``ImageRecordIter`` and ``PrefetchingIter`` (whose
``io.prefetch_queue_depth`` gauge reads the queue before each get), as
in the JAX package. Not carried over: ``DataServiceIter`` (with
``data_service/``).
"""
from __future__ import annotations

import gzip
import os
import queue as _queue
import re as _re
import struct
import threading
import time as _time

import numpy as _np

from . import telemetry as _tel
from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataBatch", "DataIter", "NDArrayIter", "MNISTIter", "CSVIter",
           "ResizeIter", "PrefetchingIter", "ImageRecordIter", "DataDesc",
           "LayoutMapper", "DefaultLayoutMapper"]


class DataDesc:
    """Name+shape(+dtype,layout) of one input (io.py provides name/shape
    pairs; layout mapping ref: python/mxnet/io.py LayoutMapper:24)."""

    def __init__(self, name, shape, dtype=_np.float32, layout="NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = dtype
        self.layout = layout

    @staticmethod
    def get_list(shapes, types):
        """DataDesc list from (name, shape) and optional (name, type)
        attribute lists (ref: io.py:629)."""
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype, self.layout)

    def __iter__(self):  # unpack like a (name, shape) tuple
        yield self.name
        yield self.shape

    def __getitem__(self, i):  # index like a (name, shape) tuple
        return (self.name, self.shape)[i]

    def __len__(self):
        return 2


class LayoutMapper:
    """Decide which axis of a named tensor is the batch axis
    (ref: python/mxnet/io.py:24). Subclass to override."""

    def get_layout_string(self, name):
        """Layout string (e.g. "NCHW") for ``name``, or None if unknown."""
        raise NotImplementedError()

    def get_batch_axis(self, name):
        """Index of the batch dimension for ``name``."""
        raise NotImplementedError()


class DefaultLayoutMapper(LayoutMapper):
    """Layout from a ``:__layout_X__`` tag in the name, else a fixed
    default batch axis (ref: python/mxnet/io.py:59; the rnn-time-major
    example relies on this convention). The tag's pattern is the JAX
    package's multi-character one (the reference's ``([^_*])`` matches
    one character only, so its own tags NCHW and TNC never match)."""

    LAYOUT_PATTERN = _re.compile(r":__layout_([^_]+?)__")

    def __init__(self, default_batch_axis=0):
        self._default_batch_axis = default_batch_axis

    def get_layout_string(self, name):
        ret = self.LAYOUT_PATTERN.search(name)
        return None if ret is None else ret.group(1)

    def get_batch_axis(self, name):
        layout = self.get_layout_string(name)
        if layout is None:
            return self._default_batch_axis
        return layout.find("N")  # -1 when N absent, as the reference


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
                 last_batch_handle="pad", data_name="data", label_name="softmax_label",
                 num_parts=1, part_index=0):
        super().__init__()
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        if num_parts > 1:
            # distributed sharding (mxnet_tpu/io.py:202-225): every part
            # gets n // num_parts samples, so the workers' batch counts
            # agree; shuffled, a permutation of the whole set under a
            # shared seed comes before the split
            if not 0 <= part_index < num_parts:
                raise ValueError(
                    "part_index must be in [0, num_parts), got %d/%d"
                    % (part_index, num_parts))
            n = self.data[0][1].shape[0]
            per = n // num_parts
            if shuffle:
                perm = _np.random.RandomState(0).permutation(n)
                sel = perm[part_index * per:(part_index + 1) * per]
            else:
                sel = _np.arange(part_index * per, (part_index + 1) * per)
            self.data = [(k, v[sel]) for k, v in self.data]
            self.label = [(k, v[sel]) for k, v in self.label]
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
        if not _tel.ENABLED:
            return self._next_impl()
        t0 = _time.monotonic()
        batch = self._next_impl()  # StopIteration is not a fetch
        _tel.histogram("io.batch_fetch_secs").observe(
            _time.monotonic() - t0)
        return batch

    def _next_impl(self):
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
                 num_parts=1, part_index=0, **kwargs):
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
            last_batch_handle="discard", num_parts=num_parts,
            part_index=part_index,
            data_name=kwargs.pop("data_name", "data"),
            label_name=kwargs.pop("label_name", "softmax_label"),
        )


class CSVIter(NDArrayIter):
    """CSV iterator (ref: src/io/iter_csv.cc)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, **kwargs):
        data = _np.loadtxt(data_csv, delimiter=",", dtype=_np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=_np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1:
                label = label.reshape(label.shape[:-1])
        super().__init__(data, label, batch_size=batch_size, last_batch_handle="discard")


class ResizeIter(DataIter):
    """Resize (truncate/loop) another iterator to `size` batches
    (ref: python/mxnet/io.py:138)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Threaded lookahead over one or more iters (ref: python/mxnet/io.py:170;
    C++ analog PrefetcherIter, src/io/iter_prefetcher.h:47).

    Each producer thread gets the queue and stop event of its epoch, and
    ``reset`` joins it (waiting for a batch in progress) before the
    iterators are reset, so a batch of one epoch never lands in the
    next; an exception on the thread is raised by the consumer's
    ``next``."""

    def __init__(self, iters, rename_data=None, rename_label=None, prefetch_depth=2):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0].shape[0]
        self._depth = prefetch_depth
        self._queue = None
        self._stop = None
        self._thread = None
        self._peek = None
        self._start()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([
            [DataDesc(r[n], s, d.dtype) for (n, s), d in zip(i.provide_data, i.provide_data)]
            for r, i in zip(self.rename_data, self.iters)
        ], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([
            [DataDesc(r[n], s, d.dtype) for (n, s), d in zip(i.provide_label, i.provide_label)]
            for r, i in zip(self.rename_label, self.iters)
        ], [])

    def _producer(self, q, stop):
        while not stop.is_set():
            try:
                batches = [i.next() for i in self.iters]
            except StopIteration:
                q.put(None)
                return
            except BaseException as e:  # raised again by the consumer
                q.put(e)
                return
            q.put(batches)

    def _start(self):
        self._queue = _queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._producer, args=(self._queue, self._stop),
            daemon=True)
        self._thread.start()

    def reset(self):
        self._stop.set()
        # drain until the producer has exited: it may be blocked on a
        # full queue or still computing a batch
        while self._thread.is_alive():
            try:
                self._queue.get(timeout=0.05)
            except _queue.Empty:
                pass
        self._thread.join()
        for i in self.iters:
            i.reset()
        self._peek = None
        self._start()

    def _fetch(self):
        if _tel.ENABLED:
            # occupancy BEFORE the get: depth==0 means the consumer is
            # about to stall on the producer
            _tel.gauge("io.prefetch_queue_depth").set(self._queue.qsize())
            t0 = _time.monotonic()
            batches = self._queue.get()
            _tel.histogram("io.batch_fetch_secs").observe(
                _time.monotonic() - t0)
        else:
            batches = self._queue.get()
        if batches is None:
            self._queue.put(None)   # StopIteration again until reset
            return None
        if isinstance(batches, BaseException):
            raise batches
        if self.n_iter == 1:
            return batches[0]
        return DataBatch(
            data=sum([b.data for b in batches], []),
            label=sum([b.label for b in batches], []),
            pad=batches[0].pad, index=batches[0].index,
        )

    def iter_next(self):
        """Advance to the next batch (DataIter protocol: iter_next moves the
        cursor; getdata/getlabel read the current batch)."""
        self._peek = self._fetch()
        return self._peek is not None

    def next(self):
        if self.iter_next():
            return self._peek
        raise StopIteration

    def getdata(self):
        assert self._peek is not None, "call iter_next() first"
        return self._peek.data

    def getlabel(self):
        assert self._peek is not None, "call iter_next() first"
        return self._peek.label

    def getindex(self):
        assert self._peek is not None, "call iter_next() first"
        return self._peek.index

    def getpad(self):
        assert self._peek is not None, "call iter_next() first"
        return self._peek.pad


class ImageRecordIter(DataIter):
    """Image RecordIO iterator: read packed recordio, decode, augment,
    batch (ref: src/io/iter_image_recordio.cc:356 + image_aug_default.cc
    + iter_batchloader.h). Decode uses PIL (OpenCV equivalent);
    augmentation: rand_crop with random scale and aspect, rand_mirror,
    HLS jitter, mean subtract, scale; the JAX package's PIL route
    (``mxnet_tpu/io.py`` ``_decode``, ``_hls_jitter``)."""

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_img=None, mean_r=0, mean_g=0, mean_b=0, scale=1.0,
                 round_batch=True, prefetch_depth=4, seed=0,
                 num_parts=1, part_index=0, preprocess_threads=4,
                 max_random_scale=1.0, min_random_scale=1.0,
                 max_aspect_ratio=0.0, random_h=0, random_s=0, random_l=0,
                 corrupt="raise", **kwargs):
        super().__init__()
        from . import recordio as _recordio

        # corrupt="skip": resync past damaged records instead of killing
        # the epoch
        self.rec = _recordio.MXRecordIO(path_imgrec, "r", corrupt=corrupt)
        self.data_shape = tuple(data_shape)
        if len(self.data_shape) != 3 or self.data_shape[0] not in (1, 3):
            raise MXNetError(
                "ImageRecordIter: data_shape must be (1|3, h, w), got %s"
                % (self.data_shape,))
        self.batch_size = batch_size
        self.label_width = label_width
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.scale = scale
        # scale/aspect/color jitter (ref: image_aug_default.cc params;
        # random_h in degrees [0,180], random_s/random_l as cv HLS byte
        # deltas [0,255] — converted to fractions for the HLS math)
        self.max_random_scale = float(max_random_scale)
        self.min_random_scale = float(min_random_scale)
        self.max_aspect_ratio = float(max_aspect_ratio)
        self.random_h = float(random_h)
        self.random_s = float(random_s) / 255.0
        self.random_l = float(random_l) / 255.0
        self.mean = None
        mean_from_img = False
        if mean_img is not None and os.path.exists(str(mean_img)):
            from .ndarray import load as _ndload

            self.mean = list(_ndload(mean_img).values())[0].asnumpy()
            mean_from_img = True
        elif mean_r or mean_g or mean_b:
            self.mean = _np.array([mean_r, mean_g, mean_b], _np.float32).reshape(3, 1, 1)
        if self.mean is not None and self.data_shape[0] == 1:
            # a 3-channel mean must not broadcast a (1,h,w) image into a
            # 3-channel batch behind provide_data's back: a mean_img
            # plane collapses to its channel average; scalar mean_r is
            # the gray mean as given (ref image_aug_default.cc subtracts
            # mean_r_ from channel 0)
            if mean_from_img and self.mean.ndim == 3 and self.mean.shape[0] == 3:
                self.mean = self.mean.mean(axis=0, keepdims=True)
            elif self.mean.shape == (3, 1, 1):
                self.mean = self.mean[:1]
            self.mean = self.mean.astype(_np.float32)
        self._rng = _np.random.RandomState(seed)
        # round-robin sharding during the scan: out-of-shard record bytes are
        # dropped immediately so per-worker memory is O(dataset/num_parts);
        # shards are then truncated to total//num_parts so every worker
        # yields the same batch count (collective-backed dist training
        # deadlocks on unequal counts)
        if not 0 <= part_index < num_parts:
            raise ValueError("part_index must be in [0, num_parts), got %d/%d"
                             % (part_index, num_parts))
        self._records = []
        i = 0
        while True:
            s = self.rec.read()
            if s is None:
                break
            if i % num_parts == part_index:
                self._records.append(s)
            i += 1
        if num_parts > 1:
            self._records = self._records[: i // num_parts]
        self._order = _np.arange(len(self._records))
        self.cursor = -batch_size
        # decode+augment on a thread pool (the OMP-worker role of the
        # reference's ImageRecordIOParser, iter_image_recordio.cc:150)
        self.preprocess_threads = max(1, int(preprocess_threads))
        self._pool = None
        if self.preprocess_threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.preprocess_threads)

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape)]

    def reset(self):
        if self.shuffle:
            self._rng.shuffle(self._order)
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor + self.batch_size <= len(self._records)

    @staticmethod
    def _hls_jitter(arr, dh, ds, dl):
        """Vectorized RGB->HLS->RGB jitter on an HWC f32 [0,255] array
        (dh in turns, ds/dl as fractions) — the JAX package's numpy
        port of its native pipeline's per-pixel conversion."""
        rgb = arr.reshape(-1, 3) / 255.0
        mx_ = rgb.max(axis=1)
        mn = rgb.min(axis=1)
        l = (mx_ + mn) / 2
        d = mx_ - mn
        nz = d > 1e-6
        s = _np.zeros_like(l)
        denom = _np.where(l > 0.5, 2.0 - mx_ - mn, mx_ + mn)
        s[nz] = d[nz] / _np.maximum(denom[nz], 1e-12)
        h = _np.zeros_like(l)
        r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
        dd = _np.where(nz, d, 1.0)
        is_r = nz & (mx_ == r)
        is_g = nz & ~is_r & (mx_ == g)
        is_b = nz & ~is_r & ~is_g
        h[is_r] = _np.mod((g - b)[is_r] / dd[is_r], 6.0) / 6.0
        h[is_g] = ((b - r)[is_g] / dd[is_g] + 2.0) / 6.0
        h[is_b] = ((r - g)[is_b] / dd[is_b] + 4.0) / 6.0
        h = _np.mod(h + dh, 1.0)
        l = _np.clip(l + dl, 0.0, 1.0)
        s = _np.clip(s + ds, 0.0, 1.0)
        q = _np.where(l < 0.5, l * (1 + s), l + s - l * s)
        p = 2 * l - q

        def hue(t):
            t = _np.mod(t, 1.0)
            out = _np.where(t < 1 / 6, p + (q - p) * 6 * t, q)
            out = _np.where(t >= 1 / 2,
                            _np.where(t < 2 / 3,
                                      p + (q - p) * (2 / 3 - t) * 6, p), out)
            return out

        out = _np.stack([hue(h + 1 / 3), hue(h), hue(h - 1 / 3)], axis=1)
        out = _np.where(s[:, None] < 1e-6, l[:, None], out)
        return (out * 255.0).reshape(arr.shape).astype(_np.float32)

    def _decode(self, s, aug):
        """Decode and augment one record; aug = 8 uniforms (crop_scale,
        crop_aspect, crop_x, crop_y, mirror, dh, ds, dl) drawn on the
        iterator thread so thread-pool decode stays deterministic."""
        import io as _pyio

        from . import recordio as _recordio

        header, img_bytes = _recordio.unpack(s)
        try:
            from PIL import Image
        except ImportError as e:  # pragma: no cover
            raise MXNetError("ImageRecordIter requires PIL for decode") from e
        c, h, w = self.data_shape
        # c==1 decodes grayscale, like the reference's gray flag
        # (iter_image_recordio.cc flag-driven cv::imread mode)
        img = Image.open(_pyio.BytesIO(img_bytes)).convert("RGB" if c == 3 else "L")
        iw, ih = img.size
        rsc, rar, rx, ry, rm, rh, rs, rl = aug
        if self.rand_crop:
            s_ = self.min_random_scale + (
                self.max_random_scale - self.min_random_scale) * rsc
            ar = 1.0 + self.max_aspect_ratio * (2 * rar - 1)
            cw = min(iw, max(1, int(w * s_ * ar + 0.5)))
            ch = min(ih, max(1, int(h * s_ + 0.5)))
            x0 = int(rx * (iw - cw + 1))
            y0 = int(ry * (ih - ch + 1))
            img = img.crop((x0, y0, x0 + cw, y0 + ch))
        img = img.resize((w, h))
        arr = _np.asarray(img, _np.float32)  # HWC (HW when grayscale)
        if arr.ndim == 2:
            arr = arr[:, :, None]
            # hue/saturation are undefined on gray (cv HLS leaves them
            # no-op), but lightness jitter still applies
            if self.random_l:
                dl = self.random_l * (2 * rl - 1)
                arr = _np.clip(arr / 255.0 + dl, 0.0, 1.0) * 255.0
        if c == 3 and (self.random_h or self.random_s or self.random_l):
            arr = self._hls_jitter(
                arr,
                self.random_h * (2 * rh - 1) / 360.0,
                self.random_s * (2 * rs - 1),
                self.random_l * (2 * rl - 1))
        arr = arr.transpose(2, 0, 1)  # CHW, RGB
        if self.rand_mirror and rm < 0.5:
            arr = arr[:, :, ::-1]
        if self.mean is not None:
            arr = arr - self.mean
        arr = arr * self.scale
        label = header.label
        return arr, label

    def next(self):
        if not _tel.ENABLED:
            return self._next_impl()
        t0 = _time.monotonic()
        batch = self._next_impl()
        _tel.histogram("io.batch_fetch_secs").observe(
            _time.monotonic() - t0)
        return batch

    def _next_impl(self):
        if not self.iter_next():
            raise StopIteration
        recs = [self._records[self._order[self.cursor + i]]
                for i in range(self.batch_size)]
        augs = [tuple(self._rng.rand(8)) for _ in recs]
        if self._pool is not None:
            results = list(self._pool.map(self._decode, recs, augs))
        else:
            results = [self._decode(s, a) for s, a in zip(recs, augs)]
        data = array(_np.stack([d for d, _ in results]), ctx=cpu())
        labels = [l for _, l in results]
        label = array(_np.asarray(labels, _np.float32).reshape(
            (self.batch_size,) if self.label_width == 1 else (self.batch_size, self.label_width)
        ), ctx=cpu())
        return DataBatch(data=[data], label=[label], pad=0, index=None)

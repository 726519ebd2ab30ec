"""The port's image data path against the JAX package's, on the CPU.

- ``ImageRecordIter`` gives the JAX package's PIL route's batches bit
  for bit (``MXNET_NATIVE=0``: the JAX package's native decoder is off,
  as it is on a machine without libjpeg), over two epochs with
  ``reset``, data and labels, dtype and shape: plain; ``rand_crop`` +
  ``rand_mirror`` with random scale and aspect; HLS jitter; ``mean_r/g/b``
  and ``scale``; ``mean_img`` through ``nd.load``; gray ``(1, h, w)``
  with lightness jitter and a mean; ``label_width=2``; ``shuffle``;
  ``num_parts=3, part_index=1``; one thread and four;
- ``PrefetchingIter`` over one ``ImageRecordIter`` gives the unwrapped
  iterator's batches over three epochs, resetting mid-epoch and at the
  end (no batch lost or repeated); over two ``NDArrayIter``\\ s with
  ``rename_data``/``rename_label`` it equals the JAX package's; an
  error on its thread is raised by ``next``;
- ``ResizeIter`` (truncating and looping) and ``CSVIter`` equal the JAX
  package's;
- ``opencv.imdecode``, ``resize`` (all five interpolations, up and down,
  uint8 and f32) and ``copyMakeBorder`` (all four borders), and
  ``nd.imdecode``, against the JAX package's;
- the scanned fit takes its batches from an iterator K at a time: when
  a chunk runs, the iterator has yielded no more than that chunk.

Images are 32-48 px a side, batches of 4, for time.
"""
import io

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

SHAPE = (3, 32, 32)
N_RECORDS = 22


def _image(rng, gray=False):
    h, w = rng.randint(32, 49, 2)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / (2 + c)) * np.cos(yy / (3 + c))
                     for c in range(3)], -1)
    img = (base * 90 + 128 + rng.randn(h, w, 3) * 20).clip(0, 255)
    img = img.astype(np.uint8)
    return img[:, :, 0] if gray else img


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    """Two packed files: single labels (JPEG and PNG records, one gray
    JPEG) and two labels a record."""
    d = tmp_path_factory.mktemp("recs")
    rng = np.random.RandomState(0)
    paths = {}
    for name, width in (("single", 1), ("double", 2)):
        path = str(d / (name + ".rec"))
        w = mt.recordio.MXRecordIO(path, "w")
        for i in range(N_RECORDS):
            label = float(i % 5) if width == 1 else [float(i % 5), i * 0.5]
            img = _image(rng, gray=(i == 3))
            w.write(mt.recordio.pack_img(
                (0, label, i, 0), img, quality=90,
                img_fmt=".png" if i % 4 == 1 else ".jpg"))
        w.close()
        paths[name] = path
    mean = rng.rand(*SHAPE).astype(np.float32) * 100
    paths["mean"] = str(d / "mean.bin")
    mt.nd.save(paths["mean"], {"mean_img": mt.nd.array(mean, ctx=mt.cpu())})
    return paths


CASES = {
    "plain": dict(),
    "crop_mirror": dict(rand_crop=True, rand_mirror=True,
                        max_aspect_ratio=0.25, min_random_scale=0.8,
                        max_random_scale=1.1),
    "hls": dict(rand_crop=True, random_h=36, random_s=50, random_l=50),
    "mean_rgb": dict(mean_r=123.68, mean_g=116.779, mean_b=103.939,
                     scale=1 / 58.0),
    "mean_img": dict(mean_img="mean", rand_mirror=True),
    "gray": dict(data_shape=(1, 32, 32), mean_r=100.0, random_l=40,
                 rand_crop=True),
    "label_width": dict(rec="double", label_width=2),
    "shuffle": dict(shuffle=True, rand_mirror=True, seed=7),
    "num_parts": dict(num_parts=3, part_index=1, shuffle=True),
    "one_thread": dict(preprocess_threads=1, random_h=20, rand_crop=True),
}


def _batches(it, epochs=2):
    out = []
    for _ in range(epochs):
        it.reset()
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def _iter(pkg, recs, case, **extra):
    kw = dict(CASES[case])
    path = recs[kw.pop("rec", "single")]
    if kw.get("mean_img") == "mean":
        kw["mean_img"] = recs["mean"]
    kw.setdefault("data_shape", SHAPE)
    kw.update(extra)
    return pkg.io.ImageRecordIter(path_imgrec=path, batch_size=4, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_image_record_iter_bit_equal_jax(recs, case, monkeypatch):
    monkeypatch.setenv("MXNET_NATIVE", "0")
    got = _batches(_iter(mt, recs, case))
    want = _batches(_iter(mj, recs, case))
    assert len(got) == len(want) > 0
    for (dt, lt, pt), (dj, lj, pj) in zip(got, want):
        assert dt.dtype == dj.dtype == np.float32 and dt.shape == dj.shape
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(lt, lj)
        assert pt == pj
    it = _iter(mt, recs, case)
    assert [tuple(d.shape) for d in it.provide_data] == [
        tuple(d.shape) for d in _iter(mj, recs, case).provide_data]
    assert [tuple(d.shape) for d in it.provide_label] == [
        tuple(d.shape) for d in _iter(mj, recs, case).provide_label]


def test_image_record_iter_refusals(recs):
    with pytest.raises(mt.MXNetError, match="data_shape"):
        mt.io.ImageRecordIter(path_imgrec=recs["single"],
                              data_shape=(2, 8, 8), batch_size=2)
    with pytest.raises(ValueError, match="part_index"):
        mt.io.ImageRecordIter(path_imgrec=recs["single"], data_shape=SHAPE,
                              batch_size=2, num_parts=2, part_index=2)


def _visit(it, stops=(None, 1, None)):
    """Epochs read whole or cut after ``stop`` batches, each from a
    ``reset``."""
    out = []
    for stop in stops:
        it.reset()
        for n, b in enumerate(it):
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
            if stop is not None and n + 1 == stop:
                break
    return out


def test_prefetching_iter_keeps_every_batch_across_resets(recs):
    """Three epochs (whole, cut after one batch, whole) through
    ``PrefetchingIter``: each starts at the first record and holds the
    bare iterator's batches in order, none lost or repeated."""
    epoch = [b for b in _visit(_iter(mt, recs, "plain"), (None,))]
    pre = mt.io.PrefetchingIter(_iter(mt, recs, "plain"), prefetch_depth=3)
    got = _visit(pre)
    want = epoch + epoch[:1] + epoch
    assert len(got) == len(want) == 2 * (N_RECORDS // 4) + 1
    for (a, la), (b, lb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    assert pre.provide_data[0].shape == (4,) + SHAPE
    pre.reset()
    for _ in range(N_RECORDS // 4):
        pre.next()
    for _ in range(2):   # the end stays the end until reset
        with pytest.raises(StopIteration):
            pre.next()


def test_prefetching_reset_waits_for_a_batch_in_progress():
    """A reset while the thread is inside a slow ``next``: that batch
    does not reach the next epoch, which starts at its first batch."""
    import time

    class Slow(mt.io.NDArrayIter):
        def next(self):
            time.sleep(0.05)
            return super().next()

    x = np.arange(24, dtype=np.float32).reshape(12, 2)
    pre = mt.io.PrefetchingIter(Slow(x, np.arange(12.0), batch_size=2),
                                prefetch_depth=1)
    for _ in range(3):
        pre.reset()
        first = pre.next()
        pre.reset()   # the thread is computing the next batch now
        labels = [b.label[0].asnumpy() for b in pre]
        np.testing.assert_array_equal(first.label[0].asnumpy(), [0, 1])
        np.testing.assert_array_equal(np.concatenate(labels),
                                      np.arange(12.0))


def _nd_iters(pkg, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(12, 3).astype(np.float32)
    y = np.arange(12, dtype=np.float32)
    return [pkg.io.NDArrayIter(x, y, batch_size=4),
            pkg.io.NDArrayIter(x * 2, y + 1, batch_size=4)]


def test_prefetching_two_iters_with_rename_equals_jax():
    out = []
    for pkg in (mt, mj):
        it = pkg.io.PrefetchingIter(
            _nd_iters(pkg, 3),
            rename_data=[{"data": "a"}, {"data": "b"}],
            rename_label=[{"softmax_label": "la"},
                          {"softmax_label": "lb"}])
        descs = [(d.name, tuple(d.shape)) for d in
                 it.provide_data + it.provide_label]
        out.append((descs, [[x.asnumpy() for x in b.data + b.label]
                            for b in _epoch(it)]))
    assert out[0][0] == out[1][0] == [("a", (4, 3)), ("b", (4, 3)),
                                      ("la", (4,)), ("lb", (4,))]
    assert len(out[0][1]) == len(out[1][1]) == 3
    for bt, bj in zip(out[0][1], out[1][1]):
        for a, b in zip(bt, bj):
            np.testing.assert_array_equal(a, b)


def _epoch(it):
    it.reset()
    return list(it)


def test_prefetching_iter_raises_the_thread_error():
    class Broken(mt.io.NDArrayIter):
        def next(self):
            raise RuntimeError("decode failed")

    it = mt.io.PrefetchingIter(Broken(np.zeros((4, 2)), np.zeros(4),
                                      batch_size=2))
    with pytest.raises(RuntimeError, match="decode failed"):
        it.next()


@pytest.mark.parametrize("size,reset_internal", [(2, True), (7, False)])
def test_resize_iter_equals_jax(size, reset_internal):
    out = []
    for pkg in (mt, mj):
        it = pkg.io.ResizeIter(_nd_iters(pkg, 5)[0], size,
                               reset_internal=reset_internal)
        got = []
        for _ in range(2):
            it.reset()
            got += [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it]
        out.append(got)
    assert len(out[0]) == len(out[1]) == 2 * size
    for (a, la, pa), (b, lb, pb) in zip(*out):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
        assert pa == pb


def test_csv_iter_equals_jax(tmp_path):
    rng = np.random.RandomState(6)
    data = rng.rand(10, 6).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", np.arange(10.0), delimiter=",")
    out = []
    for pkg in (mt, mj):
        it = pkg.io.CSVIter(str(tmp_path / "d.csv"), (2, 3),
                            label_csv=str(tmp_path / "l.csv"), batch_size=3)
        out.append(([(b.data[0].asnumpy(), b.label[0].asnumpy())
                     for b in _epoch(it)],
                    [tuple(d.shape) for d in it.provide_data]))
    assert out[0][1] == out[1][1] == [(3, 2, 3)]
    assert len(out[0][0]) == len(out[1][0]) == 3
    for (a, la), (b, lb) in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def _encoded(fmt, gray=False):
    img = _image(np.random.RandomState(9), gray=gray)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, quality=92)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
def test_imdecode_equals_jax(fmt):
    buf = _encoded(fmt)
    with mt.cpu():
        for flag in (0, 1):
            for to_rgb in (True, False):
                got = mt.opencv.imdecode(buf, flag, to_rgb).asnumpy()
                want = mj.opencv.imdecode(buf, flag, to_rgb).asnumpy()
                np.testing.assert_array_equal(got, want)
                assert got.dtype == want.dtype == np.uint8
        mean = mt.nd.array(np.full(3, 10.0, np.float32), ctx=mt.cpu())
        for kw in (dict(), dict(clip_rect=(2, 3, 20, 25)),
                   dict(channels=1)):
            got = mt.nd.imdecode(buf, **kw).asnumpy()
            want = mj.nd.imdecode(buf, **kw).asnumpy()
            np.testing.assert_array_equal(got, want)
        got = mt.nd.imdecode(buf, mean=mean).asnumpy()
        want = mj.nd.imdecode(buf, mean=mj.nd.array(np.full(3, 10.0,
                                                            np.float32)))
        np.testing.assert_array_equal(got, want.asnumpy())
    with pytest.raises(mt.MXNetError, match="cannot decode"):
        mt.opencv.imdecode(b"not an image")


@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("size", [(20, 56), (61, 17)])
def test_resize_equals_jax(interp, size):
    img = _image(np.random.RandomState(interp))
    with mt.cpu():
        for src in (img, img.astype(np.float32) / 7.0):
            got = mt.opencv.resize(mt.nd.array(src, dtype=src.dtype), size,
                                   interp).asnumpy()
            want = mj.opencv.resize(mj.nd.array(src, dtype=src.dtype), size,
                                    interp).asnumpy()
            assert got.shape == want.shape == (size[1], size[0], 3)
            assert got.dtype == want.dtype == src.dtype
            if src.dtype == np.uint8:
                # rounding of sums that land within f32 rounding of .5
                diff = np.abs(got.astype(int) - want.astype(int))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    with pytest.raises(mt.MXNetError, match="interp"):
        mt.opencv.resize(mt.nd.array(img, ctx=mt.cpu()), (4, 4), 9)


@pytest.mark.parametrize("border", [0, 1, 2, 3])
def test_copy_make_border_equals_jax(border):
    img = _image(np.random.RandomState(1))
    with mt.cpu():
        got = mt.opencv.copyMakeBorder(mt.nd.array(img, dtype=np.uint8),
                                       3, 1, 2, 4, border, 7.0).asnumpy()
        want = mj.opencv.copyMakeBorder(mj.nd.array(img, dtype=np.uint8),
                                        3, 1, 2, 4, border, 7.0).asnumpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_scanned_fit_reads_one_chunk_ahead(monkeypatch):
    """The scanned fit stages K batches at a time: when each chunk runs,
    the iterator has handed out no batch past it (an epoch of ImageNet
    does not fit in host memory)."""
    from mxnet_tpu_torch.parallel import fit_trainer

    monkeypatch.setenv("MXNET_TRAIN_SCAN_K", "2")
    rng = np.random.RandomState(0)
    yielded, at_chunk = [0], []

    class Counting(mt.io.NDArrayIter):
        def next(self):
            b = super().next()
            yielded[0] += 1
            return b

    real = fit_trainer.FitTrainer.run_chunk

    def run_chunk(self, chunk):
        at_chunk.append(yielded[0])
        return real(self, chunk)

    monkeypatch.setattr(fit_trainer.FitTrainer, "run_chunk", run_chunk)
    it = Counting(rng.rand(20, 1, 28, 28).astype(np.float32),
                  np.arange(20) % 10, batch_size=4)
    model = mt.FeedForward(mt.models.get_lenet(), ctx=mt.cpu(), num_epoch=1,
                           learning_rate=0.1)
    model.fit(X=it)
    assert at_chunk == [2, 4, 5]

"""The port's RecordIO files, im2rec and streams against the JAX
package's, on the CPU.

- the same records written by either package give the same bytes, and
  each package reads the other's file back (single- and multi-label
  headers, ``pack_img`` as JPEG and PNG, a payload holding the framing
  magic, which the writer splits into a multipart record);
- ``MXIndexedRecordIO``'s ``.rec`` and ``.idx`` bytes equal, and its
  random access returns the records written under each key;
- ``record_index`` gives the JAX package's offsets, writes the same
  ``.recidx`` cache bytes, and quarantines a corrupt cache to
  ``.recidx.corrupt`` and rebuilds;
- a damaged file read under ``corrupt="skip"`` gives the same surviving
  records and the same resync count as the JAX package's reader;
  ``"raise"`` raises in both;
- ``tools/torch_im2rec.py`` against ``tools/im2rec.py`` on a 20-image
  folder of two classes: ``.lst``, ``.rec`` and ``.idx`` byte-equal;
- ``stream.py`` is a byte copy of the JAX package's; ``nd.save`` to a
  ``mem://`` URI gives the JAX package's bytes, and each package's
  ``load`` reads the other's; ``symbol.save``/``load`` go through the
  stream too; ``s3://`` without boto3 raises ``MXNetError``.

The JAX package's native reader and writer are turned off
(``MXNET_NATIVE=0``, which ``_native.load`` reads on every call) where
its file path is compared, as in its own skip-policy tests.
"""
import importlib.util
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

ROOT = Path(__file__).resolve().parents[1]
MAGIC = struct.pack("<I", 0xCED7230A)


def _records(pkg):
    """Packed records exercising every header kind and a multipart
    payload; the same bytes for either package's ``pack``."""
    rng = np.random.RandomState(0)
    img = (rng.rand(20, 24, 3) * 255).astype(np.uint8)
    r = pkg.recordio
    return [
        r.pack(r.IRHeader(0, 3.0, 7, 0), b"plain payload"),
        r.pack(r.IRHeader(0, [1.0, 2.5, -4.0], 8, 9), b"multi-label"),
        r.pack(r.IRHeader(0, 1.0, 9, 0), b"ab" + MAGIC + b"cd" + MAGIC),
        r.pack_img(r.IRHeader(0, 2.0, 10, 0), img, quality=90),
        r.pack_img(r.IRHeader(0, 0.0, 11, 0), img, img_fmt=".png"),
        b"",
    ]


def _write(pkg, path, records):
    w = pkg.recordio.MXRecordIO(str(path), "w")
    for rec in records:
        w.write(rec)
    w.close()


def _read(pkg, path, **kw):
    r = pkg.recordio.MXRecordIO(str(path), "r", **kw)
    out = []
    while True:
        s = r.read()
        if s is None:
            break
        out.append(s)
    r.close()
    return out, r.num_skipped


@pytest.fixture
def pure_python_jax(monkeypatch):
    monkeypatch.setenv("MXNET_NATIVE", "0")


def test_pack_bytes_equal_jax():
    assert _records(mt) == _records(mj)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_record_files_byte_equal_and_read_across(tmp_path, writer,
                                                 pure_python_jax):
    records = _records(mt)
    paths = {}
    for name, pkg in (("torch", mt), ("jax", mj)):
        paths[name] = tmp_path / (name + ".rec")
        _write(pkg, paths[name], records)
    assert paths["torch"].read_bytes() == paths["jax"].read_bytes()
    for pkg in (mt, mj):
        got, skipped = _read(pkg, paths[writer])
        assert got == records and skipped == 0


def test_unpack_and_unpack_img_equal_jax():
    for rec in _records(mt)[:5]:
        ht, st = mt.recordio.unpack(rec)
        hj, sj = mj.recordio.unpack(rec)
        assert st == sj and (ht.flag, ht.id, ht.id2) == (hj.flag, hj.id,
                                                         hj.id2)
        np.testing.assert_array_equal(ht.label, hj.label)
    for rec in _records(mt)[3:5]:
        for iscolor in (-1, 0, 1):
            ht, at = mt.recordio.unpack_img(rec, iscolor)
            hj, aj = mj.recordio.unpack_img(rec, iscolor)
            np.testing.assert_array_equal(at, aj)
            assert at.dtype == aj.dtype and ht.id == hj.id


def test_indexed_record_io_idx_bytes_and_random_access(tmp_path,
                                                       pure_python_jax):
    records = _records(mt)
    for name, pkg in (("torch", mt), ("jax", mj)):
        w = pkg.recordio.MXIndexedRecordIO(str(tmp_path / (name + ".idx")),
                                           str(tmp_path / (name + ".rec")),
                                           "w")
        for key, rec in zip((5, 3, 11, 0, 7, 2), records):
            w.write_idx(key, rec)
        w.close()
    for suffix in (".rec", ".idx"):
        assert (tmp_path / ("torch" + suffix)).read_bytes() == (
            tmp_path / ("jax" + suffix)).read_bytes()
    r = mt.recordio.MXIndexedRecordIO(str(tmp_path / "jax.idx"),
                                      str(tmp_path / "jax.rec"), "r")
    assert r.keys() == [5, 3, 11, 0, 7, 2]
    for key, rec in reversed(list(zip(r.keys(), records))):
        assert r.read_idx(key) == rec
    r.close()


def test_record_index_cache_and_quarantine(tmp_path):
    records = _records(mt)
    offsets = {}
    for name, pkg in (("torch", mt), ("jax", mj)):
        path = tmp_path / name / "d.rec"
        path.parent.mkdir()
        _write(mt, path, records)
        offsets[name] = pkg.recordio.record_index(str(path))
        cache = Path(str(path) + ".recidx")
        assert cache.exists()
        # a second call reads the cache
        assert pkg.recordio.record_index(str(path)) == offsets[name]
        cache.write_bytes(b"garbage, not an index")
        assert pkg.recordio.record_index(str(path)) == offsets[name]
        assert Path(str(cache) + ".corrupt").read_bytes() == \
            b"garbage, not an index"
    assert offsets["torch"] == offsets["jax"]
    assert len(offsets["torch"]) == len(records)
    t, j = (Path(tmp_path / n / "d.rec.recidx").read_bytes()[8 + 16:]
            for n in ("torch", "jax"))
    assert t == j   # the offset table; the head carries each file's mtime
    r = mt.recordio.MXRecordIO(str(tmp_path / "torch" / "d.rec"), "r")
    assert r.num_records() == len(records)
    r.seek_record(3)
    assert r.read() == records[3]
    r.close()


def _damaged(path, records):
    """``records`` packed with the header of the second and the length
    word of the fifth broken."""
    _write(mt, path, records)
    raw = bytearray(path.read_bytes())
    offs = mt.recordio._scan_record_offsets(str(path))
    raw[offs[1]:offs[1] + 4] = b"\xde\xad\xbe\xef"
    raw[offs[4] + 4:offs[4] + 8] = struct.pack("<I", 1 << 28)
    path.write_bytes(bytes(raw))


def test_corrupt_skip_matches_jax_and_raise_raises(tmp_path,
                                                   pure_python_jax):
    records = [b"record %d " % i + bytes(range(i * 7 % 50))
               for i in range(9)]
    path = tmp_path / "bad.rec"
    _damaged(path, records)
    got_t = _read(mt, path, corrupt="skip")
    got_j = _read(mj, path, corrupt="skip")
    assert got_t == got_j
    assert got_t[1] >= 2 and set(got_t[0]) <= set(records)
    assert mt.recordio.record_index(str(path), cache=False) == \
        mj.recordio.record_index(str(path), cache=False)
    for pkg, err in ((mt, mt.MXNetError), (mj, mj.base.MXNetError)):
        with pytest.raises(err):
            _read(pkg, path, corrupt="raise")
    with pytest.raises(ValueError):
        mt.recordio.MXRecordIO(str(path), "r", corrupt="ignore")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        "tool_" + name, ROOT / "tools" / (name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_im2rec_bytes_equal_jax(tmp_path, monkeypatch, pure_python_jax):
    rng = np.random.RandomState(4)
    root = tmp_path / "images"
    for i in range(20):
        d = root / ("class%d" % (i % 2))
        d.mkdir(parents=True, exist_ok=True)
        h, w = rng.randint(24, 60, 2)
        arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / ("%02d.%s" % (i, "png" if i % 3
                                                     else "jpg")))
    out = {}
    for name in ("im2rec", "torch_im2rec"):
        tool = _tool(name)
        prefix = tmp_path / name / "train"
        prefix.parent.mkdir()
        for extra in (["--list", "--recursive"],
                      ["--resize", "32", "--quality", "90",
                       "--num-thread", "3"]):
            monkeypatch.setattr(sys, "argv", [name + ".py", *extra,
                                              str(prefix), str(root)])
            assert tool.main() == 0
        out[name] = [Path(str(prefix) + s).read_bytes()
                     for s in (".lst", ".rec", ".idx")]
    assert out["im2rec"] == out["torch_im2rec"]
    assert out["im2rec"][0].count(b"\n") == 20


def test_stream_is_a_copy():
    assert (ROOT / "mxnet_tpu_torch" / "stream.py").read_bytes() == (
        ROOT / "mxnet_tpu" / "stream.py").read_bytes()


def test_nd_save_to_mem_equals_jax():
    rng = np.random.RandomState(2)
    arrays = {"w": rng.rand(3, 4).astype(np.float32),
              "i": np.arange(5, dtype=np.int32),
              "b": (rng.rand(2, 2) * 255).astype(np.uint8)}
    mt.nd.save("mem://ckpt/torch.params",
               {k: mt.nd.array(v, ctx=mt.cpu(), dtype=v.dtype)
                for k, v in arrays.items()})
    mj.nd.save("mem://ckpt/jax.params",
               {k: mj.nd.array(v, ctx=mj.cpu(), dtype=v.dtype)
                for k, v in arrays.items()})
    with mt.stream.open_stream("mem://ckpt/torch.params") as f:
        tb = f.read()
    with mj.stream.open_stream("mem://ckpt/jax.params") as f:
        jb = f.read()
    assert tb == jb
    # each package's mem:// store is its own: hand the bytes across
    with mt.stream.open_stream("mem://ckpt/from_jax.params", "wb") as f:
        f.write(jb)
    back = mt.nd.load("mem://ckpt/from_jax.params")
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k].asnumpy(), v)
    assert "ckpt/torch.params" in mt.stream.mem_store()
    assert mt.stream.exists("mem://ckpt/torch.params")
    assert not mt.stream.exists("mem://ckpt/none.params")


def test_symbol_save_load_through_stream():
    with mt.NameManager():
        sym = mt.models.get_lenet()
    sym.save("mem://sym/lenet-symbol.json")
    back = mt.sym.load("mem://sym/lenet-symbol.json")
    assert back.tojson() == sym.tojson()


def test_stream_refusals():
    with pytest.raises(mt.MXNetError, match="boto3"):
        mt.stream.open_stream("s3://bucket/key.params")
    with pytest.raises(mt.MXNetError, match="unsupported"):
        mt.stream.open_stream("mem://x", "ab")
    with pytest.raises(mt.MXNetError, match="unknown stream scheme"):
        mt.stream.open_stream("gopher://x")
    with pytest.raises(FileNotFoundError):
        mt.stream.open_stream("mem://never/written")
    # an exception inside the with body commits nothing
    with pytest.raises(RuntimeError):
        with mt.stream.open_stream("mem://aborted", "wb") as f:
            f.write(b"half")
            raise RuntimeError("stop")
    assert not mt.stream.exists("mem://aborted")

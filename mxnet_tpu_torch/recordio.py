"""RecordIO: binary record pack/read (ref: python/mxnet/recordio.py:1-275,
dmlc-core recordio format used by src/io/iter_image_recordio.cc).

Format-compatible with the reference so existing .rec datasets pack/unpack
byte-identically: records framed as [kMagic u32][(cflag<<29)|len u32][data,
4-byte aligned]; image records carry an IRHeader (flag, label, id, id2).

mxnet_tpu_torch's copy of ``mxnet_tpu/recordio.py``: the same framing,
index cache and ``corrupt`` policy, through one route, the Python reader
and writer. Reads fire the ``rio.read`` fault point; telemetry counts
``io.records_skipped_total`` and ``io.record_index_corrupt_total``. Not
carried over: the native reader and writer (``src/recordio.cc`` with
its read-ahead thread).
"""
from __future__ import annotations

import collections
import os
import struct

import numpy as _np

from . import telemetry as _tel
from .base import MXNetError
from .resilience import faults as _faults

__all__ = [
    "MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
    "pack_img", "unpack_img", "record_index",
]

_kMagic = 0xCED7230A
_kLenMask = (1 << 29) - 1
_MAGIC_BYTES = struct.pack("<I", _kMagic)

IRHeader = collections.namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)

#: sidecar suffix for the cached record-offset table (record_index)
_IDX_CACHE_SUFFIX = ".recidx"
_IDX_CACHE_MAGIC = b"MXRIDX1\n"


def _index_resync(f, from_pos, size):
    """Next 4-byte-aligned magic strictly after ``from_pos``, or None.
    The index-builder's twin of MXRecordIO._resync: a damaged header
    must not truncate the whole tail of the table."""
    pos = (from_pos + 4) & ~3
    f.seek(pos)
    tail = b""
    while True:
        chunk = f.read(1 << 16)
        if not chunk:
            return None
        buf = tail + chunk
        base = pos - len(tail)
        i = buf.find(_MAGIC_BYTES)
        while i != -1:
            if (base + i) % 4 == 0:
                return base + i
            i = buf.find(_MAGIC_BYTES, i + 1)
        tail = buf[-3:]
        pos += len(chunk)
        if pos > size:
            return None


def _scan_record_offsets(path):
    """Byte offset of every LOGICAL record's first header in a packed
    file, by walking the [magic][cflag|len] framing and seeking over
    payloads (no payload bytes are read). Multipart records (cflag
    1..3) index at their head part. A corrupt header resyncs to the
    next aligned magic (the corrupt="skip" discipline): the damaged
    record simply has no table entry, so readers seeking through the
    index silently skip it — the same records the sequential skip path
    would lose."""
    offsets = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        open_multipart = False
        while True:
            pos = f.tell()
            head = f.read(8)
            if len(head) < 8:
                break
            magic, lrec = struct.unpack("<II", head)
            length = lrec & _kLenMask
            cflag = lrec >> 29
            bad = magic != _kMagic or pos + 8 + length > size
            if not bad and (cflag in (2, 3)) and not open_multipart:
                bad = True  # orphan continuation: its head is gone
            if bad:
                nxt = _index_resync(f, pos, size)
                if nxt is None:
                    break
                f.seek(nxt)
                open_multipart = False
                continue
            if cflag == 0 or cflag == 1:
                offsets.append(pos)
                open_multipart = cflag == 1
            if cflag == 3:
                open_multipart = False
            f.seek(length + ((4 - length % 4) % 4), os.SEEK_CUR)
    return offsets


def _quarantine_index_cache(cache_path, why):
    """PR 6 tuning-db discipline: an undecodable sidecar is renamed
    aside (never deleted — it is evidence) and counted; the caller
    rebuilds from the authoritative .rec."""
    if _tel.ENABLED:
        _tel.counter("io.record_index_corrupt_total").inc()
    try:
        os.replace(cache_path, cache_path + ".corrupt")
    except OSError:
        pass
    import logging

    logging.warning("recordio: quarantined corrupt record-index cache "
                    "%s (%s) — rebuilding from the .rec", cache_path, why)


def record_index(path, cache=True):
    """Record-number -> byte-offset table for a packed RecordIO file.

    Built once by scanning the framing headers and cached beside the
    ``.rec`` (``<path>.recidx``) keyed by the file's mtime+size, so a
    frontier restore (data_service) or any random access is an O(1)
    seek instead of an O(n) re-read of the pack. A stale cache (the
    .rec changed) silently rebuilds; an undecodable cache is
    quarantined to ``<path>.recidx.corrupt`` and counted
    — the tuning-db discipline:
    corruption never crashes a run. Returns a list of byte offsets."""
    st = os.stat(path)
    cache_path = path + _IDX_CACHE_SUFFIX
    if cache and os.path.exists(cache_path):
        try:
            with open(cache_path, "rb") as f:
                blob = f.read()
            if not blob.startswith(_IDX_CACHE_MAGIC):
                raise ValueError("bad index magic")
            mtime_ns, size, count = struct.unpack(
                "<qqq", blob[len(_IDX_CACHE_MAGIC):len(_IDX_CACHE_MAGIC) + 24])
            body = blob[len(_IDX_CACHE_MAGIC) + 24:]
            if len(body) != 8 * count:
                raise ValueError("truncated offset table")
            if mtime_ns == st.st_mtime_ns and size == st.st_size:
                return list(struct.unpack("<%dq" % count, body))
            # stale, not corrupt: the .rec was rewritten — rebuild below
        except (ValueError, struct.error) as e:
            _quarantine_index_cache(cache_path, e)
    offsets = _scan_record_offsets(path)
    if cache:
        blob = _IDX_CACHE_MAGIC + struct.pack(
            "<qqq", st.st_mtime_ns, st.st_size, len(offsets)) + \
            struct.pack("<%dq" % len(offsets), *offsets)
        tmp = "%s.tmp-%d" % (cache_path, os.getpid())
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, cache_path)
        except OSError:
            pass  # a read-only dataset dir still gets the in-memory table
    return offsets


class MXRecordIO:
    """Sequential record reader/writer (ref: recordio.py:14), through
    Python file objects.

    ``corrupt`` (readers) selects the bad-record policy: ``"raise"``
    (default) fails on the first invalid magic/truncated payload;
    ``"skip"`` resyncs to the next 4-byte-aligned magic marker and keeps
    going, counting each resync in ``num_skipped`` — one flipped sector
    must not kill a whole epoch. Resync is sound under the dmlc framing:
    payload bytes never contain the magic (the writer splits them into
    multipart records), so the next magic is a real record boundary.
    """

    def __init__(self, uri, flag, corrupt="raise"):
        if corrupt not in ("raise", "skip"):
            raise ValueError('corrupt must be "raise" or "skip", got %r'
                             % (corrupt,))
        self.uri = uri
        self.flag = flag
        self.corrupt = corrupt
        #: resyncs performed under corrupt="skip" (≈ records lost)
        self.num_skipped = 0
        self.handle = None
        # open() can fail partway (bad path/permissions); close() and
        # __del__ must already be safe to call at that point
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.writable = True
        elif self.flag == "r":
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.handle = open(self.uri, "wb" if self.writable else "rb")
        self.is_open = True

    def close(self):
        # getattr-guarded: a constructor that failed before (or inside)
        # open() leaves a partially initialized object, and close() /
        # __del__ on it must be a no-op, not a second exception
        if not getattr(self, "is_open", False):
            return
        if getattr(self, "handle", None) is not None:
            self.handle.close()
            self.handle = None
        self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.handle.tell()

    def _seek(self, pos):
        assert not self.writable
        self.handle.seek(pos)

    def seek_record(self, offset):
        """Position the reader at record number ``offset`` (0-based) in
        O(1) via the cached offset table (:func:`record_index`) — the
        data service's frontier restore, which must not re-scan the
        pack. Raises IndexError past the end; ``seek_record(n)`` with
        ``n == num_records()`` is allowed and positions at EOF."""
        assert not self.writable
        idx = self._record_offsets()
        n = int(offset)
        if n < 0 or n > len(idx):
            raise IndexError(
                "record offset %d out of range [0, %d] in %s"
                % (n, len(idx), self.uri))
        self._seek(idx[n] if n < len(idx) else os.path.getsize(self.uri))

    def num_records(self):
        """Logical record count of the pack (index length)."""
        return len(self._record_offsets())

    def _record_offsets(self):
        cached = getattr(self, "_rec_offsets", None)
        if cached is None:
            cached = self._rec_offsets = record_index(self.uri)
        return cached

    def write(self, buf):
        assert self.writable
        data = buf if isinstance(buf, bytes) else bytes(buf)
        if len(data) > _kLenMask:
            raise MXNetError("record too large: %d > %d bytes (29-bit length framing)"
                             % (len(data), _kLenMask))
        # dmlc multipart protocol: payloads containing the magic bytes are
        # split at each occurrence (magic removed, cflag 1/2/3 in the top 3
        # bits); the reader re-inserts the magic when joining parts
        # (ref: dmlc-core RecordIOWriter::WriteRecord)
        parts = data.split(_MAGIC_BYTES)
        for i, part in enumerate(parts):
            if len(parts) == 1:
                cflag = 0
            elif i == 0:
                cflag = 1
            elif i == len(parts) - 1:
                cflag = 3
            else:
                cflag = 2
            self.handle.write(
                struct.pack("<II", _kMagic, (cflag << 29) | len(part)))
            self.handle.write(part)
            pad = (4 - len(part) % 4) % 4
            if pad:
                self.handle.write(b"\x00" * pad)

    def _note_skip(self):
        """Count one lost record (corrupt="skip" policy) in
        ``num_skipped`` and, when telemetry is on, in the process-wide
        ``io.records_skipped_total`` counter."""
        self.num_skipped += 1
        if _tel.ENABLED:
            _tel.counter("io.records_skipped_total").inc()

    def _resync(self, from_pos):
        """corrupt="skip" recovery: scan forward from `from_pos` for the
        next 4-byte-aligned magic marker, seek there, and count the
        resync. Returns False at EOF (nothing left to recover)."""
        self._note_skip()
        # next aligned offset strictly AFTER the bad header start, so a
        # magic with a corrupt length word cannot re-match forever
        pos = (from_pos + 4) & ~3
        self.handle.seek(pos)
        tail = b""
        while True:
            chunk = self.handle.read(1 << 16)
            if not chunk:
                return False
            buf = tail + chunk
            base = pos - len(tail)
            i = buf.find(_MAGIC_BYTES)
            while i != -1:
                if (base + i) % 4 == 0:
                    self.handle.seek(base + i)
                    return True
                i = buf.find(_MAGIC_BYTES, i + 1)
            # keep 3 bytes: a magic straddling the chunk boundary
            tail = buf[-3:]
            pos += len(chunk)

    def read(self):
        assert not self.writable
        _faults.point("rio.read")
        skip = self.corrupt == "skip"
        out = None  # accumulates multipart records (cflag 1..3)
        # resync can land on the continuation (cflag 2/3) of the record
        # whose head was destroyed; those parts belong to the loss the
        # resync already counted, so they are dropped without re-counting
        dropping = False
        while True:
            start = self.handle.tell()
            head = self.handle.read(8)
            if len(head) < 8:
                if out is not None:
                    if skip:  # torn tail: drop the partial multipart
                        self._note_skip()
                        return None
                    raise MXNetError("truncated multipart record in %s" % self.uri)
                return None
            magic, lrec = struct.unpack("<II", head)
            if magic != _kMagic:
                if skip:
                    out = None
                    if self._resync(start):
                        dropping = True
                        continue
                    return None
                raise MXNetError("invalid record magic in %s" % self.uri)
            length = lrec & _kLenMask
            cflag = lrec >> 29
            data = self.handle.read(length)
            if len(data) < length:
                if skip:
                    # short payload: either true EOF truncation or a
                    # corrupt LENGTH word that ran past the next records
                    # — resync rather than treating it as EOF, so one
                    # flipped length byte cannot drop the rest of the
                    # epoch (_resync counts the loss; at real EOF it
                    # finds nothing and we return None below)
                    out = None
                    if self._resync(start):
                        dropping = True
                        continue
                    return None
                raise MXNetError("truncated record payload in %s" % self.uri)
            pad = (4 - length % 4) % 4
            if pad:
                self.handle.read(pad)
            if cflag == 0:
                if out is not None and skip:
                    # a fresh single-part record while a multipart was
                    # open means the multipart's tail was lost
                    self._note_skip()
                return data
            if cflag == 1:
                if out is not None and skip:
                    self._note_skip()
                out = data
            else:  # 2 = middle, 3 = end: re-insert the split-out magic
                if out is None:
                    # continuation with no head: its record is already
                    # lost — fabricating a value from the tail parts
                    # would feed garbage to the caller
                    if not skip:
                        raise MXNetError(
                            "orphan multipart continuation in %s" % self.uri)
                    if not dropping:
                        self._note_skip()
                        dropping = True
                    if cflag == 3:
                        dropping = False
                    continue
                out = out + _MAGIC_BYTES + data
                if cflag == 3:
                    return out


class MXIndexedRecordIO(MXRecordIO):
    """Keyed random access via .idx sidecar (ref: recordio.py:87)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}  # insertion-ordered: file order for readers
        self.key_type = key_type
        super().__init__(uri, flag)
        if not self.writable and os.path.isfile(idx_path):
            with open(idx_path) as fin:
                for line in fin:
                    line = line.strip().split("\t")
                    self.idx[key_type(line[0])] = int(line[1])

    def close(self):
        if getattr(self, "writable", False) and getattr(self, "is_open", False):
            with open(self.idx_path, "w") as fout:
                for k, v in self.idx.items():
                    fout.write("%s\t%d\n" % (str(k), v))
        super().close()

    def keys(self):
        """All keys, in index order (ref: recordio.py:167 keys())."""
        return list(self.idx)

    def reset(self):
        """Writer: truncate record and index; reader: rewind
        (ref: recordio.py:137)."""
        if self.writable:
            self.idx = {}
        super().reset()

    def seek(self, idx):
        assert not self.writable
        pos = self.idx[idx]
        self._seek(pos)

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos


def pack(header, s):
    """Pack IRHeader + payload (ref: recordio.py:156)."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, 0, float(header.label), header.id, header.id2)
        return hdr + s
    label = _np.asarray(header.label, dtype=_np.float32)
    hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s):
    """ref: recordio.py:177."""
    flag, label, idx, idx2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = _np.frombuffer(s[: flag * 4], dtype=_np.float32)
        s = s[flag * 4:]
    header = IRHeader(flag, label, idx, idx2)
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode image + pack (ref: recordio.py:198); PIL replaces OpenCV."""
    import io as _io

    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise MXNetError("pack_img requires PIL") from e
    arr = _np.asarray(img).astype(_np.uint8)
    im = Image.fromarray(arr)
    buf = _io.BytesIO()
    fmt = "JPEG" if img_fmt in (".jpg", ".jpeg") else "PNG"
    im.save(buf, format=fmt, quality=quality)
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=-1):
    """ref: recordio.py:228."""
    import io as _io

    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise MXNetError("unpack_img requires PIL") from e
    header, img_bytes = unpack(s)
    img = Image.open(_io.BytesIO(img_bytes))
    if iscolor == 0:
        img = img.convert("L")
    elif iscolor == 1:
        img = img.convert("RGB")
    return header, _np.asarray(img)

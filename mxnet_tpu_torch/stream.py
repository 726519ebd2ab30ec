"""URI-dispatched streams: the dmlc::Stream role.

The reference reads and writes every artifact through
``dmlc::Stream::Create(uri)``, which dispatches on the URI scheme so
``s3://bucket/model.params`` and ``hdfs://nn/path`` work anywhere a local
path does (ref: dmlc-core/include/dmlc/io.h:31-68, src/io.cc:34-87,
src/io/s3_filesystem.cc, hdfs_filesystem.cc). This module gives
NDArray/Symbol/checkpoint IO the same property.

Schemes:

- *(none)* / ``file://``  — local filesystem (builtin ``open``).
- ``mem://``              — in-process object store. The testable stand-in
  for a remote filesystem (and genuinely useful for ephemeral artifacts);
  plays the role dmlc's unit tests give their mock filesystem.
- ``s3://``               — via ``boto3`` when installed; a clear
  MXNetError otherwise (the reference likewise errors when built
  without USE_S3, s3_filesystem.cc:28).
- ``hdfs://``             — via ``pyarrow.fs.HadoopFileSystem`` when
  installed; a clear MXNetError otherwise (ref USE_HDFS gate).

Remote writes are write-behind: bytes buffer locally and upload once on
``close()`` (the reference's S3 stream buffers multipart uploads the
same way, s3_filesystem.cc WriteStream).

Custom schemes can be registered with ``register_scheme`` — the
``dmlc::io::FileSystem::Create`` extension point.
"""
from __future__ import annotations

import io
import threading

from .base import MXNetError

__all__ = ["open_stream", "register_scheme", "exists", "mem_store"]

# mem:// backing store (path -> bytes), process-wide
_MEM = {}
_MEM_LOCK = threading.Lock()

_SCHEMES = {}


def register_scheme(scheme, opener):
    """Register ``opener(path, mode) -> file-like`` for ``scheme://``
    URIs (the FileSystem::Create registry role)."""
    _SCHEMES[scheme] = opener


def _split(uri):
    if "://" in str(uri):
        scheme, rest = str(uri).split("://", 1)
        return scheme, rest
    return "", str(uri)


class _WriteBehind(io.BytesIO):
    """Buffer writes locally; hand the final bytes to ``commit`` on
    close — the upload-on-close pattern of remote write streams.

    Abort semantics: leaving the ``with`` body via an exception marks
    the stream aborted and nothing is committed — a half-written buffer
    must never overwrite the previous good remote object. A failed
    commit leaves the stream committable again (close() can be retried)."""

    def __init__(self, commit):
        super().__init__()
        self._commit = commit
        self._done = False

    def _payload(self):
        return self.getvalue()

    def abort(self):
        self._done = True

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.abort()
        self.close()

    def close(self):
        if not self._done:
            self._commit(self._payload())
            self._done = True
        super().close()


class _TextWriteBehind(io.StringIO):
    """Text-mode variant: commits UTF-8 bytes on close; same abort
    semantics as _WriteBehind."""

    def __init__(self, commit):
        super().__init__()
        self._commit = commit
        self._done = False

    def abort(self):
        self._done = True

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.abort()
        self.close()

    def close(self):
        if not self._done:
            self._commit(self.getvalue().encode("utf-8"))
            self._done = True
        super().close()


def _write_behind(commit, mode):
    return _WriteBehind(commit) if "b" in mode else _TextWriteBehind(commit)


def _open_mem(path, mode):
    if "w" in mode:
        def commit(data):
            with _MEM_LOCK:
                _MEM[path] = data

        return _write_behind(commit, mode)
    with _MEM_LOCK:
        if path not in _MEM:
            raise FileNotFoundError("mem://%s" % path)
        data = _MEM[path]
    return io.BytesIO(data) if "b" in mode else io.StringIO(
        data.decode("utf-8"))


def _open_file(path, mode):
    return open(path, mode)


def _s3_client():
    """Shared boto3 client + import gate for open/exists."""
    try:
        import boto3
    except ImportError as e:
        raise MXNetError(
            "s3:// stream requires boto3 (the reference likewise needs "
            "USE_S3=1; ref dmlc-core/src/io.cc:49)") from e
    return boto3.client("s3")


def _hdfs_fs(path):
    """Shared HadoopFileSystem + path parse + import gate: returns
    (fs, absolute_path)."""
    try:
        from pyarrow import fs as _pafs
    except ImportError as e:
        raise MXNetError(
            "hdfs:// stream requires pyarrow (the reference likewise "
            "needs USE_HDFS=1; ref dmlc-core/src/io.cc:61)") from e
    host, _, rest = path.partition("/")
    h, _, p = host.partition(":")
    fs = _pafs.HadoopFileSystem(h or "default", int(p) if p else 8020)
    return fs, "/" + rest


def _open_s3(path, mode):
    bucket, _, key = path.partition("/")
    s3 = _s3_client()
    if "w" in mode:
        return _write_behind(
            lambda data: s3.put_object(Bucket=bucket, Key=key, Body=data),
            mode)
    body = s3.get_object(Bucket=bucket, Key=key)["Body"].read()
    return io.BytesIO(body) if "b" in mode else io.StringIO(
        body.decode("utf-8"))


def _open_hdfs(path, mode):
    hdfs, abspath = _hdfs_fs(path)
    if "w" in mode:
        def commit(data):
            with hdfs.open_output_stream(abspath) as f:
                f.write(data)

        return _write_behind(commit, mode)
    with hdfs.open_input_stream(abspath) as f:
        body = f.read()
    return io.BytesIO(body) if "b" in mode else io.StringIO(
        body.decode("utf-8"))


register_scheme("", _open_file)
register_scheme("file", _open_file)
register_scheme("mem", _open_mem)
register_scheme("s3", _open_s3)
register_scheme("hdfs", _open_hdfs)


def open_stream(uri, mode="rb"):
    """Open ``uri`` for reading or writing, dispatching on scheme —
    the dmlc::Stream::Create entry point. Returns a file-like usable as
    a context manager. Supported modes: r / rb / w / wb (streams are
    whole-object, like dmlc::Stream; append/update would silently
    degrade on remote schemes, so they are rejected up front — for
    EVERY scheme, local files included, so code written against file://
    cannot quietly depend on modes that break the moment the URI moves
    to s3:// or hdfs://)."""
    scheme, path = _split(uri)
    if mode not in ("r", "rb", "w", "wb"):
        raise MXNetError(
            "stream mode %r unsupported for %r (whole-object streams "
            "allow r/rb/w/wb only)" % (mode, uri))
    opener = _SCHEMES.get(scheme)
    if opener is None:
        raise MXNetError(
            "unknown stream scheme %r in %r (registered: %s)"
            % (scheme, uri, sorted(_SCHEMES)))
    return opener(path, mode)


def exists(uri):
    """True if the URI points at a readable object. Uses metadata
    probes (head_object / get_file_info), never a full download; a
    missing client library raises the same MXNetError gate as
    open_stream would."""
    scheme, path = _split(uri)
    if scheme in ("", "file"):
        import os

        return os.path.exists(path)
    if scheme == "mem":
        with _MEM_LOCK:
            return path in _MEM
    if scheme == "s3":
        s3 = _s3_client()
        import botocore.exceptions

        bucket, _, key = path.partition("/")
        try:
            s3.head_object(Bucket=bucket, Key=key)
            return True
        except botocore.exceptions.ClientError as e:
            code = str(e.response.get("Error", {}).get("Code", ""))
            if code in ("404", "NoSuchKey", "NotFound"):
                return False
            raise  # 403/throttling etc. is an error, not "absent"
    if scheme == "hdfs":
        from pyarrow import fs as _pafs

        hdfs, abspath = _hdfs_fs(path)
        info = hdfs.get_file_info(abspath)
        return info.type != _pafs.FileType.NotFound
    try:
        open_stream(uri, "rb").close()
        return True
    except MXNetError:
        raise  # a client-library gate is an error, not "absent"
    except Exception:
        return False


def mem_store():
    """Snapshot of the mem:// object names (test/debug hook)."""
    with _MEM_LOCK:
        return sorted(_MEM)

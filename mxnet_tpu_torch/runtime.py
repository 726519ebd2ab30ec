"""Runtime feature detection — the make/config.mk flag surface.

Counterpart of ``mxnet_tpu/runtime.py``. The reference's capabilities are
compile-time flags (ref: make/config.mk:41-108 — USE_CUDA, USE_CUDNN,
USE_OPENCV, USE_BLAS, USE_DIST_KVSTORE, USE_S3, USE_HDFS, USE_NNPACK,
plugin toggles) and code queries them with #if. The port resolves the
same questions at runtime, with the JAX package's keys and ``CUDA`` (the
reference's ``USE_CUDA``) where the JAX package has ``TPU``.

>>> import mxnet_tpu_torch as mx
>>> mx.runtime.feature_list()          # {'CUDA': True, 'NATIVE_ENGINE': ...}
>>> mx.runtime.has_feature('S3')
"""
from __future__ import annotations

import functools

__all__ = ["feature_list", "has_feature", "features_summary"]


def _try_import(mod):
    try:
        __import__(mod)
        return True
    except Exception:
        return False


def _native_engine():
    """``csrc/engine.cc`` built (``build/torch_engine/``) and loadable;
    this query builds nothing."""
    from . import engine

    if not engine.library_path().exists():
        return False
    try:
        engine._engine_lib()
        return True
    except Exception:
        return False


def _profiler():
    try:
        import torch.profiler

        return hasattr(torch.profiler, "profile")
    except Exception:
        return False


@functools.lru_cache(maxsize=1)
def _feature_list_cached():
    """Detected capabilities, keyed by the reference's flag vocabulary.

    | key | reference flag | meaning here |
    |---|---|---|
    | CUDA | USE_CUDA/USE_CUDNN | a CUDA device is visible to torch |
    | NATIVE_ENGINE | (core) | csrc/engine.cc built and loadable |
    | NATIVE_RECORDIO | (dmlc recordio) | not ported: the Python reader |
    | NATIVE_IMAGEDEC | USE_OPENCV | not ported: PIL decodes |
    | OPENCV | USE_OPENCV | the mx.cv facade is importable (PIL) |
    | DIST_KVSTORE | USE_DIST_KVSTORE | torch.distributed available |
    | S3 | USE_S3 | boto3 present (stream.py s3:// backend) |
    | HDFS | USE_HDFS | pyarrow present (stream.py hdfs:// backend) |
    | TORCH | torch plugin | torch importable (mx.th) |
    | CAFFE | caffe plugin | caffe importable (gated facade) |
    | PROFILER | USE_PROFILER | torch.profiler usable |
    """
    import torch

    feats = {  # copied on return; the cached dict itself stays private
        "CUDA": torch.cuda.is_available(),
        "NATIVE_ENGINE": _native_engine(),
        "NATIVE_RECORDIO": False,
        "NATIVE_IMAGEDEC": False,
        "OPENCV": _try_import("PIL"),
        "DIST_KVSTORE": torch.distributed.is_available(),
        "S3": _try_import("boto3"),
        "HDFS": _try_import("pyarrow"),
        "TORCH": True,
        "CAFFE": _try_import("caffe"),
        "PROFILER": _profiler(),
    }
    return feats


def feature_list():
    """Detected capabilities (see _feature_list_cached for the table).
    Returns a fresh copy each call so callers cannot corrupt the cache."""
    return dict(_feature_list_cached())


def has_feature(name):
    """True if the named capability is available (KeyError on unknown
    names, so typos fail loudly like an undefined #if would)."""
    feats = _feature_list_cached()
    if name not in feats:
        raise KeyError("unknown feature %r (known: %s)"
                       % (name, sorted(feats)))
    return feats[name]


def features_summary():
    """Human-readable one-liner-per-feature block (the `mxnet.runtime`
    print idiom)."""
    return "\n".join("%-16s %s" % (k, "ON" if v else "OFF")
                     for k, v in sorted(_feature_list_cached().items()))

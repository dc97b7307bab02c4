"""The stream layer: local paths and remote URLs behind one API (the
port's copy of ``cxxnet_tpu/io/stream.py``).

A ``scheme://`` path (``gs://``, ``s3://``, ``hdfs://``, ``file://``,
``memory://`` ...) goes through fsspec, imported inside the call; a
local path through plain ``open`` and ``os``. Record files, BinaryPage
packs, mnist idx files (gzipped or not), image lists and files, mean
images, config files, checkpoints and the batch tasks' outputs are read
and written here.

Every remote operation retries with full-jitter exponential backoff
(:func:`~cxxnet_tpu_torch.resilience.retry_call`, the policy of
:func:`set_retry_policy`, which ``main.run`` takes from the
``io_retry_*`` keys). The failpoints ``io.open``, ``io.read`` and
``io.write`` fire here, at the JAX package's sites; while any ``io.*``
failpoint is armed, local operations take the same retry path, so the
failure machinery is testable without an object store.
"""

from __future__ import annotations

import gzip
import itertools
import os
import re
from typing import Callable, List

from ..config import RetryPolicy
from ..resilience import failpoints, retry_call

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.\-]*://")

#: the process's retry policy (``main.run`` sets it from the config)
_RETRY = RetryPolicy()


def set_retry_policy(policy: RetryPolicy) -> None:
    global _RETRY
    _RETRY = policy


def _with_retry(fn: Callable, what: str, path: str):
    """Remote operations (and local ones while an ``io.*`` failpoint is
    armed) through :func:`retry_call`; plain local ones bare."""
    if is_remote(path) or failpoints.armed_prefix("io."):
        return retry_call(fn, what=what, attempts=_RETRY.attempts,
                          base_delay_s=_RETRY.base_delay_s,
                          max_delay_s=_RETRY.max_delay_s,
                          jitter=_RETRY.jitter)
    return fn()


class _FailpointFile:
    """A file whose ``read`` checks ``io.read`` (handed out by
    :func:`sopen` only while that site is armed)."""

    def __init__(self, f):
        self._f = f

    def read(self, *a):
        failpoints.check("io.read", IOError)
        return self._f.read(*a)

    def __getattr__(self, name):
        return getattr(self._f, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()

    def __iter__(self):
        return iter(self._f)


def is_remote(path: str) -> bool:
    return bool(_SCHEME_RE.match(path))


def _fs(path: str):
    import fsspec
    return fsspec.core.url_to_fs(path)


def _open_raw(path: str, mode: str):
    """One open, no retry: what :func:`sopen` retries, and what the
    composite operations (:func:`read_bytes`, a remote
    :func:`write_bytes_atomic`) open inside their own single retry
    loop."""
    failpoints.check("io.open", IOError)
    if is_remote(path):
        import fsspec
        return fsspec.open(path, mode).open()
    return open(path, mode)


def sopen(path: str, mode: str = "rb"):
    """A local path or a remote URL opened as a file object."""
    f = _with_retry(lambda: _open_raw(path, mode), f"open {path}", path)
    if "r" in mode and failpoints.armed("io.read"):
        return _FailpointFile(f)
    return f


def read_bytes(path: str) -> bytes:
    """The whole object, the open and the read under one retry loop (a
    read that dies midway is retried from the start)."""
    def _read():
        with _open_raw(path, "rb") as f:
            failpoints.check("io.read", IOError)
            return f.read()
    return _with_retry(_read, f"read {path}", path)


def open_maybe_gz(path: str):
    """A binary read stream, gunzipped for ``.gz`` paths."""
    if path.endswith(".gz"):
        return gzip.GzipFile(fileobj=sopen(path, "rb"))
    return sopen(path, "rb")


def getsize(path: str) -> int:
    if is_remote(path):
        fs, key = _fs(path)
        return _with_retry(lambda: fs.size(key), f"size {path}", path)
    return os.path.getsize(path)


def exists(path: str) -> bool:
    if is_remote(path):
        fs, key = _fs(path)
        return _with_retry(lambda: fs.exists(key), f"exists {path}", path)
    return os.path.exists(path)


def isdir(path: str) -> bool:
    if is_remote(path):
        fs, key = _fs(path)
        return _with_retry(lambda: fs.isdir(key), f"isdir {path}", path)
    return os.path.isdir(path)


def listdir(path: str) -> List[str]:
    """The basenames of a directory's entries."""
    if is_remote(path):
        fs, key = _fs(path)
        names = _with_retry(lambda: fs.ls(key, detail=False),
                            f"ls {path}", path)
        return [str(n).rstrip("/").rsplit("/", 1)[-1] for n in names]
    return os.listdir(path)


def makedirs(path: str) -> None:
    if is_remote(path):
        fs, key = _fs(path)
        _with_retry(lambda: fs.makedirs(key, exist_ok=True),
                    f"makedirs {path}", path)
    else:
        os.makedirs(path, exist_ok=True)


def remove(path: str) -> None:
    """Delete one file or object (the temp-file sweep)."""
    if is_remote(path):
        fs, key = _fs(path)
        _with_retry(lambda: fs.rm(key), f"rm {path}", path)
    else:
        os.remove(path)


def getmtime(path: str) -> float:
    """The last-modified time as a unix timestamp (the temp-file sweep's
    age check); raises OSError when the backend cannot answer."""
    if is_remote(path):
        fs, key = _fs(path)
        mt = _with_retry(lambda: fs.modified(key), f"mtime {path}", path)
        return mt.timestamp() if hasattr(mt, "timestamp") else float(mt)
    return os.path.getmtime(path)


#: the sequence number of this process's temp files (the pid alone does
#: not tell two threads apart)
_TMP_SEQ = itertools.count()


def is_own_tmp(filename: str) -> bool:
    """Whether a directory entry (a basename or a path) is a temp file
    of this process, ``<name>.tmp.<pid>`` or ``<name>.tmp.<pid>.<seq>``:
    the temp-file sweep never deletes one (a writer of this process may
    be midway). Built per call, so a forked child never takes its
    parent's pid for its own."""
    return re.search(r"\.tmp\.%d(\.\d+)?$" % os.getpid(),
                     os.path.basename(filename)) is not None


def write_bytes_atomic(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically where the backend allows: a
    local file through a temp file (``<path>.tmp.<pid>.<seq>``), fsync
    and rename, so a crash leaves no torn file under the name; an
    object store writes whole objects by itself, and a remote path is
    written directly (with retry)."""
    if is_remote(path):
        def _put():
            with _open_raw(path, "wb") as f:
                failpoints.check("io.write", IOError)
                f.write(data)
        _with_retry(_put, f"write {path}", path)
        return
    tmp = f"{path}.tmp.{os.getpid()}.{next(_TMP_SEQ)}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    # a writer that dies here leaves a temp orphan beside the older rounds
    failpoints.check("io.write", IOError)
    os.replace(tmp, path)
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass          # a directory that cannot be fsynced: best effort

"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled for Hopper (``sm_90a``) into
``cxxnet_tpu_torch/build/`` at first use, under a file name keyed by a
hash of the sources, the shared headers and the flags, so an edited
source never loads a stale library. :func:`build` starts one ``nvcc``
per missing library, all at once, and waits for them together.
:func:`load_host` does the same for a host C++ source under ``native/``
(the JPEG decoder) with ``g++``.

Nothing here runs at import: the CPU-only test environment has no
``nvcc`` and imports every module. A build that fails raises with the
compiler's output; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
NATIVE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels cannot be built")


def source_path(source: str) -> str:
    return os.path.join(CSRC_DIR, source)


def lib_path(source: str) -> str:
    """Where ``source``'s library lands: keyed by the bytes of the
    source, of every shared header and of the flags."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in [source_path(source)] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build(sources: Sequence[str]) -> Dict[str, float]:
    """Compile every source in ``sources`` whose library is missing, one
    ``nvcc`` each, all started together. Returns seconds per source (0
    for a library already built). Raises with the compiler's output on
    any failure. The ptxas report (registers, spills) of each build is
    kept beside its library as ``.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs: List[tuple] = []
    times: Dict[str, float] = {}
    nvcc = None
    for src in sources:
        out = lib_path(src)
        if os.path.exists(out):
            times[src] = 0.0
            continue
        nvcc = nvcc or nvcc_path()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(src)]
        procs.append((src, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for src, out, tmp, t0, p in procs:
        log, _ = p.communicate()
        times[src] = time.perf_counter() - t0
        with open(out[:-3] + ".log", "wb") as f:
            f.write(log)
        if p.returncode != 0:
            failures.append(f"--- nvcc {src} (exit {p.returncode}):\n"
                            + log.decode("utf-8", "replace"))
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)      # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return times


def build_log(source: str) -> str:
    """The compiler's output (ptxas report) of ``source``'s build, or ''."""
    p = lib_path(source)[:-3] + ".log"
    if not os.path.exists(p):
        return ""
    with open(p, "rb") as f:
        return f.read().decode("utf-8", "replace")


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first when missing."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(lib_path(source))
            _libs[source] = lib
        return lib


GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def host_lib_path(source: str, libs: Sequence[str] = ()) -> str:
    """Where the host library of ``native/<source>`` lands: keyed by the
    bytes of the source, the flags and the libraries it links."""
    h = hashlib.sha256()
    h.update(" ".join(GXX_FLAGS + tuple(libs)).encode())
    with open(os.path.join(NATIVE_DIR, source), "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def load_host(source: str, libs: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded host library of ``native/<source>``, compiled first
    with ``g++`` (``$CXX`` when set) and linked with ``-l<lib>`` for each
    of ``libs`` when missing or when it does not load (a library built
    on another machine). Raises with the compiler's output when the
    build fails."""
    key = "host:" + source
    with _lock:
        lib = _libs.get(key)
        if lib is not None:
            return lib
        out = host_lib_path(source, libs)
        if os.path.exists(out):
            try:
                lib = ctypes.CDLL(out)
            except OSError:         # built elsewhere, against other libs
                os.remove(out)
        if lib is None:
            cxx = os.environ.get("CXX") or shutil.which("g++") \
                or shutil.which("c++")
            if cxx is None:
                raise RuntimeError(f"no C++ compiler (g++, c++ or $CXX) to "
                                   f"build {source}")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
            p = subprocess.run(
                [cxx, *GXX_FLAGS, "-o", tmp, os.path.join(NATIVE_DIR, source),
                 *(f"-l{lb}" for lb in libs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            if p.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(
                    f"building {source} with {cxx} failed (exit "
                    f"{p.returncode}):\n" + p.stdout.decode("utf-8", "replace"))
            os.replace(tmp, out)
            lib = ctypes.CDLL(out)
        _libs[key] = lib
        return lib

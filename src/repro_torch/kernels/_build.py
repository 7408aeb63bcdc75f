"""Build the port's CUDA sources with nvcc and load them with ctypes.

Every ``csrc/<name>.cu`` compiles on its own into a shared library with
a plain C interface, ``build/<name>-<key>.so`` next to this file, where
``key`` hashes the source, the shared headers ``csrc/*.cuh`` and the
compiler flags: an edited source or header builds anew, an unchanged
one loads from the build directory. The first use of any kernel builds
every source that is not built yet, one nvcc process per source, all
started together. Nothing is built when the module is imported, and
nothing is built for CPU tensors.

Building against PyTorch's headers (``torch.utils.cpp_extension``) takes
minutes per build; a plain C interface loaded with ``ctypes`` takes
seconds. Pointers and the stream pass as ``ctypes.c_void_p``, sizes as
``ctypes.c_int``; each entry point returns ``cudaGetLastError()`` after
its launch, and the wrapper raises when that is not ``cudaSuccess``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
# Guards the wrappers' launch counters: serving threads (the queue's
# pump, staging workers, replica lanes) launch kernels concurrently.
count_lock = threading.Lock()
_libs: dict = {}
# name -> {"path", "seconds", "cached", "log"}: what the last build did
BUILD_LOG: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{cuda_home}/bin); the CUDA kernels cannot be built")


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in headers():
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list:
    """The shared headers (``csrc/*.cuh``): every source's key hashes
    them too, so an edited header rebuilds every library."""
    return sorted(CSRC_DIR.glob("*.cuh"))


def build_all() -> dict:
    """Build every source that has no library yet, all in parallel.

    Returns ``BUILD_LOG``. Raises ``RuntimeError`` with nvcc's output
    when a source does not compile.
    """
    with _lock:
        pending = []
        for src in sources():
            out = _library_path(src)
            if out.exists():
                BUILD_LOG.setdefault(src.stem, {"path": str(out),
                                                "seconds": 0.0,
                                                "cached": True, "log": ""})
            else:
                pending.append((src, out))
        if not pending:
            return BUILD_LOG
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for src, out in pending:
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failures = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOG[src.stem] = {"path": str(out),
                                   "seconds": time.perf_counter() - t0,
                                   "cached": False, "log": log}
            if proc.returncode != 0:
                failures.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, out)   # atomic: no half-written library
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        return BUILD_LOG


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built at first
    use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(BUILD_LOG[name]["path"])
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

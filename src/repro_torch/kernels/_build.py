"""Build the port's CUDA sources with nvcc and load them with ctypes.

Every ``csrc/<name>.cu`` compiles on its own into a shared library with
a plain C interface, ``build/<name>-<key>.so`` next to this file, where
``key`` hashes the source, the shared headers ``csrc/*.cuh`` and the
compiler flags: an edited source or header builds anew, an unchanged
one loads from the build directory. The first use of any kernel builds
every source that is not built yet, one nvcc process per source, all
started together. Nothing is built when the module is imported, and
nothing is built for CPU tensors. nvcc's output (``-Xptxas -v``: each
kernel instance's registers, shared memory and spills) is kept beside
each library as ``<library>.log``; ``ptxas_entries`` parses it.

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
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
# Guards the wrappers' launch counters: serving threads (the queue's
# pump, staging workers, replica lanes) launch kernels concurrently.
count_lock = threading.Lock()
# Calls of each kernel wrapper since the last ``ops.reset_entry_counts``,
# on every device (a CPU tensor's plain version counts too): what the
# launch pass reads where no CUDA launch counter ticks.
entry_calls: dict = {}
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
                log = out.with_suffix(".log")
                BUILD_LOG.setdefault(src.stem, {
                    "path": str(out), "seconds": 0.0, "cached": True,
                    "log": log.read_text() if log.exists() else ""})
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
                out.with_suffix(".log").write_text(log)
                os.replace(tmp, out)   # atomic: no half-written library
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        return BUILD_LOG


# The head counts the multi-head instances of the engines' kernels and
# the GAT's coefficient kernels are built for: the served GAT's, 4 heads
# in layers 1-2 and 6 in layer 3 (``Engine.register`` refuses others).
HEADS = (4, 6)

# The operand types the kernels take (the TPU kernels' MXU types), and
# each one's name in C++ mangling.
DTYPES = (torch.float32, torch.bfloat16)
MANGLED_TYPES = {"float32": "f", "bfloat16": "13__nv_bfloat16"}


def dtype_name(dtype) -> str:
    """"float32" or "bfloat16"; ValueError for any other type."""
    if dtype not in DTYPES:
        raise ValueError(f"the kernels take float32 or bfloat16, not {dtype}")
    return str(dtype).removeprefix("torch.")


def tick(name: str) -> None:
    """One call of the kernel wrapper ``name`` (``entry_calls``)."""
    with count_lock:
        entry_calls[name] = entry_calls.get(name, 0) + 1


def mangled_args(values) -> str:
    """Itanium-mangled template arguments, as ptxas names a kernel
    instance: integers, and type names of ``MANGLED_TYPES``: (32, 4) ->
    "ILi32ELi4EE", (32, "float32") -> "ILi32EfE". A class type named
    again is a substitution: S1_ for the first one of a kernel template
    inside one namespace, where S_ and S0_ are the namespace and the
    template (every kernel of csrc/): ("bfloat16", "bfloat16") ->
    "I13__nv_bfloat16S1_E"."""
    out, subs = [], {}
    for v in values:
        if not isinstance(v, str):
            out.append(f"Li{int(v)}E")
        elif len(MANGLED_TYPES[v]) == 1:        # a builtin type: no subs
            out.append(MANGLED_TYPES[v])
        elif v in subs:
            out.append(subs[v])
        else:
            subs[v] = f"S{len(subs) + 1}_"
            out.append(MANGLED_TYPES[v])
    return "I" + "".join(out) + "E"


def ptxas_entries(log: str) -> list:
    """One dict per kernel instance of an nvcc ``-Xptxas -v`` log: its
    mangled ``name``, ``registers``, static shared memory ``smem``
    (bytes) and ``spill_stores``/``spill_loads`` (bytes)."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = {"name": m.group(1), "registers": 0, "smem": 0,
                   "spill_stores": 0, "spill_loads": 0}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", ln)
                cur["smem"] = int(m.group(1)) if m else 0
    return out


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

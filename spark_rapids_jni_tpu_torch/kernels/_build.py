"""Build and load the port's native libraries: the CUDA kernels and the
host C++ the port reuses from ``native/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. A host
source (``HOST_SOURCES``: ``native/jcudf_rows.cpp``, which includes
only ``<cstdint>`` and ``<cstring>``) is compiled alone by the host C++
compiler; ``native/``'s own Makefile is not used, since its library
also links zlib and zstd. Libraries land in
``build/spark_rapids_jni_tpu_torch/`` beside the package, named by a
hash of the source and flags, so an edited source is rebuilt and an
unchanged one is not. Builds take a file lock, so concurrent processes
build once; the sources asked for in one call compile in parallel, one
compiler each.

Nothing here runs at import: the first call builds.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
_ROOT = os.path.dirname(os.path.dirname(_HERE))
BUILD_DIR = os.path.join(_ROOT, "build", "spark_rapids_jni_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)
HOST_SOURCES = {"jcudf_rows": os.path.join(_ROOT, "native", "jcudf_rows.cpp")}
HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}  # guarded by _LOCK


def source_path(name: str) -> str:
    return HOST_SOURCES.get(name) or os.path.join(SRC_DIR, f"{name}.cu")


def kernel_sources():
    """Names of the CUDA kernel sources under ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(SRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _cxx() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if found:
        return found
    raise RuntimeError("no host C++ compiler (g++ or c++) found")


def _flags(name: str):
    return HOST_FLAGS if name in HOST_SOURCES else NVCC_FLAGS


def library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(name)).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def build(*names: str) -> Dict[str, str]:
    """Compile the named sources that are not built yet, all at once.
    Returns each name's compiler output ("" when it was already
    built); raises with the output when a compiler fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    logs = {name: "" for name in names}
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = {}
        for name in names:
            path = library_path(name)
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            compiler = _cxx() if name in HOST_SOURCES else _nvcc()
            cmd = [compiler, *_flags(name), "-o", tmp, source_path(name)]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                tmp,
                path,
            )
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            logs[name] = out
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(proc.args[0])} failed for {name}:\n{out}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(library_path(name))
            _LIBS[name] = lib
        return lib

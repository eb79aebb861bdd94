"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/spark_rapids_jni_tpu_torch/`` beside the
package, named by a hash of its source and flags, so an edited source
is rebuilt and an unchanged one is not. Builds take a file lock, so
concurrent processes build once; the sources asked for in one call
compile in parallel, one ``nvcc`` each.

Nothing here runs at import: the first launch builds.
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
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_HERE)), "build", "spark_rapids_jni_tpu_torch"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}  # guarded by _LOCK


def source_path(name: str) -> str:
    return os.path.join(SRC_DIR, f"{name}.cu")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def build(*names: str) -> Dict[str, str]:
    """Compile the named sources that are not built yet, all at once.
    Returns each name's compiler output ("" when it was already
    built); raises with the output when ``nvcc`` fails."""
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
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
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
                failed.append(f"nvcc failed for {name}:\n{out}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(library_path(name))
            _LIBS[name] = lib
        return lib

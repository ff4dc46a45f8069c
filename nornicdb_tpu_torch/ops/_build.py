"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The
libraries are built at first use into ``nornicdb_tpu_torch/_build/``
(git-ignored), named by a hash of the source and the flags, so an edited
source builds anew and an unchanged one is reused. ``build()`` starts one
``nvcc`` per source, all at once. The compiler's register and shared
memory report (``-Xptxas -v``) is kept beside each library as a
``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

SOURCES = {
    "cosine_topk": "cosine_topk.cu",
    "flash_attention": "flash_attention.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> str:
    src = os.path.join(SRC_DIR, SOURCES[name])
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile every named kernel library that is not built yet, all in
    parallel. Returns the seconds it took; raises with the compiler's
    output when a build fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(out[:-3] + ".log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, SOURCES[name])]
        procs.append((name, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exited {rc}\n{build_log(name)}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name``."""
    try:
        with open(library_path(name)[:-3] + ".log") as f:
            return f.read()
    except OSError:
        return ""


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = load(library_path(name))
        return lib


def load(path: str) -> ctypes.CDLL:
    """Load a built kernel library with its error-string entry point bound."""
    lib = ctypes.CDLL(path)
    lib.nornic_error_string.argtypes = [ctypes.c_int]
    lib.nornic_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.nornic_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")

"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The
libraries are built at first use into ``nornicdb_tpu_torch/_build/``
(git-ignored), named by a hash of the source and the flags, so an edited
source builds anew and an unchanged one is reused. ``build()`` starts one
``nvcc`` per source, all at once. The compiler's register and shared
memory report (``-Xptxas -v``) is kept beside each library as a
``.log``.

Host code in ``csrc/*.cpp`` (``HOST_SOURCES``: the HNSW build and query
kernels, and the native KV store) compiles the same way with the host compiler, ``c++``, into a
library keyed also by the CPU it was built on, since ``-march=native``
code must not run on another instruction set (``host_library``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

SOURCES = {
    "cosine_topk": "cosine_topk.cu",
    "flash_attention": "flash_attention.cu",
}

HOST_SOURCES = {
    "hnsw_host": "hnsw_host.cpp",
    "kv_host": "kv_host.cpp",
}

# the JAX package's flags for the same source, so both build one graph
HOST_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# host libraries that failed to build, with the error: a process runs the
# compiler once per library, not once per caller
_host_failed: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _hashed_path(name: str, src_file: str, *keys: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(SRC_DIR, src_file), "rb") as f:
        h.update(f.read())
    for key in keys:
        h.update(key.encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def library_path(name: str) -> str:
    return _hashed_path(name, SOURCES[name], " ".join(NVCC_FLAGS))


def _cpu_flags() -> str:
    """The instruction-set flags of this CPU, for the host library key."""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def host_library_path(name: str) -> str:
    return _hashed_path(name, HOST_SOURCES[name], " ".join(HOST_FLAGS),
                        platform.machine(), _cpu_flags())


def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library ``name``, compiled with ``c++`` first if
    this source was not built on this CPU yet. Raises with the
    compiler's output when it cannot be built; a failed build is
    remembered, and later calls raise the same error without running the
    compiler again."""
    key = "host:" + name
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            if key in _host_failed:
                raise RuntimeError(_host_failed[key])
            try:
                lib = _libs[key] = ctypes.CDLL(_build_host(name))
            except (OSError, RuntimeError) as e:
                _host_failed[key] = str(e)
                raise
        return lib


def _build_host(name: str) -> str:
    """Path of host library ``name``, compiled first if it is not built."""
    out = host_library_path(name)
    if os.path.exists(out):
        return out
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"no host C++ compiler: {name} cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [cxx, *HOST_FLAGS, "-o", tmp, os.path.join(SRC_DIR, HOST_SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: {cxx} exited {proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    return out


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


def ptxas_lines(log: str) -> list:
    """The lines of a compiler output that give registers, or spills other
    than none."""
    return [line.strip() for line in log.splitlines()
            if "registers" in line or ("spill" in line and ", 0 bytes spill stores" not in line)]


def build_variants(name: str, patches: Iterable[str] = (),
                   sources: Iterable[Tuple[str, str]] = ()) -> Dict[str, Tuple[str, ctypes.CDLL, str]]:
    """Copies of kernel ``name``'s source, to time against it in one
    process. ``default`` is the library of the source as it stands.
    Variant i, ``v<i>``, is a copy with the text OLD of patch
    ``'OLD=>NEW'``, which must occur exactly once, replaced by NEW; each
    ``(label, path)`` of ``sources`` is a whole other source with the same
    C entry points, such as the parent commit's. The copies are built at
    once, anew, into ``BUILD_DIR/variants/``. Returns {label: (what it is,
    library, compiler output)}."""
    out = {"default": (SOURCES[name], library(name), build_log(name))}
    with open(os.path.join(SRC_DIR, SOURCES[name])) as f:
        src = f.read()
    todo = []
    for n, patch in enumerate(patches):
        old, sep, new = patch.partition("=>")
        if not sep or src.count(old) != 1:
            raise ValueError(f"variant {patch!r}: OLD must occur exactly once in the source")
        todo.append((f"v{n}", patch, src.replace(old, new)))
    for label, path in sources:
        if label in out or label.startswith("v"):
            raise ValueError(f"source {label}={path}: the label must be new and not v...")
        with open(path) as f:
            todo.append((label, path, f.read()))
    var_dir = os.path.join(BUILD_DIR, "variants")
    os.makedirs(var_dir, exist_ok=True)
    procs = []
    for label, what, text in todo:
        path = os.path.join(var_dir, f"{name}-{label}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", path[:-3] + ".so", path]
        procs.append((label, what, path[:-3] + ".so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for label, what, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{label} ({what}) failed to build:\n{log}")
        out[label] = (what, load(lib), log)
    return out


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

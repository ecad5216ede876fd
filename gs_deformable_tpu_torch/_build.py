"""Kernel build: ``nvcc`` for ``sm_90a`` into shared libraries, loaded by ctypes.

Each ``csrc/<name>.cu`` exports plain C functions that launch on the given
stream and return ``cudaGetLastError()``.  ``build_all`` starts one ``nvcc``
per source, all at once, and waits for them; ``load(name)`` builds (if
needed) and opens one library.  A ``csrc/<name>.cpp`` (the host-side COLMAP
reader) is built the same way by the host compiler (``c++`` or ``g++``,
``-std=c++17 -O3 -shared -fPIC``) and opened with ``load``.
Libraries land in ``kernels_build/`` inside the package (listed in
``.gitignore``) under a name keyed by a hash of the source, the shared
``csrc/*.cuh`` headers (CUDA sources) and the flags, so an edited source is
rebuilt and a stale library is never loaded; each build writes a file of its
own and renames it into place, so processes that build at once never load a
partial library.  Nothing is built at import time: the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "kernels_build")
SOURCES = ("ordered_fill", "composite_fwd", "composite_bwd", "trunk")

# -fmad=false: the composite's float ops round one by one, as the plain
# PyTorch version's separate elementwise kernels do, so the two agree on
# every knife-edge termination test (n_contrib is compared exactly), and the
# backward's recomputed transmittance equals the forward's.
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}
BUILD_LOG: dict = {}  # name -> the compiler's output (ptxas register/spill report)


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def host_compiler() -> str:
    for cc in ("c++", "g++"):
        path = shutil.which(cc)
        if path is not None:
            return path
    raise RuntimeError("no host C++ compiler (c++ or g++) found")


def _is_host(name: str) -> bool:
    return os.path.exists(os.path.join(CSRC, f"{name}.cpp"))


def _target(name: str) -> str:
    if _is_host(name):
        flags, files = HOST_FLAGS, (f"{name}.cpp",)
    else:
        flags = FLAGS
        files = (f"{name}.cu", *sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")))
    h = hashlib.sha256(" ".join(flags).encode())
    for fname in files:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    if _is_host(name):
        cmd = [host_compiler(), *HOST_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cpp")]
    else:
        cmd = [nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"{proc.args[0]} failed for {proc.args[-1]}:\n{log}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> None:
    """Build every kernel library in parallel (one nvcc per source)."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            _finish(n, job)


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Open ``lib<name>``, building it first if needed, with ``argtypes`` set.

    ``signatures`` maps each exported function to its ctypes argument types;
    every function returns a ``cudaError_t`` as int.  Pass ``{}`` to set the
    types oneself (the host library's functions return pointers).
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(_target(name))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

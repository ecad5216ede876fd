"""Kernel build: ``nvcc`` for ``sm_90a`` into shared libraries, loaded by ctypes.

Each ``csrc/<name>.cu`` exports plain C functions that launch on the given
stream and return ``cudaGetLastError()``.  ``build_all`` starts one ``nvcc``
per source, all at once, and waits for them; ``load(name)`` builds (if
needed) and opens one library.  Libraries land in ``kernels_build/`` inside
the package (listed in ``.gitignore``) under a name keyed by a hash of the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited source
is rebuilt and a stale library is never loaded.  Nothing is built at import
time: the CPU has no ``nvcc``.
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
SOURCES = ("ordered_fill", "composite_fwd", "composite_bwd")

# -fmad=false: the composite's float ops round one by one, as the plain
# PyTorch version's separate elementwise kernels do, so the two agree on
# every knife-edge termination test (n_contrib is compared exactly), and the
# backward's recomputed transmittance equals the forward's.
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}
BUILD_LOG: dict = {}  # name -> nvcc's output (ptxas register/spill report)


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
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
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
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
    every function returns a ``cudaError_t`` as int.
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

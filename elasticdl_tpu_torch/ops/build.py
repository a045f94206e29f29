"""Build and load the port's CUDA kernels.

Each source under `ops/csrc/` exposes a plain C interface. At first use
it is compiled with `nvcc` for Hopper (`sm_90a`) into a shared library
under `ops/_build/` and loaded with ctypes; the library's name carries a
hash of the source and flags, so an edited source builds anew. The
compiler's register and shared-memory report (`-Xptxas -v`) is kept
beside the library as `<name>.log`. Worker processes that start together
build once: the check-and-build holds an exclusive `flock` on
`_build/.lock`, and the compiler writes `<lib>.<pid>.tmp`, renamed into
place when it is done.
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
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}  # libraries are process-global anyway


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, PATH, or /usr/local/cuda; raises if absent."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from source at first use"
    )


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def compile_once(out: str, argv_fn, log_path: str) -> str:
    """Build `out` once across threads and processes: under an exclusive
    `flock` on `.lock` beside it, run the compiler argv `argv_fn(tmp)`
    (which writes `tmp`) unless `out` exists, keep its output at
    `log_path`, and rename `tmp` into place. Raises RuntimeError with the
    compiler's output if it fails. Also builds the host C++ libraries
    (`master/embedding_store.py`)."""
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(os.path.join(os.path.dirname(out), ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(out):
            return out  # another process built it while this one waited
        tmp = f"{out}.{os.getpid()}.tmp"
        argv = argv_fn(tmp)
        proc = subprocess.run(argv, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(argv)} failed (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        with open(log_path, "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return out


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless its library exists; returns the
    library path. Raises RuntimeError with the compiler's output if
    nvcc fails."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    return compile_once(
        library_path(name),
        lambda tmp: [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
        os.path.join(BUILD_DIR, f"{name}.log"),
    )


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(build(name))
        return lib

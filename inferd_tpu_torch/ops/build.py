"""Build and load the port's CUDA kernel libraries from the sources in `csrc/`.

Kernel `name` is `csrc/<name>.cu`. It compiles with nvcc, at first use,
into a shared library with a plain C interface that the kernel's wrapper
loads with ctypes. Libraries land in `inferd_tpu_torch/_build/` (listed in
.gitignore) under a name keyed on a hash of the source and the compiler
flags, so a fresh checkout builds them itself and a changed source never
loads a stale binary. A build holds an exclusive lock on
`_build/<name>.lock`, writes to a temporary name and renames into place, so
processes that start together (stage nodes on one host, or nodes started
while another process builds) compile each kernel once: the others wait
for the lock and load the library it left.

This is the only module that calls nvcc. It raises when nvcc is missing or
a build fails; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills per kernel, kept in the .log
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc or PATH."""
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else "",
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH): "
        "the port's CUDA kernels build from source and need the CUDA toolkit"
    )


def library_path(name: str) -> str:
    """Where kernel `name`'s library lives for the current source + flags."""
    h = hashlib.sha256()
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        h.update(f.read())
    h.update("\0".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> dict:
    """Compile kernel `name` unless its library exists. Returns {"path",
    "seconds", "built", "log"}; `log` holds nvcc's -Xptxas -v report."""
    path = library_path(name)
    log_path = path[:-3] + ".log"

    def built() -> dict:
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return {"path": path, "seconds": 0.0, "built": False, "log": log}

    if os.path.exists(path):
        return built()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes, or the process dies
        if os.path.exists(path):  # another process built it while this one waited
            return built()
        return _compile(name, path, log_path)


def _compile(name: str, path: str, log_path: str) -> dict:
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    log = proc.stdout.decode("utf-8", "replace")
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {name} (rc {proc.returncode}):\n{log}")
    with open(tmp + ".log", "w") as f:
        f.write(log)
    os.replace(tmp + ".log", log_path)
    os.replace(tmp, path)  # last: a library that exists has its log beside it
    return {"path": path, "seconds": time.perf_counter() - t0, "built": True, "log": log}


# every csrc/<name>.cu the port builds
KERNELS = ("flash_gqa", "paged_decode", "qmatmul", "lora_delta")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)["path"])
            _loaded[name] = lib
        return lib

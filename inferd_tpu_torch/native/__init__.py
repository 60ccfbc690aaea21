"""Build and load the native wire codec, `csrc/wirecodec.cpp` (port of
inferd_tpu/native/__init__.py).

The codec is a CPython extension with `pack(obj) -> bytes`, `unpack(bytes)
-> obj` and `set_hooks(tensor_parts, tensor_build)`; it writes and reads the
bytes of runtime/wire.py's pure-Python codec. It compiles at first use with
the host C++ compiler ($CXX, else g++) against this interpreter's headers,
into `inferd_tpu_torch/_build/` (listed in .gitignore), under a name keyed
on a hash of the source, the flags and the interpreter's extension suffix:
a fresh checkout builds it itself and a changed source never loads a stale
binary. As in ops/build.py, a build writes to a temporary name and renames
into place, and an exclusive lock on the build directory makes processes
that start together (a host's stage nodes) build it once.

A failed build raises with the compiler's log: nothing falls back to the
Python codec behind the caller's back. runtime/wire.py picks the codec:
this one unless INFERD_NATIVE=0.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
import time
from types import ModuleType
from typing import Any, Callable, Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "wirecodec.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_module: Optional[ModuleType] = None


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> str:
    """Where the extension lives for the current source, flags and interpreter."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update("\0".join((compiler(), *CXX_FLAGS, sysconfig.get_paths()["include"])).encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(BUILD_DIR, f"wirecodec-{h.hexdigest()[:16]}{suffix}")


def build() -> Dict[str, Any]:
    """Compile the extension unless it exists. Returns {"path", "seconds",
    "built", "log"}; raises RuntimeError with the compiler's output when
    the build fails or no compiler is found."""
    path = library_path()
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "built": False, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "wirecodec.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes, or the process dies
        if os.path.exists(path):  # another process built it while this one waited
            return {"path": path, "seconds": 0.0, "built": False, "log": ""}
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [compiler(), *CXX_FLAGS, f"-I{sysconfig.get_paths()['include']}", SOURCE,
               "-o", tmp]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"building the native wire codec ({' '.join(cmd)}) failed: "
                               f"{e}") from e
        log = proc.stdout.decode("utf-8", "replace")
        if proc.returncode != 0:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise RuntimeError(f"the C++ compiler failed building the native wire codec "
                               f"(rc {proc.returncode}): {' '.join(cmd)}\n{log}")
        os.replace(tmp, path)
    return {"path": path, "seconds": time.perf_counter() - t0, "built": True, "log": log}


def load(tensor_parts: Callable, tensor_build: Callable) -> ModuleType:
    """The loaded codec, built first if needed, with the wire's tensor hooks set."""
    global _module
    with _lock:
        if _module is None:
            path = build()["path"]
            spec = importlib.util.spec_from_file_location("wirecodec", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod.set_hooks(tensor_parts, tensor_build)
            _module = mod
        return _module

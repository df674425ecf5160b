"""Build and load the port's native C++ runtime shared library.

Compiled on demand with g++ from native/src (no external dependencies) into
the package's build/ directory, under a file name that carries a tag of
this machine's CPU flags: the library is compiled with -march=native, so a
copy built on another machine is never picked up.  A failed build raises
with the compiler's output; nothing in the port carries on without the
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "src")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
_SOURCES = ["codec.cpp", "interleave.cpp", "spill.cpp", "writer.cpp",
            "radecode.cpp"]
_lock = threading.Lock()
_lib = None


def _cpu_tag() -> str:
    """Eight hex digits naming this machine's CPU feature flags."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:
        pass
    return hashlib.sha1((flags or os.uname().machine).encode()).hexdigest()[:8]


def library_path() -> str:
    return os.path.join(_BUILD_DIR, f"libbwtmerge_torch_native-{_cpu_tag()}.so")


def _needs_rebuild(lib_path: str) -> bool:
    if not os.path.exists(lib_path):
        return True
    lib_mtime = os.path.getmtime(lib_path)
    return any(os.path.getmtime(os.path.join(_SRC_DIR, src)) > lib_mtime
               for src in _SOURCES)


def build_library() -> str:
    """Compile native/src into library_path() and return it.  The compiler
    writes a temporary file that is renamed over the target, so processes
    building at once never load a half-written library."""
    lib_path = library_path()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-fvisibility=hidden", "-o", tmp,
           *(os.path.join(_SRC_DIR, s) for s in _SOURCES), "-pthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native build failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib_path = library_path()
            if _needs_rebuild(lib_path):
                build_library()
            _lib = ctypes.CDLL(lib_path)
        return _lib

"""The port's hand-written CUDA kernels: build, load, launch and count.

Each source in `csrc/` is compiled by `nvcc` for sm_90a into its own
shared library with a plain C interface, at first use, into `build/`
(listed in .gitignore); a library is rebuilt when its source or any header
in `csrc/` is newer.  All sources compile in parallel, one `nvcc` each.
The libraries are loaded with ctypes; pointers and the stream travel as
`c_void_p`.  Every C entry point returns `cudaGetLastError()` after its
launch and a nonzero code raises here.

Each kernel keeps an integer launch count (`Kernel.launches`), raised by
one at every launch and nowhere else, so a run can show that its main path
went through the kernels.  A kernel with several forms (K1) also counts
each form's launches apart (`Kernel.forms`, `launches_by_form`); every
form counts under the kernel's one name.  The mesh paths launch from one
worker thread per shard, so the counts are raised under a lock.

Nothing here touches CUDA or runs `nvcc` at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent
    (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain PyTorch versions")
    return dev


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(source: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{os.path.splitext(source)[0]}.so")


def _stale(source: str) -> bool:
    """True when the source's library is missing or older than the source
    or than any header of `csrc/` (a header may be included by every
    source)."""
    lib = _lib_path(source)
    if not os.path.exists(lib):
        return True
    deps = [source] + [f for f in os.listdir(CSRC_DIR)
                       if f.endswith((".cuh", ".h"))]
    return os.path.getmtime(lib) < max(
        os.path.getmtime(os.path.join(CSRC_DIR, f)) for f in deps)


_build_lock = threading.Lock()


def build(force: bool = False) -> float:
    """Compile every stale `csrc/*.cu` (all of them with `force`), one
    `nvcc` process per source, all started together.  Returns the wall
    seconds spent.  Raises with the compiler's output on failure."""
    with _build_lock:
        start = time.monotonic()
        sources = sorted(s for s in os.listdir(CSRC_DIR) if s.endswith(".cu"))
        todo = [s for s in sources if force or _stale(s)]
        if not todo:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src in todo:
            tmp = _lib_path(src) + f".{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for src, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src}:\n{out}")
            else:
                os.replace(tmp, _lib_path(src))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        return time.monotonic() - start


class Kernel:
    """One CUDA entry point of one `csrc/` library, with its launch count."""

    def __init__(self, name: str, source: str, argtypes, error_fn: str,
                 forms=()):
        self.name = name
        self.source = source
        self._argtypes = argtypes
        self._error_fn = error_fn
        self._fn = None
        self._errstr = None
        self._lock = threading.Lock()
        self.launches = 0
        self.forms = dict.fromkeys(forms, 0)

    def _load(self):
        with self._lock:
            if self._fn is None:
                build()
                lib = ctypes.CDLL(_lib_path(self.source))
                fn = getattr(lib, f"{self.name}_launch")
                fn.argtypes = self._argtypes
                fn.restype = ctypes.c_int
                err = getattr(lib, self._error_fn)
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._fn, self._errstr = fn, err
        return self._fn

    def launch(self, *args, form: str = None) -> None:
        """Launch on PyTorch's current stream of the current device (the
        caller sets the device); raises on a nonzero launch status.  `form`
        names the form launched, for a kernel that has forms."""
        if not (form in self.forms if self.forms else form is None):
            raise ValueError(f"{self.name}: unknown form {form!r}")
        fn = self._load()
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(*args, stream)
        if code != 0:
            raise RuntimeError(f"{self.name} launch failed: "
                               f"{self._errstr(code).decode()} ({code})")
        with self._lock:
            self.launches += 1
            if form is not None:
                self.forms[form] += 1

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.forms = dict.fromkeys(self.forms, 0)


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int

STREAMED_PROBE = Kernel("streamed_probe", "streamed_probe.cu",
                        [_P, _P, _I64, _I32, _I32, _P, _I32, _P, _P, _P],
                        "streamed_probe_error_string",
                        forms=("full", "select", "lf"))
WALK_EMIT = Kernel("walk_emit", "walk.cu",
                   [_P, _P, _P, _I32, _I64, _I32, _P, _P, _P],
                   "walk_error_string")
WALK_PLANES_BUILD = Kernel("walk_planes_build", "walk.cu",
                           [_P, _I64, _P, _I64, _P], "walk_error_string")
DECODE = Kernel("decode", "decode.cu",
                [_P, _P, _I64, _I64, _I32, _I64, _P, _P, _P],
                "decode_error_string")
DECODE_ROWS_BUILD = Kernel("decode_rows_build", "decode.cu",
                           [_P, _I64, _P, _P], "decode_error_string")
REC_BUILD = Kernel("rec_build", "rec_build.cu",
                   [_P, _I64, _P, _P, _I64, _P, _P],
                   "rec_build_error_string")
KERNELS = (STREAMED_PROBE, WALK_EMIT, WALK_PLANES_BUILD, DECODE,
           DECODE_ROWS_BUILD, REC_BUILD)


def reset_launches() -> None:
    for k in KERNELS:
        k.reset()


def launches() -> dict:
    return {k.name: k.launches for k in KERNELS}


def launches_by_form() -> dict:
    """Each form's launches, as {"<kernel>.<form>": n}."""
    return {f"{k.name}.{f}": n for k in KERNELS for f, n in k.forms.items()}

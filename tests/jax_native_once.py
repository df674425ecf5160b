"""The JAX package's native library, built whole before any test loads it.

bwtmerge_tpu/native/build.py compiles libbwtmerge_native.so with g++
straight to its final path and loads whatever file it finds there.  Under
pytest-xdist, in a checkout that has no library yet, a worker whose test
loads the library while another worker's linker is still writing it fails
in ctypes with "file too short" (ROADMAP.md, C.6).  The port's test files
that compare with the JAX package call `build_jax_native_once()` while they
are imported.  Every xdist worker imports every test file while it
collects, and no worker runs a test before all of them have collected, so
the library is whole before the first test of any worker loads it.  The
build runs under an exclusive file lock: one process compiles, the others
wait and then find the library built.
"""

import fcntl
import os

_LOCK_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bwtmerge_tpu_torch", "build")


def build_jax_native_once() -> None:
    """Build (if stale) and load the JAX package's native library under a
    lock shared by every test process.  A failed build is left to the tests
    that need the library, as before."""
    from bwtmerge_tpu.native import build

    os.makedirs(_LOCK_DIR, exist_ok=True)
    with open(os.path.join(_LOCK_DIR, "jax_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            build.load_library()
        except (OSError, RuntimeError):
            pass
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)

"""tests/jax_native_once.py: a test process that reaches the JAX package's
native library while another still links it waits and loads a whole
library (ROADMAP.md, C.6)."""

import multiprocessing
import os
import shutil
import time

from jax_native_once import build_jax_native_once

import bwtmerge_tpu.native.build as j_build


def _build_in(src: str, lib: str, first: bool) -> bool:
    """Process `first` builds at once; the others start as soon as the
    linker has created the file, which is when the JAX package's own
    load_library would take a half-written file for a built one."""
    j_build._SRC_DIR, j_build._LIB_PATH = src, lib
    if not first:
        while not os.path.exists(lib):
            time.sleep(0.001)
    build_jax_native_once()
    return j_build._lib is not None


def test_a_process_arriving_during_the_link_loads_a_whole_library(tmp_path):
    src = str(tmp_path / "src")
    shutil.copytree(j_build._SRC_DIR, src)
    lib = str(tmp_path / "libbwtmerge_native.so")
    with multiprocessing.get_context("spawn").Pool(4) as pool:
        loaded = pool.starmap(_build_in, [(src, lib, k == 0)
                                          for k in range(4)])
    assert loaded == [True] * 4

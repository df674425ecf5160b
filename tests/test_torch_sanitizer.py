"""The port's native C++ runtime under AddressSanitizer and
UndefinedBehaviorSanitizer, as tests/test_sanitizer.py holds the JAX
package's.

Builds bwtmerge_tpu_torch/native/src/selftest.cpp together with the port's
five runtime sources and runs the binary as a subprocess: randomized codec
round trips, chunked resume, parallel-vs-serial interleave equivalence
(threads included) and the corrupt-input error sentinels.  Any sanitizer
report fails the run.  The self-test is the port's own copy of the JAX
package's, with the tests of the port's own routines added (the rope
family's reader, the run sums and the SGA writer's totals): every line of
the original stays in it, in order.
"""

import os
import subprocess

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "bwtmerge_tpu_torch", "native", "src")
JAX_SRC = os.path.join(ROOT, "bwtmerge_tpu", "native", "src")
SOURCES = ["codec.cpp", "interleave.cpp", "spill.cpp", "writer.cpp",
           "radecode.cpp", "selftest.cpp"]


@pytest.fixture(scope="module")
def selftest_bin(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("san_torch") / "selftest")
    cmd = ["g++", "-O1", "-g", "-std=c++17",
           "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
           "-o", out] + [os.path.join(SRC, s) for s in SOURCES] + ["-pthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, f"sanitizer build failed:\n{proc.stderr}"
    return out


def test_port_native_selftest_under_asan_ubsan(selftest_bin):
    proc = subprocess.run([selftest_bin], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, (
        f"sanitized selftest failed (rc={proc.returncode}):\n"
        f"{proc.stdout}\n{proc.stderr[-4000:]}")
    assert "native selftest: OK" in proc.stdout


def test_port_selftest_is_a_copy_of_the_original():
    # beyond their header comments, the port's harness holds every line of
    # the original's, in order, and adds only the port's own tests
    def body(path):
        with open(path) as f:
            return f.read().split("\n", 2)[2].splitlines()

    port = iter(body(os.path.join(SRC, "selftest.cpp")))
    assert all(line in port for line in body(os.path.join(JAX_SRC,
                                                          "selftest.cpp")))


def test_library_sources_are_the_five_the_selftest_links():
    from bwtmerge_tpu_torch.native import build

    assert sorted(build._SOURCES) == sorted(SOURCES[:-1])
    assert "selftest.cpp" not in build._SOURCES

"""The port's RopeBWT and SGA readers, run counts and SGA writer against
the JAX package's, exactly, on the CPU.

The port decodes the rope family's codes in one native pass (native
RopeRuns), sums run lengths natively (RunArrays.counts) and has the SGA
writer's kernel add up each chunk's bases and sequences; the JAX package
does each in numpy.  The same files and runs go through both.
"""

import struct

import numpy as np
import pytest

import bwtmerge_tpu.formats as j_formats
import bwtmerge_tpu.formats.streaming as j_streaming
import bwtmerge_tpu.formats.streaming_read as j_sread
import bwtmerge_tpu.models.runs as j_runs
import bwtmerge_tpu.utils.alphabet as j_alpha
import bwtmerge_tpu_torch.formats as p_formats
import bwtmerge_tpu_torch.formats.streaming as p_streaming
import bwtmerge_tpu_torch.formats.streaming_read as p_sread
import bwtmerge_tpu_torch.models.runs as p_runs
import bwtmerge_tpu_torch.native as p_native
import bwtmerge_tpu_torch.utils.alphabet as p_alpha
from jax_native_once import build_jax_native_once

build_jax_native_once()

ROPE = ("sga", "ropebwt")
CHUNK_BYTES = (1, 7, 64, 4096, 1 << 20)


def _code(fmt, sym, length):
    return (sym << 5 | length) if fmt == "sga" else (length << 3 | sym)


def _random_codes(seed, n, zero_share=0.2):
    r = np.random.default_rng(seed)
    syms = r.integers(0, 6, n)
    lens = np.where(r.random(n) < zero_share, 0, r.integers(1, 32, n))
    return list(zip(syms.tolist(), lens.tolist()))


# (sym, len) codes of each case; runs of one symbol over 31 positions are
# codes of 31 in a row, which the chunk sizes cut at every offset
CASES = {
    "empty": [],
    "one_code": [(2, 5)],
    "long_runs": [(1, 31), (1, 31), (1, 7), (2, 31), (2, 2), (3, 31),
                  (3, 31), (3, 31), (0, 1), (4, 31), (4, 31)] * 9,
    "zero_inside_and_at_end": [(1, 3), (2, 0), (1, 2), (0, 1), (3, 0)],
    "zero_at_seams": [(s % 6, 0 if k % 7 == 6 else 1 + k % 31)
                      for k, s in enumerate(range(300))],
    "all_six": [(s, 1 + (3 * s + k) % 31) for k in range(40)
                for s in range(6)],
    "random": _random_codes(5, 3000),
}


def _write_rope(path, fmt, codes, declared=None):
    payload = bytes(_code(fmt, s, l) for s, l in codes)
    with open(path, "wb") as f:
        if fmt == "sga":
            f.write(j_formats.SGAHeader(
                sequences=0, bases=0,
                bytes_=len(payload) if declared is None else declared
            ).to_bytes())
        else:
            f.write(j_formats.RopeHeader().to_bytes())
        f.write(payload)
    return str(path)


def _assert_chunks_equal(got, want):
    assert len(got) == len(want)
    for (s, l), (ws, wl) in zip(got, want):
        assert s.dtype == ws.dtype == np.uint8
        assert l.dtype == wl.dtype == np.int64
        assert np.array_equal(s, ws) and np.array_equal(l, wl)


@pytest.mark.parametrize("chunk_bytes", CHUNK_BYTES)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fmt", ROPE)
def test_rope_reads_equal_the_jax_readers(tmp_path, fmt, case, chunk_bytes):
    path = _write_rope(tmp_path / f"in.{fmt}", fmt, CASES[case])
    _assert_chunks_equal(
        list(p_sread.read_bwt_chunks(path, fmt, chunk_bytes)),
        list(j_sread.read_bwt_chunks(path, fmt, chunk_bytes)))
    for got, want in ((p_sread.read_bwt_streaming(path, fmt, chunk_bytes),
                       j_sread.read_bwt_streaming(path, fmt, chunk_bytes)),
                      (p_formats.read_bwt(path, fmt),
                       j_formats.read_bwt(path, fmt))):
        (runs, counts, alpha), (w_runs, w_counts, w_alpha) = got, want
        assert runs.syms.dtype == np.uint8 and runs.lens.dtype == np.int64
        assert np.array_equal(runs.syms, w_runs.syms)
        assert np.array_equal(runs.lens, w_runs.lens)
        assert counts.dtype == np.int64
        assert np.array_equal(counts, w_counts)
        assert np.array_equal(alpha.C, w_alpha.C)
        assert np.array_equal(alpha.char2comp, w_alpha.char2comp)


@pytest.mark.parametrize("fmt", ROPE)
def test_zero_length_codes_keep_the_streaming_readers_runs(tmp_path, fmt):
    # the inner zero-length run stays, the trailing one goes (the batch
    # SGAFormat.read would give [1, 0] and [5, 1])
    path = _write_rope(tmp_path / f"in.{fmt}", fmt,
                       CASES["zero_inside_and_at_end"])
    runs, counts, _ = p_formats.read_bwt(path, fmt)
    assert runs.syms.tolist() == [1, 2, 1, 0]
    assert runs.lens.tolist() == [3, 0, 2, 1]
    assert counts.tolist() == [1, 5, 0, 0, 0, 0]


def _failure(fn):
    try:
        fn()
    except (ValueError, IndexError, struct.error) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("fault", ["truncated", "bad_header",
                                   "symbol_past_sigma"])
@pytest.mark.parametrize("fmt", ROPE)
def test_rope_read_faults_raise_as_in_jax(tmp_path, fmt, fault):
    codes = _random_codes(9, 500)
    if fault == "truncated":
        if fmt == "ropebwt":     # its payload is the file's rest: cut the
            path = tmp_path / "in.ropebwt"       # header itself
            path.write_bytes(j_formats.RopeHeader().to_bytes()[:2])
        else:
            path = _write_rope(tmp_path / "in.sga", fmt, codes,
                               declared=len(codes) + 10)
    else:
        path = _write_rope(tmp_path / f"in.{fmt}", fmt, codes)
        raw = bytearray(open(path, "rb").read())
        if fault == "bad_header":
            raw[0] ^= 0xFF
        else:
            raw[-100] = _code(fmt, 6, 3)
        open(path, "wb").write(bytes(raw))
    path = str(path)
    for reader in ("read", "chunks"):
        got, want = [_failure(lambda pkg=pkg: (
            pkg[0].read_bwt(path, fmt) if reader == "read"
            else list(pkg[1].read_bwt_chunks(path, fmt, 64))))
            for pkg in ((p_formats, p_sread), (j_formats, j_sread))]
        if fault == "symbol_past_sigma" and reader == "chunks":
            assert got is None and want is None   # the stream passes it on
            _assert_chunks_equal(
                list(p_sread.read_bwt_chunks(path, fmt, 64)),
                list(j_sread.read_bwt_chunks(path, fmt, 64)))
            continue
        assert got is not None and want is not None
        assert got[0] is want[0]
        if got[0] is not IndexError:     # numpy's words, not the port's
            assert got[1] == want[1]


def test_rope_chunks_before_a_truncation_equal_jaxs(tmp_path):
    codes = _random_codes(11, 400)
    path = _write_rope(tmp_path / "in.sga", "sga", codes,
                       declared=len(codes) + 1)
    streams = []
    for sread in (p_sread, j_sread):
        got = []
        with pytest.raises(ValueError, match="1 payload bytes missing"):
            for chunk in sread.read_bwt_chunks(path, "sga", 64):
                got.append(chunk)
        streams.append(got)
    assert len(streams[0]) == 7    # six whole chunks and the 16 codes left
    _assert_chunks_equal(*streams)


@pytest.mark.parametrize("case", ["none", "short", "wide", "past_sigma"])
def test_run_counts_equal_bincount(case):
    r = np.random.default_rng(3)
    n = {"none": 0, "short": 5}.get(case, 20000)
    syms = r.integers(0, 8 if case == "past_sigma" else 6, n).astype(np.uint8)
    lens = r.integers(0, 1 << 40 if case == "wide" else 50, n)
    runs = p_runs.RunArrays(syms, lens)
    got = runs.counts(6)
    want = np.bincount(syms, weights=lens, minlength=6).astype(np.int64)
    assert got.dtype == np.int64 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(got, j_runs.RunArrays(syms, lens).counts(6))
    exact = np.zeros(max(6, int(syms.max(initial=0)) + 1 if n else 6),
                     np.int64)
    for s, length in zip(syms.tolist(), lens.tolist()):
        exact[s] += length
    assert np.array_equal(got, exact)
    assert np.array_equal(runs.counts(300)[:got.size], got)
    assert runs.counts(300).size == 300


def _maximal_runs(seed, n):
    # neighbours differ by 1..5 mod 6; a tenth of the runs span several
    # 31-position codes and 64-byte blocks of the stored-run partition
    r = np.random.default_rng(seed)
    syms = (np.cumsum(r.integers(1, 6, n)) % 6).astype(np.uint8)
    lens = np.where(r.random(n) < 0.9, r.integers(1, 5, n),
                    r.integers(30, 3000, n))
    return syms, lens.astype(np.int64)


def _header(path):
    tag, sequences, bases, n_bytes, flags = struct.unpack(
        "<HQQQI", open(path, "rb").read(30))
    return sequences, bases, n_bytes


@pytest.mark.parametrize("chunk_runs", [None, 1, 7, 1000])
@pytest.mark.parametrize("lens_dtype", [np.int64, np.int32])
def test_sga_written_as_by_jax(tmp_path, chunk_runs, lens_dtype):
    syms, lens = _maximal_runs(4, 20000)
    files = {}
    for name, fmts, runs_mod, alpha_mod, streaming in (
            ("jax", j_formats, j_runs, j_alpha, j_streaming),
            ("port", p_formats, p_runs, p_alpha, p_streaming)):
        runs = runs_mod.RunArrays(syms, lens)
        alpha = alpha_mod.Alphabet.from_counts(runs.counts(6))
        path = str(tmp_path / f"{name}.sga")
        if chunk_runs is None:
            fmts.write_bwt(path, "sga", runs, alpha)
        else:
            streaming.write_bwt_stream(path, "sga", (
                (syms[s:s + chunk_runs], lens[s:s + chunk_runs]
                 .astype(lens_dtype))
                for s in range(0, syms.size, chunk_runs)), alpha)
        files[name] = open(path, "rb").read()
    assert files["port"] == files["jax"]
    sequences, bases, n_bytes = _header(str(tmp_path / "port.sga"))
    assert sequences == int(lens[syms == 0].sum())
    assert bases == int(lens.sum())
    assert n_bytes == len(files["port"]) - 30


def test_sga_written_as_by_jax_past_one_writer_chunk(tmp_path):
    # SGAFormat.write feeds the writer 4 Mi runs at a time: two chunks
    n = (1 << 22) + 12345
    syms = (np.arange(n) % 5).astype(np.uint8)
    lens = np.where(np.arange(n) % 97 == 0, 77, 1 + np.arange(n) % 3)
    files = {}
    for name, fmts, runs_mod, alpha_mod in (
            ("jax", j_formats, j_runs, j_alpha),
            ("port", p_formats, p_runs, p_alpha)):
        runs = runs_mod.RunArrays(syms, lens)
        path = str(tmp_path / f"{name}.sga")
        fmts.write_bwt(path, "sga", runs,
                       alpha_mod.Alphabet.from_counts(runs.counts(6)))
        files[name] = open(path, "rb").read()
    assert files["port"] == files["jax"]
    assert _header(str(tmp_path / "port.sga"))[:2] == (
        int(lens[syms == 0].sum()), int(lens.sum()))


def test_sga_totals_state_and_rope_layout_are_checked():
    syms = np.array([0, 1], np.uint8)
    lens = np.array([3, 4], np.int64)
    out = np.empty(64, np.uint8)
    with pytest.raises(ValueError):
        p_native.sga_stream_chunk_totals(syms, lens, np.zeros(1, np.int64),
                                         out)
    state = np.array([0, 10, 20], np.int64)
    n = p_native.sga_stream_chunk_totals(syms, lens, state, out)
    assert n == 2 and state.tolist() == [2, 17, 23]
    small = np.empty(1, np.uint8)
    assert p_native.sga_stream_chunk_totals(syms, lens, state, small) == -2
    assert state.tolist() == [2, 17, 23]
    with pytest.raises(ValueError):
        p_native.RopeRuns(5, 8, 0, 31).fill(np.zeros(4, np.uint8), 64)
    with pytest.raises(ValueError):
        p_native.RopeRuns(5, 7, 0, 31).fill(np.zeros(4, np.uint8), 0)


def _claiming_sga(path, claim):
    """An SGA file whose header claims `claim` codes over 66 payload bytes."""
    with open(path, "wb") as f:
        f.write(j_formats.SGAHeader(sequences=0, bases=0,
                                    bytes_=claim).to_bytes())
        f.write(bytes([_code("sga", 1, 3)] * 66))
    return str(path)


def _merge_cli(pkg):
    import importlib

    cli = importlib.import_module(f"{pkg}.cli.bwt_merge")
    extra = ["--device", "cpu"] if pkg.endswith("_torch") else []
    return lambda p, out: cli.main([p, p, out, "-i", "sga", "-o", "sga",
                                    "--quiet", *extra])


@pytest.mark.parametrize("surface", ["read_bwt", "read_bwt_streaming",
                                     "read_bwt_chunks", "bwt_merge"])
@pytest.mark.parametrize("claim_bits", [20, 36, 40])
def test_sga_claim_past_the_file_raises_as_in_jax(tmp_path, claim_bits,
                                                  surface):
    import tracemalloc

    claim = 1 << claim_bits
    path = _claiming_sga(tmp_path / "claims.sga", claim)
    out = str(tmp_path / "out.sga")
    calls = {
        "read_bwt": lambda pk: pk[0].read_bwt(path, "sga"),
        "read_bwt_streaming": lambda pk: pk[1].read_bwt_streaming(path,
                                                                  "sga"),
        "read_bwt_chunks": lambda pk: list(pk[1].read_bwt_chunks(path,
                                                                 "sga")),
        "bwt_merge": lambda pk: _merge_cli(pk[2])(path, out)}
    got = []
    for pk in ((p_formats, p_sread, "bwtmerge_tpu_torch"),
               (j_formats, j_sread, "bwtmerge_tpu")):
        tracemalloc.start()
        try:
            with pytest.raises(ValueError) as e:
                calls[surface](pk)
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        got.append((e.type, str(e.value), peak))
    (p_type, p_msg, p_peak), (j_type, j_msg, _) = got
    assert p_type is j_type is ValueError
    assert p_msg == j_msg == (f"file truncated: {claim - 66} payload bytes "
                              "missing")
    if surface in ("read_bwt", "read_bwt_streaming"):
        assert p_peak < claim // 2        # nothing of the claim reserved
    assert not (tmp_path / "out.sga").exists()

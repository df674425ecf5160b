"""The port's own host layers (bwtmerge_tpu_torch/{formats,native,utils},
models/{runs,oracle,spill,kfold_stage,fmi}, ops/{rank_np,search_np,
interleave_np}) against the JAX package's modules they were copied from:
the same inputs, made from a seed with numpy, through both; files
byte-identical, values exactly equal.
"""

import io
import os

import numpy as np
import pytest

import bwtmerge_tpu.formats as j_formats
import bwtmerge_tpu.formats.sidecar as j_sidecar
import bwtmerge_tpu.formats.streaming as j_streaming
import bwtmerge_tpu.formats.streaming_read as j_sread
import bwtmerge_tpu.models.fmi as j_fmi
import bwtmerge_tpu.models.kfold_stage as j_stage
import bwtmerge_tpu.models.oracle as j_oracle
import bwtmerge_tpu.models.runs as j_runs
import bwtmerge_tpu.models.spill as j_spill
import bwtmerge_tpu.native as j_native
import bwtmerge_tpu.native.windowed as j_windowed
import bwtmerge_tpu.ops.interleave_np as j_interleave
import bwtmerge_tpu.ops.rank_np as j_rank
import bwtmerge_tpu.ops.search_np as j_search
import bwtmerge_tpu.utils.alphabet as j_alpha
import bwtmerge_tpu.utils.hashing as j_hash
import bwtmerge_tpu.utils.ranges as j_ranges
import bwtmerge_tpu_torch.formats as p_formats
import bwtmerge_tpu_torch.formats.sidecar as p_sidecar
import bwtmerge_tpu_torch.formats.streaming as p_streaming
import bwtmerge_tpu_torch.formats.streaming_read as p_sread
import bwtmerge_tpu_torch.models.fmi as p_fmi
import bwtmerge_tpu_torch.models.kfold_stage as p_stage
import bwtmerge_tpu_torch.models.oracle as p_oracle
import bwtmerge_tpu_torch.models.runs as p_runs
import bwtmerge_tpu_torch.models.spill as p_spill
import bwtmerge_tpu_torch.native as p_native
import bwtmerge_tpu_torch.native.build as p_build
import bwtmerge_tpu_torch.native.windowed as p_windowed
import bwtmerge_tpu_torch.ops.interleave_np as p_interleave
import bwtmerge_tpu_torch.ops.rank_np as p_rank
import bwtmerge_tpu_torch.ops.search_np as p_search
import bwtmerge_tpu_torch.utils.alphabet as p_alpha
import bwtmerge_tpu_torch.utils.hashing as p_hash
import bwtmerge_tpu_torch.utils.metrics as p_metrics
import bwtmerge_tpu_torch.utils.pipeline as p_pipeline
import bwtmerge_tpu_torch.utils.ranges as p_ranges

FORMATS = sorted(p_formats.FORMATS)
PKG = {"jax": dict(formats=j_formats, runs=j_runs, alpha=j_alpha,
                   sread=j_sread, streaming=j_streaming),
       "port": dict(formats=p_formats, runs=p_runs, alpha=p_alpha,
                    sread=p_sread, streaming=p_streaming)}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _collections(seed, n_a=14, n_b=10, hi=60):
    r = np.random.default_rng(seed)
    return (j_oracle.random_collection(r, n_a, 1, hi),
            j_oracle.random_collection(r, n_b, 1, hi))


def _same_runs(a, b):
    return (np.array_equal(a.syms, b.syms) and np.array_equal(a.lens, b.lens)
            and a.syms.dtype == b.syms.dtype and a.lens.dtype == b.lens.dtype)


def _both_runs(values):
    return (j_runs.RunArrays.from_values(values),
            p_runs.RunArrays.from_values(values))


# -- utils, runs, oracle -------------------------------------------------------


def test_formats_registry_is_the_same():
    assert sorted(j_formats.FORMATS) == FORMATS and len(FORMATS) == 7
    for tag in FORMATS:
        assert (int(p_formats.FORMATS[tag].order())
                == int(j_formats.FORMATS[tag].order()))
    assert sorted(p_streaming.STREAM_WRITERS) == sorted(
        j_streaming.STREAM_WRITERS)


@pytest.mark.parametrize("order", [int(o) for o in j_alpha.AlphabeticOrder])
def test_alphabet_orders_and_counts(order):
    ja = j_alpha.create_alphabet(j_alpha.AlphabeticOrder(order))
    pa = p_alpha.create_alphabet(p_alpha.AlphabeticOrder(order))
    assert np.array_equal(ja.char2comp, pa.char2comp)
    assert np.array_equal(ja.comp2char, pa.comp2char)
    assert int(p_alpha.identify_alphabet(pa)) == int(
        j_alpha.identify_alphabet(ja))
    counts = np.array([3, 9, 0, 4, 7, 1])
    jc = j_alpha.Alphabet.from_counts(counts, ja.char2comp, ja.comp2char)
    pc = p_alpha.Alphabet.from_counts(counts, pa.char2comp, pa.comp2char)
    assert np.array_equal(jc.C, pc.C) and jc.C.dtype == pc.C.dtype
    assert np.array_equal(jc.counts(), pc.counts())
    assert [pc.char_range(c) for c in range(6)] == [
        jc.char_range(c) for c in range(6)]
    assert repr(jc) == repr(pc)
    assert pc == p_alpha.Alphabet.from_counts(counts, pa.char2comp,
                                              pa.comp2char)
    assert (pc != p_alpha.Alphabet()) == (jc != j_alpha.Alphabet())


@pytest.mark.parametrize("r,blocks", [((0, 99), 1), ((0, 99), 7), ((5, 5), 3),
                                      ((0, -1), 2), ((0, 2), 8),
                                      ((10, 1000003), 64)])
def test_get_bounds(r, blocks):
    assert p_ranges.get_bounds(r, blocks) == j_ranges.get_bounds(r, blocks)


@pytest.mark.parametrize("seed", [1, 2])
def test_hashing(seed):
    r = np.random.default_rng(seed)
    data = r.integers(0, 256, size=5000).astype(np.uint8)
    assert p_hash.fnv1a_bytes(data) == j_hash.fnv1a_bytes(data)
    assert p_native.fnv1a_bytes(data) == j_native.fnv1a_bytes(data)
    syms = r.integers(0, 6, size=300).astype(np.uint8)
    lens = r.integers(1, 400, size=300)
    assert p_hash.fnv1a_runs(syms, lens) == j_hash.fnv1a_runs(syms, lens)
    assert p_native.rle_hash(syms, lens) == j_native.rle_hash(syms, lens)
    assert p_native.rle_hash(syms, lens) == p_hash.fnv1a_runs(syms, lens)


def test_metrics_and_pipeline():
    assert p_metrics.in_megabytes(3 << 20) == 3.0
    t = p_metrics.PhaseTimer()
    with t.phase("x"):
        pass
    assert "x" in t.phases and t.total() >= 0
    out = io.StringIO()
    t.report(1 << 20, out=out)
    assert "x" in out.getvalue()
    assert list(p_pipeline.prefetch_chunks(iter(range(50)), depth=2)) == list(
        range(50))

    def failing():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError):
        list(p_pipeline.prefetch_chunks(failing(), depth=1))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_run_arrays(seed):
    r = np.random.default_rng(seed)
    values = np.repeat(r.integers(0, 6, size=200), r.integers(1, 9, size=200))
    jr, pr = _both_runs(values.astype(np.uint8))
    assert _same_runs(jr, pr)
    assert jr.size() == pr.size() and jr.n_runs == pr.n_runs
    assert np.array_equal(jr.counts(6), pr.counts(6))
    assert np.array_equal(jr.decode(), pr.decode())
    assert _same_runs(jr.coalesced(), pr.coalesced())
    jchunks = list(jr.iter_chunks(37))
    pchunks = list(pr.iter_chunks(37))
    assert len(jchunks) == len(pchunks)
    for (js, jl), (ps, pl) in zip(jchunks, pchunks):
        assert np.array_equal(js, ps) and np.array_equal(jl, pl)
    # by value across the packages, either way round, and split runs too
    assert pr == jr and jr == pr
    halves = np.stack([pr.lens - pr.lens // 2, pr.lens // 2], 1).reshape(-1)
    split = p_runs.RunArrays(np.repeat(pr.syms, 2)[halves > 0],
                             halves[halves > 0])
    assert split.n_runs > pr.n_runs
    assert split == pr
    assert pr != p_runs.RunArrays.from_values(np.zeros(3, np.uint8))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_oracle(seed):
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    ja = j_oracle.random_collection(r1, 8, 1, 40)
    pa = p_oracle.random_collection(r2, 8, 1, 40)
    assert all(np.array_equal(x, y) for x, y in zip(ja, pa))
    jb = j_oracle.random_collection(r1, 5, 1, 40)
    assert _same_runs(j_oracle.build_bwt(ja), p_oracle.build_bwt(ja))
    assert _same_runs(j_oracle.merge_collections([ja, jb]),
                      p_oracle.merge_collections([ja, jb]))
    assert np.array_equal(j_oracle.rank_array_oracle(ja, jb),
                          p_oracle.rank_array_oracle(ja, jb))
    text = r1.integers(0, 50, size=400)
    assert np.array_equal(j_oracle.suffix_array(text),
                          p_oracle.suffix_array(text))
    pat = ja[0][:3]
    assert (j_oracle.count_occurrences(ja, pat)
            == p_oracle.count_occurrences(ja, pat))


# -- formats -------------------------------------------------------------------


def _alphabet_of(pkg, fmt, runs):
    mods = PKG[pkg]
    order = mods["formats"].FORMATS[fmt].order()
    base = mods["alpha"].create_alphabet(order)
    return mods["alpha"].Alphabet.from_counts(runs.counts(6), base.char2comp,
                                              base.comp2char)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("fmt", FORMATS)
def test_format_written_by_one_read_by_the_other(tmp_path, fmt, writer,
                                                 reader):
    a, _ = _collections(7)
    values = j_oracle.build_bwt(a).decode()
    paths = {}
    for pkg in ("jax", "port"):
        runs = PKG[pkg]["runs"].RunArrays.from_values(values)
        paths[pkg] = str(tmp_path / f"{pkg}.{fmt}")
        PKG[pkg]["formats"].write_bwt(paths[pkg], fmt, runs,
                                      _alphabet_of(pkg, fmt, runs))
    assert _read(paths["jax"]) == _read(paths["port"])
    runs, counts, alpha = PKG[reader]["formats"].read_bwt(paths[writer], fmt)
    want_runs, want_counts, want_alpha = PKG[writer]["formats"].read_bwt(
        paths[writer], fmt)
    assert _same_runs(runs, want_runs)
    assert np.array_equal(counts, want_counts)
    assert np.array_equal(alpha.C, want_alpha.C)
    assert np.array_equal(alpha.char2comp, want_alpha.char2comp)
    assert np.array_equal(alpha.comp2char, want_alpha.comp2char)
    assert np.array_equal(runs.decode(), values)
    # the chunked reader, in small chunks
    chunks = list(PKG[reader]["sread"].read_bwt_chunks(paths[writer], fmt,
                                                       chunk_bytes=64))
    want = list(PKG[writer]["sread"].read_bwt_chunks(paths[writer], fmt,
                                                     chunk_bytes=64))
    assert len(chunks) == len(want)
    for (s, l), (ws, wl) in zip(chunks, want):
        assert np.array_equal(s, ws) and np.array_equal(l, wl)


@pytest.mark.parametrize("fmt", sorted(p_streaming.STREAM_WRITERS))
@pytest.mark.parametrize("chunk", [5, 1 << 20])
def test_stream_writers(tmp_path, fmt, chunk):
    a, b = _collections(8, 30, 20)
    values = j_oracle.merge_collections([a, b]).decode()
    paths = {}
    for pkg in ("jax", "port"):
        runs = PKG[pkg]["runs"].RunArrays.from_values(values)
        paths[pkg] = str(tmp_path / f"{pkg}.{fmt}")
        # whole runs per chunk: the writers take maximal runs
        chunks = ((runs.syms[s:s + chunk], runs.lens[s:s + chunk])
                  for s in range(0, runs.n_runs, chunk))
        PKG[pkg]["streaming"].write_bwt_stream(
            paths[pkg], fmt, chunks, _alphabet_of(pkg, fmt, runs))
    assert _read(paths["jax"]) == _read(paths["port"])
    batch = str(tmp_path / f"batch.{fmt}")
    runs = p_runs.RunArrays.from_values(values)
    p_formats.write_bwt(batch, fmt, runs, _alphabet_of("port", fmt, runs))
    assert _read(batch) == _read(paths["port"])


def test_corrupted_header_and_unknown_format_raise_alike(tmp_path):
    path = str(tmp_path / "bad.native")
    with open(path, "wb") as f:
        f.write(b"\x00" * 64)
    for mod in (j_formats, p_formats):
        with pytest.raises(ValueError):
            mod.read_bwt(path, "native")
        with pytest.raises(ValueError, match="invalid BWT format"):
            mod.read_bwt(path, "nope")


@pytest.mark.parametrize("seed", [1, 2])
def test_sidecar(tmp_path, seed):
    a, _ = _collections(seed)
    jp, pp = str(tmp_path / "j.reads4"), str(tmp_path / "p.reads4")
    j_sidecar.write_sidecar_reads(jp, a)
    p_sidecar.write_sidecar_reads(pp, a)
    assert _read(jp) == _read(pp)
    assert p_sidecar.sidecar_path("x.sga") == j_sidecar.sidecar_path("x.sga")
    for got, want in zip(p_sidecar.read_sidecar(jp), j_sidecar.read_sidecar(pp)):
        assert np.array_equal(got, want)
    got, want = p_sidecar.load_creads(jp), j_sidecar.load_creads(pp)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    with open(pp, "r+b") as f:          # a torn write fails its hash in both
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0x01]))
    for mod in (j_sidecar, p_sidecar):
        with pytest.raises(ValueError):
            mod.load_creads(pp)


# -- the native library --------------------------------------------------------


def test_native_library_is_the_ports_own():
    lib = p_build.load_library()
    path = p_build.library_path()
    assert os.path.exists(path)
    build_dir = os.path.join(os.path.dirname(p_build.__file__), "..", "build")
    assert os.path.samefile(os.path.dirname(path), build_dir)
    assert "torch" in os.path.basename(path)
    import bwtmerge_tpu.native.build as j_build

    assert lib is not j_build.load_library()
    src = os.path.join(os.path.dirname(p_build.__file__), "src")
    assert sorted(os.listdir(src)) == sorted(
        f for f in os.listdir(os.path.join(os.path.dirname(j_build.__file__),
                                           "src")) if f != "selftest.cpp")


def test_native_build_failure_raises_with_compiler_output(tmp_path,
                                                          monkeypatch):
    bad = tmp_path / "src"
    bad.mkdir()
    for name in p_build._SOURCES:
        (bad / name).write_text("this is not C++\n")
    monkeypatch.setattr(p_build, "_SRC_DIR", str(bad))
    monkeypatch.setattr(p_build, "_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="error"):
        p_build.build_library()
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_native_codecs(seed):
    r = np.random.default_rng(seed)
    syms = r.integers(0, 6, size=500).astype(np.uint8)
    lens = np.where(r.random(500) < 0.1, r.integers(1, 100000, size=500),
                    r.integers(1, 20, size=500)).astype(np.int64)
    enc = p_native.rle_encode(syms, lens)
    assert enc == j_native.rle_encode(syms, lens)
    for got, want in zip(p_native.rle_decode(enc), j_native.rle_decode(enc)):
        assert np.array_equal(got, want)
    assert (p_native.rle_encode_at(syms, lens, 3)
            == j_native.rle_encode_at(syms, lens, 3))
    values = np.sort(r.choice(1 << 40, size=400, replace=False))
    counts = r.integers(1, 1 << 20, size=400)
    assert p_native.ra_encode(values, counts) == j_native.ra_encode(values,
                                                                    counts)
    other = (np.sort(r.choice(1 << 40, size=300, replace=False)),
             r.integers(1, 9, size=300))
    for got, want in zip(p_native.ra_merge_pair((values, counts), other),
                         j_native.ra_merge_pair((values, counts), other)):
        assert np.array_equal(got, want)
    out_p = np.zeros((int(lens.sum()) + 1) // 2 + 8, np.uint8)
    out_j = np.zeros_like(out_p)
    assert (p_native.nib4_pack(syms, lens, out_p)
            == j_native.nib4_pack(syms, lens, out_j))
    assert np.array_equal(out_p, out_j)
    assert np.array_equal(p_native.fragment_phase_table(syms, lens),
                          j_native.fragment_phase_table(syms, lens))


def _merge_inputs(seed):
    a, b = _collections(seed, 20, 15)
    ra = j_oracle.rank_array_oracle(a, b)
    values, counts = j_search.compact_rank_array(
        ra.astype(np.int64), np.ones(ra.size, np.int64))
    return (j_oracle.build_bwt(a), j_oracle.build_bwt(b), values, counts,
            j_oracle.merge_collections([a, b]))


def _ra_chunks(values, counts, n):
    for s in range(0, values.size, n):
        yield values[s:s + n], counts[s:s + n]


def _cat(chunks):
    parts = [(s.copy(), l.copy()) for s, l in chunks]
    return p_runs.RunArrays(np.concatenate([p[0] for p in parts]),
                            np.concatenate([p[1] for p in parts]))


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("how", ["native", "streaming", "stream_chunks",
                                 "windowed", "numpy"])
def test_interleaves(seed, how):
    a, b, values, counts, want = _merge_inputs(seed)
    pa = p_runs.RunArrays(a.syms, a.lens)
    pb = p_runs.RunArrays(b.syms, b.lens)
    if how == "native":
        got = p_native.interleave_native(pa, pb, values, counts)
        ref = j_native.interleave_native(a, b, values, counts)
    elif how == "streaming":
        got = p_native.interleave_streaming(pa, pb,
                                            _ra_chunks(values, counts, 7))
        ref = j_native.interleave_streaming(a, b,
                                            _ra_chunks(values, counts, 7))
    elif how == "stream_chunks":
        got = _cat(p_native.interleave_stream_chunks(
            pa, pb, _ra_chunks(values, counts, 7)))
        ref = _cat(j_native.interleave_stream_chunks(
            a, b, _ra_chunks(values, counts, 7)))
    elif how == "windowed":
        stats_p, stats_j = {}, {}
        got = _cat(p_windowed.interleave_windowed_chunks(
            pa.iter_chunks(11), pb.iter_chunks(13),
            _ra_chunks(values, counts, 7), window_positions=1024,
            stats=stats_p))
        ref = _cat(j_windowed.interleave_windowed_chunks(
            a.iter_chunks(11), b.iter_chunks(13),
            _ra_chunks(values, counts, 7), window_positions=1024,
            stats=stats_j))
        assert stats_p == stats_j
    else:
        got = p_interleave.interleave(pa, pb, values, counts)
        ref = j_interleave.interleave(a, b, values, counts)
    assert isinstance(got, p_runs.RunArrays)
    assert _same_runs(got, ref)
    assert got == want


# -- spill, stage frames -------------------------------------------------------


def _emissions(seed, n=6000):
    r = np.random.default_rng(seed)
    return [(r.integers(0, 5000, size=n // 6), r.integers(1, 9, size=n // 6))
            for _ in range(6)]


@pytest.mark.parametrize("threshold", [100, 1 << 20])
@pytest.mark.parametrize("seed", [1, 2])
def test_rank_array_spill(tmp_path, seed, threshold):
    outs = []
    for mod, sub in ((j_spill, "j"), (p_spill, "p")):
        d = tmp_path / sub
        d.mkdir()
        spill = mod.RankArraySpill(temp_dir=str(d),
                                   spill_threshold_runs=threshold,
                                   compact_every=500)
        for v, c in _emissions(seed):
            spill.emit(v.astype(np.int64), c.astype(np.int64))
        n_files = spill.n_spill_files
        chunks = [(v.copy(), c.copy()) for v, c in spill.stream(257)]
        outs.append((n_files,
                     np.concatenate([v for v, _ in chunks]),
                     np.concatenate([c for _, c in chunks])))
        assert os.listdir(d) == []       # drained spill files are removed
    assert outs[0][0] == outs[1][0] and (outs[0][0] > 0) == (threshold == 100)
    assert np.array_equal(outs[0][1], outs[1][1])
    assert np.array_equal(outs[0][2], outs[1][2])
    allv = np.concatenate([v for v, _ in _emissions(seed)])
    allc = np.concatenate([c for _, c in _emissions(seed)])
    want = j_search.compact_rank_array(allv.astype(np.int64),
                                       allc.astype(np.int64))
    assert np.array_equal(outs[1][1], want[0])
    assert np.array_equal(outs[1][2], want[1])


@pytest.mark.parametrize("n_streams", [1, 3])
def test_merge_ra_chunk_streams(n_streams):
    parts = [j_search.compact_rank_array(v.astype(np.int64),
                                         c.astype(np.int64))
             for v, c in _emissions(4)[:n_streams]]

    def streams():
        return [_ra_chunks(v, c, 97) for v, c in parts]

    got = [(v.copy(), c.copy())
           for v, c in p_spill.merge_ra_chunk_streams(streams(), 64)]
    ref = [(v.copy(), c.copy())
           for v, c in j_spill.merge_ra_chunk_streams(streams(), 64)]
    assert np.array_equal(np.concatenate([v for v, _ in got]),
                          np.concatenate([v for v, _ in ref]))
    assert np.array_equal(np.concatenate([c for _, c in got]),
                          np.concatenate([c for _, c in ref]))
    v = np.concatenate([v for v, _ in got])
    assert bool((np.diff(v) > 0).all())


@pytest.mark.parametrize("writer,reader", [(j_stage, p_stage),
                                           (p_stage, j_stage)])
def test_kfold_stage_frames(writer, reader):
    r = np.random.default_rng(9)
    chunks = []
    for n in (1, 40, 300):
        lens = r.integers(1, 50, size=n).astype(np.int64)
        lens[r.integers(0, n)] = 255
        lens[r.integers(0, n)] = 1 << 33
        chunks.append((r.integers(0, 6, size=n).astype(np.uint8), lens))
    bufs = {}
    for mod in (j_stage, p_stage):
        buf = io.BytesIO()
        for s, l in chunks:
            mod.write_frame(buf, s, l)
        mod.write_end(buf)
        bufs[mod] = buf.getvalue()
    assert bufs[j_stage] == bufs[p_stage]
    back = list(reader.read_frames(io.BytesIO(bufs[writer])))
    assert len(back) == len(chunks)
    for (s, l), (ws, wl) in zip(back, chunks):
        assert np.array_equal(s, ws) and np.array_equal(l, wl)
    with pytest.raises(EOFError):
        list(reader.read_frames(io.BytesIO(bufs[writer][:-9])))


def test_kfold_stage_main_is_the_ports_own(tmp_path):
    # one stage as a child process: A and B from files, the rank array from
    # a spill file; its frames decode to the merge, and the child loads
    # nothing of the JAX package
    import subprocess
    import sys
    import textwrap

    a, b, values, counts, want = _merge_inputs(3)
    for name, runs in (("a", a), ("b", b)):
        p_formats.write_bwt(str(tmp_path / f"{name}.sga"), "sga",
                            p_runs.RunArrays(runs.syms, runs.lens),
                            p_alpha.Alphabet())
    spill = p_spill.RankArraySpill(temp_dir=str(tmp_path),
                                   spill_threshold_runs=1)
    spill.emit(values, counts)
    spill.emit(np.zeros(0, np.int64), np.zeros(0, np.int64))
    spill._compact()
    spill._spill()
    files = [(f.path, f.n_runs) for f in spill._files]
    assert files
    child = textwrap.dedent("""
        import sys
        from bwtmerge_tpu_torch.models import kfold_stage
        rc = kfold_stage.main(sys.argv[1:])
        bad = [m for m in sys.modules if m == "torch" or m == "jax"
               or m.split(".")[0] == "bwtmerge_tpu"]
        assert not bad, bad
        sys.exit(rc)
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", child, "--a-path", str(tmp_path / "a.sga"),
         "--a-fmt", "sga", "--b-path", str(tmp_path / "b.sga"), "--b-fmt",
         "sga", "--window", "1024", "--spill"]
        + [f"{p}:{n}" for p, n in files],
        capture_output=True, cwd=root, timeout=120)
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    got = _cat(p_stage.read_frames(io.BytesIO(res.stdout)))
    assert got == want


# -- the host FM-index, the numpy search, the host FMI -------------------------


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_rank_index(seed):
    a, _ = _collections(seed)
    runs = j_oracle.build_bwt(a)
    r = np.random.default_rng(seed)
    pos = r.integers(0, runs.size() + 1, size=200)
    comp = r.integers(0, 6, size=200)
    ji = j_rank.RankIndex.build(runs, 6)
    pi = p_rank.RankIndex.build(p_runs.RunArrays(runs.syms, runs.lens), 6)
    assert np.array_equal(ji.rank(pos, comp), pi.rank(pos, comp))
    assert np.array_equal(ji.ranks_all(pos), pi.ranks_all(pos))
    inside = pos[pos < runs.size()]
    assert np.array_equal(ji.access(inside), pi.access(inside))
    for got, want in zip(pi.inverse_select(inside), ji.inverse_select(inside)):
        assert np.array_equal(got, want)
    counts = runs.counts(6)
    for c in range(6):
        if counts[c]:
            i = r.integers(1, counts[c] + 1, size=20)
            assert np.array_equal(ji.select(i, c), pi.select(i, c))
    js = j_rank.SparseRankIndex.build(runs, 6)
    ps = p_rank.SparseRankIndex.build(p_runs.RunArrays(runs.syms, runs.lens),
                                      6)
    assert np.array_equal(js.rank(pos, comp), ps.rank(pos, comp))
    for got, want in zip(ps.inverse_select(inside), js.inverse_select(inside)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_numpy_search(seed):
    a, b = _collections(seed)
    ja, jb = (j_fmi.FMI.from_runs(j_oracle.build_bwt(s)) for s in (a, b))
    pa, pb = (p_fmi.FMI.from_runs(p_oracle.build_bwt(s)) for s in (a, b))

    def ra(mod, fa, fb):
        return mod.build_rank_array(
            fa.rank_index, fa.alpha.C.astype(np.int64),
            fb.rank_index, fb.alpha.C.astype(np.int64),
            fa.sequences(), fb.sequences())

    got, want = ra(p_search, pa, pb), ra(j_search, ja, jb)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    oracle_ra = j_oracle.rank_array_oracle(a, b)
    assert np.array_equal(np.repeat(got[0], got[1]), np.sort(oracle_ra))
    r = np.random.default_rng(seed)
    v, c = r.integers(0, 50, size=300), r.integers(1, 5, size=300)
    for fn in ("compact_rank_array",):
        for g, w in zip(getattr(p_search, fn)(v, c),
                        getattr(j_search, fn)(v, c)):
            assert np.array_equal(g, w)
    x, y = p_search.compact_rank_array(v[:150], c[:150]), \
        p_search.compact_rank_array(v[150:], c[150:])
    for g, w in zip(p_search.merge_rank_arrays(x, y),
                    j_search.merge_rank_arrays(x, y)):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("seed", [1, 2])
def test_host_fmi(tmp_path, seed):
    a, _ = _collections(seed)
    path = str(tmp_path / "a.sga")
    j_formats.write_bwt(path, "sga", j_oracle.build_bwt(a), j_alpha.Alphabet())
    j_sidecar.write_sidecar_reads(j_sidecar.sidecar_path(path), a)
    jf, pf = j_fmi.load_fmi(path, "sga"), p_fmi.load_fmi(path, "sga")
    assert type(pf).__mro__[1] is object         # no base class of the JAX FMI
    assert pf.size() == jf.size() and pf.sequences() == jf.sequences()
    assert pf.hash() == jf.hash()
    assert np.array_equal(pf.creads(), jf.creads())
    pats = ["A", "ACG", "TT", "", "GATTACA", "N"] + [
        "".join("ACGT"[int(c) - 1] for c in s[:4] if 1 <= c <= 4)
        for s in a[:6]]
    assert np.array_equal(pf.verify(pats), jf.verify(pats))
    assert [pf.find(p) for p in pats] == [jf.find(p) for p in pats]
    assert [pf.count(p) for p in pats] == [jf.count(p) for p in pats]
    pos = np.arange(0, pf.size(), 7)
    for got, want in zip(pf.LF_step(pos), jf.LF_step(pos)):
        assert np.array_equal(got, want)
    assert np.array_equal(pf.LF_all(pos), jf.LF_all(pos))
    assert np.array_equal(pf.psi(pos), jf.psi(pos))
    assert np.array_equal(pf.extract(0, pf.size() - 1),
                          jf.extract(0, jf.size() - 1))
    for got, want in zip(pf.extract_all(), jf.extract_all()):
        assert np.array_equal(got, want)
    assert np.array_equal(pf.extract_sequence(2), jf.extract_sequence(2))
    # serialize through the port, every format, to the JAX package's bytes
    for fmt in FORMATS:
        jp, pp = str(tmp_path / f"j.{fmt}"), str(tmp_path / f"p.{fmt}")
        j_fmi.serialize_fmi(jf, jp, fmt)
        p_fmi.serialize_fmi(pf, pp, fmt)
        assert _read(jp) == _read(pp)
    # equality and invalidation as a dataclass of its own
    again = p_fmi.load_fmi(path, "sga")
    assert again == pf
    rank = pf.rank_index
    pf.attach_creads(pf.creads())
    pf.invalidate()
    assert pf._rank is None and pf._creads is None and pf.creads_path is None
    assert pf.creads() is None and pf.rank_index is not rank
    assert again == pf                     # caches take no part in equality

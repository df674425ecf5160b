"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These need a CUDA card and nvcc; without them every test skips, with its
reason.  On the card, where jax (imported by tests/conftest.py) is absent:
    python -m pytest --noconftest tests/test_torch_kernels.py
"""

import pytest
import torch

from bwtmerge_tpu_torch import kernels
from bwtmerge_tpu_torch.ops.decode_torch import (build_decode_rows,
                                                 build_decode_rows_plain,
                                                 decode_creads,
                                                 decode_creads_device,
                                                 decode_creads_plain)
from bwtmerge_tpu_torch.ops.rank_streamed import (streamed_lf,
                                                  streamed_lf_plain,
                                                  streamed_probe,
                                                  streamed_probe_plain,
                                                  streamed_select,
                                                  streamed_select_plain)
from bwtmerge_tpu_torch.ops.rank_torch import (REC_TILE, build_rec,
                                               build_rec_plain, rec_build)
from bwtmerge_tpu_torch.ops.walk_torch import (SUPER,
                                               build_walk_planes,
                                               build_walk_planes_plain,
                                               walk_emit, walk_emit_plain)
from chip_smoke import DECODE_EDGE_BLOCKS, random_index, symbol_records

SENT = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _index(n_pos, device):
    return random_index(n_pos, device, seed=3)


PROBE_FORMS = ["full", "select", "select-fused", "lf"]


def _probe_form(form, rec, q, size, chars, perm, plain=False):
    """K1's `form` (or its plain version): select-fused is the select form
    given the sort's permutation, chars in the caller's order."""
    if form == "full":
        return (streamed_probe_plain if plain else streamed_probe)(rec, q,
                                                                   size)
    if form == "lf":
        return (streamed_lf_plain if plain else streamed_lf)(rec, q, size)
    fn = streamed_select_plain if plain else streamed_select
    return fn(rec, q, chars, size, perm if form == "select-fused" else None)


def _probe_batch(n_pos, n_q, n_sent, device, seed):
    """Unsorted keys in [0, n_pos] (n_pos among them) and sentinels, sorted:
    (sorted keys, the sort's permutation, characters 0..9 beside the
    unsorted keys)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randint(0, n_pos + 1, (n_q + n_sent,), generator=gen,
                      device=device)
    q[0] = n_pos
    q[n_q:] = SENT
    q = q[torch.randperm(q.numel(), generator=gen, device=device)]
    ks, perm = torch.sort(q.to(torch.int32))
    chars = torch.randint(0, 10, (q.numel(),), generator=gen, device=device,
                          dtype=torch.int32)
    return ks, perm, chars


@pytest.mark.parametrize("form", PROBE_FORMS)
@pytest.mark.parametrize("n_pos", [1, 31, 32, 1000, 1 << 20])
def test_probe_kernel_matches_plain(cuda, n_pos, form):
    idx = _index(n_pos, cuda)
    ks, perm, chars = _probe_batch(n_pos, 5000, 300, cuda, n_pos)
    name = form.split("-")[0]
    before = kernels.STREAMED_PROBE.launches
    by_form = kernels.STREAMED_PROBE.forms[name]
    got = _probe_form(form, idx.rec, ks, idx.size, chars, perm)
    assert kernels.STREAMED_PROBE.launches == before + 1
    assert kernels.STREAMED_PROBE.forms[name] == by_form + 1
    want = _probe_form(form, idx.rec, ks, idx.size, chars, perm, plain=True)
    assert torch.equal(got, want)
    if form == "select-fused":
        # the fused realign is the sorted select put back by the permutation
        unfused = torch.empty_like(got)
        unfused[perm] = streamed_select_plain(idx.rec, ks, chars[perm],
                                              idx.size)
        assert torch.equal(got, unfused)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.int16,
                                   torch.int64])
def test_probe_kernel_select_takes_each_char_dtype(cuda, dtype):
    idx = _index(1000, cuda)
    ks, perm, chars = _probe_batch(1000, 3000, 100, cuda, 17)
    chars = (chars - 1).to(dtype)            # -1 (255 as uint8) to 8
    for p in (None, perm):
        c = chars if p is not None else chars[perm]
        assert torch.equal(streamed_select(idx.rec, ks, c, idx.size, p),
                           streamed_select_plain(idx.rec, ks, c, idx.size, p))


@pytest.mark.parametrize("form", PROBE_FORMS)
def test_probe_kernel_empty_and_all_sentinels(cuda, form):
    idx = _index(1000, cuda)
    rows = {"full": (9,), "lf": (2,)}.get(form, ())
    before = kernels.STREAMED_PROBE.launches
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    got = _probe_form(form, idx.rec, empty, idx.size, empty,
                      empty.to(torch.int64))
    assert got.shape == rows + (0,)
    assert kernels.STREAMED_PROBE.launches == before     # nothing launched
    sent = torch.full((777,), SENT, dtype=torch.int32, device=cuda)
    got = _probe_form(form, idx.rec, sent, idx.size, sent,
                      torch.arange(777, device=cuda).flip(0))
    assert kernels.STREAMED_PROBE.launches == before + 1
    assert got.shape == rows + (777,) and not got.any()


@pytest.mark.parametrize("shape", [(1, 1), (7, 300), (50, 1 << 16)])
def test_walk_kernel_matches_plain(cuda, shape):
    idx = _index(200_000, cuda)
    cpl = build_walk_planes(idx.rec)
    gen = torch.Generator(device=cuda).manual_seed(5)
    creads = torch.randint(0, 6, shape, generator=gen,
                           device=cuda).to(torch.int8)
    a0 = int(idx.C[1])
    before = kernels.WALK_EMIT.launches
    e1, n1 = walk_emit(cpl, idx.C, creads, a0)
    assert kernels.WALK_EMIT.launches == before + 1
    e2, n2 = walk_emit_plain(cpl, idx.C, creads, a0)
    assert torch.equal(e1, e2) and int(n1) == int(n2)


@pytest.mark.parametrize("n_pos", [1, 31, 223, 224, 225, 447, 448, 200_000])
def test_walk_planes_build_kernel_matches_plain(cuda, n_pos):
    idx = _index(n_pos, cuda)
    before = kernels.WALK_PLANES_BUILD.launches
    got = build_walk_planes(idx.rec)
    assert kernels.WALK_PLANES_BUILD.launches == before + 1
    assert torch.equal(got, build_walk_planes_plain(idx.rec))


@pytest.mark.parametrize("n_pos", [1, 224, 447, 100_000])
def test_walk_kernel_at_super_block_edges(cuda, n_pos):
    # every lane of one walk starts at a0: the super-blocks' first and last
    # positions and their neighbours, and the table's last position (the
    # size)
    idx = _index(n_pos, cuda)
    planes = build_walk_planes(idx.rec)
    gen = torch.Generator(device=cuda).manual_seed(n_pos)
    creads = torch.randint(0, 6, (5, 257), generator=gen,
                           device=cuda).to(torch.int8)
    creads[0, :5] = torch.arange(1, 6, device=cuda)
    edges = {0, n_pos}
    for e in list(range(0, min(n_pos, 1000) + 225, SUPER)) \
            + [n_pos // SUPER * SUPER]:
        edges.update(x for x in (e - 1, e, e + 1, e + 31, e + 32)
                     if 0 <= x <= n_pos)
    for a0 in sorted(edges):
        e1, n1 = walk_emit(planes, idx.C, creads, a0)
        e2, n2 = walk_emit_plain(planes, idx.C, creads, a0)
        assert torch.equal(e1, e2) and int(n1) == int(n2), a0


def test_decode_rows_build_kernel_matches_plain(cuda):
    for idx in (_index(1, cuda), _index(1000, cuda), _real_index(cuda)[0]):
        before = kernels.DECODE_ROWS_BUILD.launches
        got = build_decode_rows(idx.rec)
        assert kernels.DECODE_ROWS_BUILD.launches == before + 1
        assert torch.equal(got, build_decode_rows_plain(idx.rec))


@pytest.mark.parametrize("nblk", DECODE_EDGE_BLOCKS)
def test_decode_rows_build_kernel_at_the_edges(cuda, nblk):
    # one block, a warp's and a thread block's threads and rows (4 a
    # thread) and their neighbours, every count modulo 4, 2^22 + 5 blocks;
    # symbols 0..6
    rec = symbol_records(nblk, cuda, nblk)
    before = kernels.DECODE_ROWS_BUILD.launches
    got = build_decode_rows(rec)
    assert kernels.DECODE_ROWS_BUILD.launches == before + 1
    torch.cuda.synchronize(cuda)
    assert torch.equal(got, build_decode_rows_plain(rec))


def _card_nibbles(nblk, device, seed):
    """Random block-planar nibbles of nblk blocks on `device`: symbols 0..5
    and, from a random point of the last block on, the pad symbol 6."""
    gen = torch.Generator(device=device).manual_seed(seed)
    syms = torch.randint(0, 6, (nblk * 32,), generator=gen, device=device,
                         dtype=torch.uint8)
    syms[nblk * 32 - 1 - seed % 32:] = 6
    blocks = syms.view(nblk, 32)
    return (blocks[:, :16] | (blocks[:, 16:] << 4)).reshape(-1)


@pytest.mark.parametrize("nblk", [1, 2, 255, 256, 257, 511, 513,
                                  (1 << 20) + 3])
def test_rec_build_kernel_matches_plain(cuda, nblk):
    nib = _card_nibbles(nblk, cuda, nblk)
    base = torch.randint(0, 1 << 30, (8,), device=cuda, dtype=torch.int32)
    for b in (None, base):
        before = kernels.REC_BUILD.launches
        got = build_rec(nib, nblk, b)
        assert kernels.REC_BUILD.launches == before + 1
        torch.cuda.synchronize(cuda)
        assert torch.equal(got, build_rec_plain(nib, nblk, b))
    # a buffer longer than the table, as the packers leave it
    longer = torch.cat([nib, torch.full((48,), 0x66, dtype=torch.uint8,
                                        device=cuda)])
    assert torch.equal(build_rec(longer, nblk), build_rec_plain(nib, nblk))


@pytest.mark.parametrize("nblk", [1, REC_TILE - 1, REC_TILE, REC_TILE + 1,
                                  2 * REC_TILE + 1, (1 << 22) + 5])
def test_rec_build_kernel_at_the_tile_edges(cuda, nblk):
    # one tile, its edges, a second and a third tile, and 4097 tiles: more
    # than the card holds at once, so the look-back crosses waves
    nib = _card_nibbles(nblk, cuda, nblk % 31)
    gen = torch.Generator(device=cuda).manual_seed(nblk)
    base = torch.randint(-2**31, 2**31 - 1, (8,), generator=gen, device=cuda,
                         dtype=torch.int32)
    for b in (None, base):
        before = kernels.REC_BUILD.launches
        got = build_rec(nib, nblk, b)
        assert kernels.REC_BUILD.launches == before + 1
        torch.cuda.synchronize(cuda)
        assert torch.equal(got, build_rec_plain(nib, nblk, b))


@pytest.mark.parametrize("nblk", [700 + r for r in range(7)])
def test_walk_planes_build_kernel_every_remainder(cuda, nblk):
    # symbols 0..7 (6 and 7 in no mask) over every record count mod 7
    gen = torch.Generator(device=cuda).manual_seed(nblk)
    syms = torch.randint(0, 8, (nblk * 32,), generator=gen, device=cuda,
                         dtype=torch.uint8)
    blocks = syms.view(nblk, 32)
    rec = build_rec((blocks[:, :16] | (blocks[:, 16:] << 4)).reshape(-1),
                    nblk)
    before = kernels.WALK_PLANES_BUILD.launches
    got = build_walk_planes(rec)
    assert kernels.WALK_PLANES_BUILD.launches == before + 1
    assert torch.equal(got, build_walk_planes_plain(rec))


def test_rec_build_rejects_bad_inputs(cuda):
    nib = _card_nibbles(8, cuda, 1)
    with pytest.raises(ValueError):
        build_rec(nib.to(torch.int8), 8)                  # wrong dtype
    with pytest.raises(ValueError):
        build_rec(torch.cat([nib, nib])[::2], 8)          # not contiguous
    with pytest.raises(ValueError):
        build_rec(nib[1:129], 8)                          # not 16-B aligned
    with pytest.raises(ValueError):
        build_rec(nib, 9)                                 # a short buffer
    with pytest.raises(ValueError):
        rec_build(nib.cpu(), 8)                           # a CPU tensor
    with pytest.raises(ValueError):
        build_rec(nib, 8, torch.zeros(7, dtype=torch.int32))


def test_wrappers_reject_cpu_cuda_mix(cuda):
    idx = _index(1000, cuda)
    with pytest.raises(ValueError):
        streamed_probe(idx.rec, torch.zeros(4, dtype=torch.int32), idx.size)
    q = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        streamed_select(idx.rec, q, q.cpu(), idx.size)
    with pytest.raises(ValueError):
        streamed_select(idx.rec, q, q, idx.size, torch.arange(4))
    with pytest.raises(ValueError):
        streamed_select(idx.rec, q, torch.zeros(8, dtype=torch.int32,
                                                device=cuda)[::2], idx.size)


def test_blocked_walk_on_card_matches_cpu(cuda):
    # several read blocks: each block's pairs cross on a side stream into
    # pinned memory while the next block walks
    import numpy as np

    from bwtmerge_tpu_torch.ops.ra_stream import blocked_walk

    idx = _index(100_000, cuda)
    cpu = type(idx)(rec=idx.rec.cpu(), C=idx.C.cpu(), size=idx.size,
                    n_runs=0)
    rng = np.random.default_rng(6)
    creads = rng.integers(0, 6, size=(30, 5000)).astype(np.int8)
    a0 = int(idx.C[1])
    got = blocked_walk(idx, build_walk_planes(idx.rec), creads, 3,
                       a0).finish()
    want = blocked_walk(cpu, build_walk_planes(cpu.rec), creads, 3,
                        a0).finish()
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("shards", [2, 4])
def test_mesh_searches_on_card_match_cpu(cuda, shards):
    # meshes that repeat the card: every shard on its own stream, the walk
    # and the trie (streamed probes) launched once a shard or more
    import numpy as np

    from bwtmerge_tpu_torch.formats.sidecar import creads_layout
    from bwtmerge_tpu_torch.models.spill import RankArraySpill
    from bwtmerge_tpu_torch.parallel import mesh

    a, _ = _real_index(cuda, 2000, seed=11)
    b, b_reads = _real_index(cuda, 700, seed=12)
    a_cpu = type(a)(rec=a.rec.cpu(), C=a.C.cpu(), size=a.size, n_runs=0)
    b_cpu = type(b)(rec=b.rec.cpu(), C=b.C.cpu(), size=b.size, n_runs=0)
    n_a, n_b = int(a.C[1]), int(b.C[1])
    creads = creads_layout(np.array([r.size for r in b_reads], np.uint32),
                           np.concatenate(b_reads).astype(np.uint8))
    want = mesh.sharded_rank_array(a_cpu, b_cpu, n_a, n_b, mesh=["cpu"])
    kernels.reset_launches()
    walk = mesh.sharded_walk_packed_ra(a, creads, mesh=[cuda] * shards,
                                       a_sequences=n_a).finish()
    assert kernels.WALK_EMIT.launches == shards
    assert kernels.WALK_PLANES_BUILD.launches == 1
    trie = mesh.sharded_packed_ra(a, b, n_a, n_b, mesh=[cuda] * shards)
    assert kernels.STREAMED_PROBE.launches >= shards
    acc = RankArraySpill()
    mesh.dynamic_block_search(a, b, n_a, n_b, acc.emit, n_blocks=3 * shards,
                              mesh=[cuda] * shards)
    for got in (walk, trie.finish(), acc.finish()):
        assert all(np.array_equal(g, w) for g, w in zip(got, want[:2]))


def test_blocked_ra_drains_card_blocks(cuda, tmp_path):
    # past its budget a BlockedRA drains pinned blocks into spill files
    import numpy as np

    from bwtmerge_tpu_torch.models.spill import RankArraySpill
    from bwtmerge_tpu_torch.ops.ra_stream import BlockedRA

    rng = np.random.default_rng(2)
    parts = [np.unique(rng.integers(0, 10**6, size=n)) for n in
             (5000, 7000, 3000, 9000)]
    ra = BlockedRA(9000, lambda: RankArraySpill(temp_dir=str(tmp_path)))
    for v in parts:
        t = torch.from_numpy(v).to(cuda)
        ra.add(t, torch.ones_like(t))
    assert sum(len(b) for b in ra.blocks) <= 9000 and ra.n_spill_files
    v, c = ra.finish()
    want = np.unique(np.concatenate(parts), return_counts=True)
    assert np.array_equal(v, want[0]) and np.array_equal(c, want[1])


def _real_index(device, n_reads=3000, seed=8):
    """DeviceFMIndex of a real collection BWT: reads of 1..40 characters,
    a few of length 1, and one of 150 (past a 64-row cap)."""
    import numpy as np

    from bwtmerge_tpu_torch.models import oracle
    from bwtmerge_tpu_torch.ops.rank_torch import DeviceFMIndex

    rng = np.random.default_rng(seed)
    reads = oracle.random_collection(rng, n_reads, 1, 40)
    reads[7] = reads[7][:1]
    reads[n_reads // 2] = rng.integers(1, 6, size=150)
    runs = oracle.build_bwt(reads)
    return DeviceFMIndex.build(runs, runs.counts(6), device), reads


@pytest.mark.parametrize("lane0,width", [(0, 3000), (0, 1), (31, 33),
                                         (32, 500), (2990, 64)])
def test_decode_kernel_matches_plain(cuda, lane0, width):
    # lanes start at block offsets 0 and 31 among others; some lanes start
    # past the endmarker rows, and the long read outlives the 64-row cap
    idx, _ = _real_index(cuda)
    got = torch.zeros((64, width + 8), dtype=torch.int8, device=cuda)
    want = torch.zeros_like(got)
    before = kernels.launches()
    n_got = decode_creads_device(idx, got[:, 4:4 + width], lane0)
    assert kernels.DECODE.launches == before["decode"] + 1
    # no rows were given, so the wrapper built them
    assert (kernels.DECODE_ROWS_BUILD.launches
            == before["decode_rows_build"] + 1)
    rows = build_decode_rows(idx.rec)
    again = torch.zeros_like(got)
    decode_creads_device(idx, again[:, 4:4 + width], lane0, rows)
    assert torch.equal(again, got)
    n_want = decode_creads_plain(idx, want[:, 4:4 + width], lane0)
    assert torch.equal(got, want)
    assert int(n_got) == int(n_want)
    assert int(n_got) == (1 if lane0 <= 1500 < lane0 + width else 0)


@pytest.mark.parametrize("n_reads", [40, 1000, 3000])
def test_decode_over_kernel_rows_matches_plain(cuda, n_reads):
    # K3 over rows that decode_rows_build made, exact against the plain
    # decode, which reads the record table and not the rows
    idx, _ = _real_index(cuda, n_reads=n_reads, seed=n_reads)
    rows = build_decode_rows(idx.rec)
    assert torch.equal(rows, build_decode_rows_plain(idx.rec))
    got = torch.zeros((64, n_reads), dtype=torch.int8, device=cuda)
    want = torch.zeros_like(got)
    n_got = decode_creads_device(idx, got, 0, rows)
    n_want = decode_creads_plain(idx, want, 0)
    assert torch.equal(got, want)
    assert int(n_got) == int(n_want) == 1     # the read of 150 characters


def test_decode_kernel_recovers_the_reads(cuda):
    import numpy as np

    from bwtmerge_tpu_torch.formats.sidecar import creads_layout

    idx, reads = _real_index(cuda)
    got = decode_creads(idx, len(reads), idx.size, max_len_cap=1 << 14)
    lens = np.array([r.size for r in reads], np.uint32)
    want = creads_layout(lens, np.concatenate(reads).astype(np.uint8))
    np.testing.assert_array_equal(got, want)
    assert decode_creads(idx, len(reads), idx.size, max_len_cap=128) is None


@pytest.mark.parametrize("streamed", [True, False])
@pytest.mark.parametrize("blocks", [1, 3])
def test_trie_search_on_the_card_matches_numpy(cuda, streamed, blocks):
    # the trie search's steps on the card (the streamed ones launch K1 at
    # every depth) against the host search, on reads of mixed lengths
    import numpy as np

    import bwtmerge_tpu_torch as port
    from bwtmerge_tpu_torch.models import oracle
    from bwtmerge_tpu_torch.ops import search_np

    r = np.random.default_rng(5)
    a = port.FMI.from_runs(oracle.build_bwt(
        oracle.random_collection(r, 300, 1, 80)))
    b = port.FMI.from_runs(oracle.build_bwt(
        oracle.random_collection(r, 200, 1, 80)))
    want = search_np.build_rank_array(
        a.rank_index, a.alpha.C.astype(np.int64),
        b.rank_index, b.alpha.C.astype(np.int64),
        a.sequences(), b.sequences())
    before = kernels.STREAMED_PROBE.launches
    got = port.build_rank_array_torch(a, b, port.MergeConfig(device="cuda"),
                                      sequence_blocks=blocks,
                                      streamed=streamed)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    launched = kernels.STREAMED_PROBE.launches - before
    assert (launched >= 2 * 80) if streamed else (launched == 0)

"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These need a CUDA card and nvcc; without them every test skips, with its
reason.  On the card, where jax (imported by tests/conftest.py) is absent:
    python -m pytest --noconftest tests/test_torch_kernels.py
"""

import pytest
import torch

from bwtmerge_tpu_torch import kernels
from bwtmerge_tpu_torch.ops.rank_streamed import (streamed_probe,
                                                  streamed_probe_plain)
from bwtmerge_tpu_torch.ops.walk_torch import (build_cplanes, walk_emit,
                                               walk_emit_plain)
from chip_smoke import random_index

SENT = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _index(n_pos, device):
    return random_index(n_pos, device, seed=3)


@pytest.mark.parametrize("n_pos", [1, 31, 32, 1000, 1 << 20])
def test_probe_kernel_matches_plain(cuda, n_pos):
    idx = _index(n_pos, cuda)
    q = torch.sort(torch.randint(0, n_pos + 1, (5000,), device=cuda)).values
    q[-1] = n_pos
    q = torch.cat([q, torch.full((300,), SENT, device=cuda,
                                 dtype=q.dtype)]).to(torch.int32)
    before = kernels.STREAMED_PROBE.launches
    got = streamed_probe(idx.rec, q, idx.size)
    assert kernels.STREAMED_PROBE.launches == before + 1
    assert torch.equal(got, streamed_probe_plain(idx.rec, q, idx.size))


def test_probe_kernel_empty_and_all_sentinels(cuda):
    idx = _index(1000, cuda)
    before = kernels.STREAMED_PROBE.launches
    empty = streamed_probe(idx.rec, torch.zeros(0, dtype=torch.int32,
                                                device=cuda), idx.size)
    assert empty.shape == (16, 0)
    assert kernels.STREAMED_PROBE.launches == before     # nothing launched
    sent = streamed_probe(idx.rec, torch.full((777,), SENT, dtype=torch.int32,
                                              device=cuda), idx.size)
    assert not sent.any()


@pytest.mark.parametrize("shape", [(1, 1), (7, 300), (50, 1 << 16)])
def test_walk_kernel_matches_plain(cuda, shape):
    idx = _index(200_000, cuda)
    cpl = build_cplanes(idx.rec)
    gen = torch.Generator(device=cuda).manual_seed(5)
    creads = torch.randint(0, 6, shape, generator=gen,
                           device=cuda).to(torch.int8)
    a0 = int(idx.C[1])
    before = kernels.WALK_EMIT.launches
    e1, n1 = walk_emit(cpl, idx.C, creads, a0)
    assert kernels.WALK_EMIT.launches == before + 1
    e2, n2 = walk_emit_plain(cpl, idx.C, creads, a0)
    assert torch.equal(e1, e2) and int(n1) == int(n2)


def test_wrappers_reject_cpu_cuda_mix(cuda):
    idx = _index(1000, cuda)
    with pytest.raises(ValueError):
        streamed_probe(idx.rec, torch.zeros(4, dtype=torch.int32), idx.size)


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
    got = blocked_walk(idx, build_cplanes(idx.rec), creads, 3, a0).finish()
    want = blocked_walk(cpu, build_cplanes(cpu.rec), creads, 3, a0).finish()
    assert all(np.array_equal(g, w) for g, w in zip(got, want))

"""bwtmerge_tpu_torch — the PyTorch / CUDA port of bwtmerge_tpu.

A package of its own beside the JAX package `bwtmerge_tpu`, which stays the
reference: this package imports torch, never jax, and nothing of
`bwtmerge_tpu`.  It keeps its own copy of the host layers (formats/, the
native C++ codecs, interleave, spill and writers under native/, run arrays,
the spill merge, the host FM-index and the numpy reference merge) and holds
what runs on the device: the FM-index in torch tensors, the walk search,
the trie search and the k-way fold, on hand-written CUDA kernels for the
streamed-rank probe, the per-read walk and the read decode (csrc/, built
with nvcc at first use).

It covers, on one device: the two-input merge (walk or trie search, or the
host search into the spill ladder), the k-way fold, `-v` verification, BWT
construction from reads (ops/sa_torch.py, models/build.py, cli/bwt_build),
the device interleave and the range-parallel host interleave, and the
conversion and inspection CLIs; see ROADMAP.md for what is still to come.
"""


def _tune_host_allocator() -> None:
    """Keep freed large buffers in the malloc arena instead of munmapping.

    glibc's default policy (mmap every allocation over 128 KiB, munmap on
    free) makes each fresh numpy buffer of a streaming pipeline pay its
    first-touch page faults again.  Raising the mmap and trim thresholds
    makes the heap retain and reuse those pages."""
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:  # non-glibc platforms: default allocator behavior
        pass


def _disable_numpy_thp_madvise() -> None:
    """Stop numpy from madvise(MADV_HUGEPAGE)-ing large fresh buffers.

    With transparent hugepages in madvise mode an madvise'd region pays a
    synchronous hugepage compaction at every first touch.  The pipeline's
    buffers are RLE byte streams touched once, in order, so hugepages gain
    them nothing."""
    try:
        try:
            from numpy._core import multiarray as _ma  # numpy >= 2.0
        except ImportError:  # numpy 1.x
            from numpy.core import multiarray as _ma
        _ma._set_madvise_hugepage(False)
    except Exception:
        pass


_tune_host_allocator()
_disable_numpy_thp_madvise()

# The exports load on first use: the fold's subprocess stages
# (models/kfold_stage.py) import this package and must not pay for torch.
_EXPORTS = {
    "FMI": ".models.fmi",
    "load_fmi": ".models.fmi",
    "serialize_fmi": ".models.fmi",
    "MergeConfig": ".models.merge",
    "merge_fmi": ".models.merge",
    "merge_fmi_to_file": ".models.merge",
    "merge_files": ".models.merge",
    "merge_fmi_many": ".models.kfold",
    "merge_files_many": ".models.kfold",
    "build_rank_array_torch": ".ops.search_torch",
    "build_from_reads": ".models.build",
    "rlo_order": ".models.build",
    "rlo_reorder": ".models.build",
    "read_plain_reads": ".models.build",
    "read_plain_reads_packed": ".models.build",
    "suffix_array_device": ".ops.sa_torch",
    "build_bwt_device": ".ops.sa_torch",
    "rlo_order_device": ".ops.sa_torch",
    "interleave_torch": ".ops.interleave_torch",
    "interleave_stream_chunks_parallel": ".models.parallel_merge",
    "coalesce_run_chunks": ".parallel.distributed",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    import importlib

    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_EXPORTS[name], __name__), name)
    globals()[name] = value
    return value

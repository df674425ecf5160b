"""bwtmerge_tpu_torch — the PyTorch / CUDA port of bwtmerge_tpu.

The JAX package `bwtmerge_tpu` stays the reference; its host layers
(formats, native codecs and interleave, run arrays, spill merge) are
imported as they are.  This package holds what runs on the device: the
FM-index in torch tensors, and hand-written CUDA kernels for the
streamed-rank probe, the per-read walk and the read decode (csrc/, built
with nvcc at first use).  It imports torch and never jax.

Slices 1 and 2 cover the two-input merge and the k-way fold on one device,
with `-v` verification; see ROADMAP.md for the slices still to come.
"""

from .models.fmi import FMI, load_fmi, serialize_fmi
from .models.kfold import merge_files_many, merge_fmi_many
from .models.merge import (MergeConfig, merge_files, merge_fmi,
                           merge_fmi_to_file)

__all__ = [
    "FMI",
    "load_fmi",
    "serialize_fmi",
    "MergeConfig",
    "merge_fmi",
    "merge_fmi_to_file",
    "merge_files",
    "merge_fmi_many",
    "merge_files_many",
]

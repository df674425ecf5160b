"""FMI with a PyTorch device index.

The JAX package's FMI (bwtmerge_tpu/models/fmi.py) is reused for
everything on the host; its `device_index` property builds a JAX index, so
this subclass replaces it with a method that builds and caches the port's
index per torch device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from bwtmerge_tpu.formats import read_bwt
from bwtmerge_tpu.formats.sidecar import sidecar_path
from bwtmerge_tpu.models.fmi import FMI as _HostFMI
from bwtmerge_tpu.models.fmi import serialize_fmi

from ..kernels import resolve_device
from ..ops.rank_torch import DeviceFMIndex

__all__ = ["FMI", "load_fmi", "serialize_fmi"]


@dataclass
class FMI(_HostFMI):
    _torch: dict = field(default_factory=dict, repr=False, compare=False)

    def device_index(self, device="cuda") -> DeviceFMIndex:
        """The port's device index on `device`, built once per device."""
        dev = resolve_device(device)
        idx = self._torch.get(dev)
        if idx is None or idx.size != self.size():
            idx = DeviceFMIndex.build(self.runs, self.alpha.counts(), dev)
            self._torch[dev] = idx
        return idx

    def invalidate(self) -> None:
        super().invalidate()
        self._torch.clear()


def load_fmi(path: str, fmt: str = "native") -> FMI:
    """Load a BWT file in any registered format; the read-text sidecar path
    next to it is kept for the walk search."""
    runs, _counts, alpha = read_bwt(path, fmt)
    return FMI(runs=runs, alpha=alpha, creads_path=sidecar_path(path))

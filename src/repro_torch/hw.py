"""Hardware model of the target card: the NVIDIA H100 SXM (port of
``repro.hw``, which describes the reference's TPU).

Every roofline in ``repro_torch.analysis`` reads these constants. They are
data-sheet figures, not measurements: 989 TFLOP/s of dense bf16 on the
tensor cores, 3.35 TB/s of HBM3, 80 GB of it, 228 KiB of shared memory
per SM (the counterpart of the TPU's VMEM), 132 SMs. The reference's one
inter-chip link rate becomes two here:

- ``nvlink_bandwidth``: 450 GB/s per direction per card (NVLink 4, 900
  GB/s both ways), for the collectives of a group that lies on the
  ``model`` axis: ``launch/mesh.py`` keeps tensor parallelism inside one
  8-card node;
- ``network_bandwidth``: 50 GB/s per card (one 400 Gb/s NIC per card), for
  a group on ``data`` or ``pod``, which crosses nodes.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ChipSpec", "H100_SXM"]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float     # FLOP/s, dense
    hbm_bandwidth: float       # bytes/s
    hbm_bytes: int             # capacity
    nvlink_bandwidth: float    # bytes/s per card, per direction, in a node
    network_bandwidth: float   # bytes/s per card, across nodes
    smem_per_sm: int           # on-chip shared memory per SM
    n_sms: int

    @property
    def arithmetic_intensity_knee(self) -> float:
        """FLOP/byte at which a kernel moves from memory- to compute-bound."""
        return self.peak_flops_bf16 / self.hbm_bandwidth

    def link_bandwidth(self, axes) -> float:
        """The rate of a collective over the mesh axes ``axes``: NVLink where
        the group lies on ``model`` alone, the node's network otherwise."""
        axes = tuple(axes or ())
        return (self.nvlink_bandwidth if axes and set(axes) <= {"model"}
                else self.network_bandwidth)


H100_SXM = ChipSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    hbm_bandwidth=3.35e12,
    hbm_bytes=80 * 10**9,
    nvlink_bandwidth=450e9,
    network_bandwidth=50e9,
    smem_per_sm=228 * 1024,
    n_sms=132,
)

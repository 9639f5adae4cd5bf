"""Low-rank utilities: energy spectra, rank selection, and the paper's IO
model.

Port of ``repro.core.lowrank``: the measurement side of Theorems 3.1/3.2
and Corollaries 3.3/3.7. Given a dense bias matrix, its singular-value
energy profile, the rank that keeps a target share of that energy, and the
storage / HBM-access model behind FlashBias' speedup.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["energy_profile", "rank_for_energy", "retained_energy",
           "optimal_storage_bytes", "IOModel"]


def energy_profile(mat: torch.Tensor) -> torch.Tensor:
    """Cumulative singular-value energy share of a (batched) matrix.

    The energy of rank r is ``sum_{i<=r} s_i^2 / sum_i s_i^2`` (Remark
    3.8). Returns ``(..., min(N, M))``, monotone, in (0, 1] (all 0 for a
    zero matrix)."""
    s = torch.linalg.svdvals(mat.float())
    e = torch.cumsum(s ** 2, dim=-1)
    total = e[..., -1:]
    return e / torch.where(total == 0, 1.0, total)


def _flat_profile(mat: torch.Tensor) -> torch.Tensor:
    prof = energy_profile(mat)
    return prof.reshape(-1, prof.shape[-1])


def rank_for_energy(mat: torch.Tensor, energy: float = 0.99) -> int:
    """Smallest rank keeping ``energy`` of the squared singular values, the
    largest over a batch, never more than ``min(N, M)`` (a zero matrix,
    whose profile never reaches ``energy``, gets that)."""
    flat = _flat_profile(mat)
    ranks = ((flat < energy).sum(dim=-1) + 1).clamp(max=flat.shape[-1])
    return int(ranks.max())


def retained_energy(mat: torch.Tensor, rank: int) -> float:
    """Energy share the best rank-``rank`` approximation keeps, the least
    over a batch; ``rank <= 0`` keeps nothing."""
    if rank <= 0:
        return 0.0
    flat = _flat_profile(mat)
    return float(flat[:, min(rank, flat.shape[-1]) - 1].min())


def optimal_storage_bytes(n: int, rank: int, itemsize: int = 2) -> int:
    """Theorem 3.2: an N x N rank-R matrix needs ``2NR - R^2`` scalars."""
    return (2 * n * rank - rank * rank) * itemsize


@dataclasses.dataclass(frozen=True)
class IOModel:
    """HBM-access model of the paper, per head and batch element, in
    scalar elements (times the itemsize for bytes); ``sram`` is the
    on-chip memory in elements too."""

    n: int       # query length
    m: int       # key length
    c: int       # head channel dim
    rank: int    # bias rank R
    sram: int    # on-chip memory S, in elements

    def standard_attention(self) -> float:
        """Theta(NC + N^2): the logits go through HBM (Eq. 6)."""
        return self.n * self.c + self.n * self.m

    def flashattention(self) -> float:
        """Theta(N M C^2 / S): FlashAttention without bias (Eq. 6)."""
        return self.n * self.m * self.c ** 2 / self.sram

    def flashattention_with_bias(self) -> float:
        """Theta(N M C^2 / S + N M): the dense bias streams (Ex. 3.9)."""
        return self.flashattention() + self.n * self.m

    def flashbias(self) -> float:
        """Cor. 3.7: Theta(N M (C^2 + R^2) / S), factors ride with q/k."""
        return self.n * self.m * (self.c ** 2 + self.rank ** 2) / self.sram

    def flashbias_multiplicative(self) -> float:
        """App. I: Theta(N M C^2 R^2 / S), the channel-expansion form."""
        return self.n * self.m * self.c ** 2 * self.rank ** 2 / self.sram

    def multiplicative_worthwhile(self) -> bool:
        """App. I Cor. I.2: worthwhile iff R <= sqrt(S / C^2 + 1)."""
        return self.rank <= math.sqrt(self.sram / self.c ** 2 + 1)

    def speedup_over_dense_bias(self) -> float:
        """Predicted HBM-access ratio (Ex. 3.9: ~6x at C = R = 64, S =
        100 KB)."""
        return self.flashattention_with_bias() / self.flashbias()

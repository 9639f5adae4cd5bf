"""Truncated-SVD factors of a dense attention bias (Table 1, row b).

Port of ``repro.core.decomp.svd_factors`` at a given rank, the form the
Pairformer serve path calls. The energy-based rank choice and the neural
decomposition fit wait for the training slice (ROADMAP.md Queue A item 9).

SVD factors are unique only up to sign, and up to rotation inside
near-tied singular values: compare ``phi_q @ phi_k^T``, never the factors.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["svd_factors"]


def svd_factors(table: torch.Tensor,
                rank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-``rank`` factors of a (batched) dense bias table.

    table: ``(..., N, M)``. Returns ``phi_q (..., N, R)`` and ``phi_k (...,
    M, R)`` in float32 with ``phi_q @ phi_k^T`` the best rank-R
    approximation (Eckart-Young), ``R = min(rank, N, M)``. The singular
    values are split evenly (square root) between the two factors, which
    keeps their magnitudes balanced for the kernels downstream.

    A matrix holding NaN or Inf gets NaN factors, as the reference's SVD
    gives (``torch.linalg.svd`` would raise instead): the serve engine's
    admission guard then sees them. The check stays on the device."""
    mat = table.float()
    finite = torch.isfinite(mat)
    u, s, vh = torch.linalg.svd(torch.where(finite, mat, 0.0),
                                full_matrices=False)
    r = int(min(rank, s.shape[-1]))
    sq = torch.sqrt(s[..., :r])
    phi_q = u[..., :, :r] * sq[..., None, :]
    phi_k = vh[..., :r, :].transpose(-1, -2) * sq[..., None, :]
    bad = ~finite.flatten(-2).all(dim=-1)[..., None, None]
    nan = torch.full((), float("nan"), device=mat.device)
    return torch.where(bad, nan, phi_q), torch.where(bad, nan, phi_k)

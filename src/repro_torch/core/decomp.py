"""Truncated-SVD factors of a dense attention bias (Table 1, row b).

Port of ``repro.core.decomp.svd_factors`` at a given rank (the form the
Pairformer serve path and ``swin.svd_factorize`` call) and of
``reconstruction_error``. The energy-based rank choice and the neural
decomposition fit wait for the training slice (ROADMAP.md Queue A item 9).

SVD factors are unique only up to sign, and up to rotation inside
near-tied singular values: compare ``phi_q @ phi_k^T``, never the factors.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["svd_factors", "reconstruction_error"]


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


def reconstruction_error(table: torch.Tensor, phi_q: torch.Tensor,
                         phi_k: torch.Tensor) -> float:
    """Relative Frobenius error of ``phi_q @ phi_k^T`` against ``table``."""
    approx = phi_q @ phi_k.transpose(-1, -2)
    num = torch.linalg.vector_norm((approx - table).flatten())
    den = torch.linalg.vector_norm(table.flatten())
    return float(num / den.clamp(min=1e-30))

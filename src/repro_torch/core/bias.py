"""ALiBi, the paper's rank-2 exact bias factorization (Example 3.4).

``alibi_slopes`` gives the per-head slopes, ``alibi_factors`` the factor
pair ``phi_q (H, N, 2)``, ``phi_k (M, 2)`` with ``phi_q @ phi_k.T =
slope_h * (j' - i')``, and ``alibi_dense`` the materialized ``(H, N, M)``
bias that serves as the oracle. Same conventions as ``repro.core.bias``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["alibi_slopes", "alibi_factors", "alibi_dense"]


def alibi_slopes(num_heads: int, *, device=None) -> torch.Tensor:
    """Geometric slope sequence from the ALiBi paper (Press et al., 2022).

    For ``num_heads`` a power of two the slopes are ``2^(-8h/num_heads)``;
    otherwise the published interleaving fallback is used.
    """
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        vals = pow2_slopes(num_heads)
    else:
        closest = 2 ** math.floor(math.log2(num_heads))
        vals = pow2_slopes(closest)
        vals = vals + pow2_slopes(2 * closest)[0::2][: num_heads - closest]
    return torch.tensor(vals, dtype=torch.float32, device=device)


def alibi_factors(n: int, m: int, num_heads: int, *, dtype=torch.float32,
                  q_offset: int = 0, k_offset: int = 0, device=None):
    """Exact rank-2 factorization of the ALiBi bias.

    ``phi_q[h, i] = slope_h * [-i', 1]``, ``phi_k[j] = [1, j']`` with
    ``i' = i + q_offset``, ``j' = j + k_offset``, so that
    ``phi_q @ phi_k.T = slope_h * (j' - i')``.
    Returns ``(phi_q (H, N, 2), phi_k (M, 2))``.
    """
    slopes = alibi_slopes(num_heads, device=device).to(dtype)
    qi = torch.arange(n, dtype=dtype, device=device) + q_offset
    kj = torch.arange(m, dtype=dtype, device=device) + k_offset
    phi_q = torch.stack([-qi, torch.ones_like(qi)], dim=-1)     # (N, 2)
    phi_q = slopes[:, None, None] * phi_q[None]                 # (H, N, 2)
    phi_k = torch.stack([torch.ones_like(kj), kj], dim=-1)      # (M, 2)
    return phi_q, phi_k


def alibi_dense(n: int, m: int, num_heads: int, *, dtype=torch.float32,
                q_offset: int = 0, k_offset: int = 0,
                device=None) -> torch.Tensor:
    """Dense ALiBi bias ``(H, N, M)`` — the baseline / oracle."""
    slopes = alibi_slopes(num_heads, device=device).to(dtype)
    qi = torch.arange(n, dtype=dtype, device=device)[:, None] + q_offset
    kj = torch.arange(m, dtype=dtype, device=device)[None, :] + k_offset
    return slopes[:, None, None] * (kj - qi)[None]

"""Attention-bias taxonomy and the paper's exact low-rank factorizations.

A dense bias ``b = f(x_q, x_k) (N, M)`` is replaced by two factor tensors
``phi_q (N, R)``, ``phi_k (M, R)`` with ``b = phi_q @ phi_k.T`` (Sec. 3.2).
Each ``*_factors`` has its ``*_dense`` oracle:

- ALiBi (Example 3.4): ``slope_h * (j - i)``, rank 2;
- squared spatial distance (Example 3.5): ``+-||x_i - x_j||^2``, rank 3d;
- learnable-scaled distance (Sec. 4.4, the PDE solver):
  ``alpha_i * ||x_i - x_j||^2``, alpha folded into ``phi_q``, rank 3d;
- multiplicative ``cos(i - j)`` (App. I Example I.1), rank 2.

``broadcast_factors`` brings a factor to the ``(B, S, H, R)`` layout the
attention paths take. Same conventions as ``repro.core.bias``; ``BiasSpec``
is its declarative description of a bias.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["BiasSpec", "alibi_slopes", "alibi_factors", "alibi_dense",
           "sqdist_factors", "sqdist_dense", "scaled_sqdist_factors",
           "scaled_sqdist_dense", "cos_relpos_factors", "cos_relpos_dense",
           "broadcast_factors"]


@dataclasses.dataclass(frozen=True)
class BiasSpec:
    """Declarative description of an attention bias, resolved by the model.

    kind: "none" | "alibi" (exact, R=2) | "sqdist" (exact, R=3d) | "svd"
    (offline factors of a learnable table, rank ``rank``) | "neural"
    (token-wise factor MLPs) | "dense" (the materialized N x M bias).
    mode: "flashbias" (factors, Eq. 3) | "dense" (materialize and add to
    the logits: the paper's baseline)."""

    kind: str = "none"
    mode: str = "flashbias"
    rank: int = 0
    coord_dim: int = 3      # for sqdist
    negate: bool = True     # biases are usually penalties: b = -f(...)

    def __post_init__(self):
        if self.kind not in ("none", "alibi", "sqdist", "svd", "neural",
                             "dense"):
            raise ValueError(f"bias kind {self.kind!r}")
        if self.mode not in ("flashbias", "dense"):
            raise ValueError(f"bias mode {self.mode!r}")

    @property
    def effective_rank(self) -> int:
        if self.kind == "alibi":
            return 2
        if self.kind == "sqdist":
            return 3 * self.coord_dim
        return self.rank


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


def sqdist_factors(x_q: torch.Tensor, x_k: torch.Tensor, *,
                   negate: bool = True):
    """Exact rank-3d factorization of ``+-||x_q_i - x_k_j||^2``.

    x_q ``(..., N, d)``, x_k ``(..., M, d)``. Each coordinate contributes
    ``phi_q = [x^2, 1, -2x]``, ``phi_k = [1, x^2, x]`` (Eq. 4), so that
    ``phi_q . phi_k = (x_i - x_j)^2``. Returns ``(phi_q (..., N, 3d), phi_k
    (..., M, 3d))``, the sign on ``phi_q``."""
    sign = -1.0 if negate else 1.0
    fq = torch.stack([x_q * x_q, torch.ones_like(x_q), -2.0 * x_q], dim=-1)
    fk = torch.stack([torch.ones_like(x_k), x_k * x_k, x_k], dim=-1)
    return sign * fq.flatten(-2), fk.flatten(-2)


def sqdist_dense(x_q: torch.Tensor, x_k: torch.Tensor, *,
                 negate: bool = True) -> torch.Tensor:
    """Dense squared-distance bias ``(..., N, M)``: the oracle."""
    d2 = ((x_q[..., :, None, :] - x_k[..., None, :, :]) ** 2).sum(dim=-1)
    return -d2 if negate else d2


def scaled_sqdist_factors(x_q: torch.Tensor, x_k: torch.Tensor,
                          alpha: torch.Tensor, *, negate: bool = True):
    """``alpha_i * ||x_i - x_j||^2`` with a per-query ``alpha`` broadcasting
    against the query axis (``(..., N)``): the scale folds into ``phi_q``,
    so the rank stays 3d and the factorization exact."""
    phi_q, phi_k = sqdist_factors(x_q, x_k, negate=negate)
    return alpha[..., None] * phi_q, phi_k


def scaled_sqdist_dense(x_q: torch.Tensor, x_k: torch.Tensor,
                        alpha: torch.Tensor, *,
                        negate: bool = True) -> torch.Tensor:
    return alpha[..., None] * sqdist_dense(x_q, x_k, negate=negate)


def cos_relpos_factors(n: int, m: int, *, dtype=torch.float32, device=None):
    """``b[i, j] = cos(i - j) = cos i cos j + sin i sin j``, rank 2."""
    qi = torch.arange(n, dtype=dtype, device=device)
    kj = torch.arange(m, dtype=dtype, device=device)
    return (torch.stack([torch.cos(qi), torch.sin(qi)], dim=-1),
            torch.stack([torch.cos(kj), torch.sin(kj)], dim=-1))


def cos_relpos_dense(n: int, m: int, *, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    qi = torch.arange(n, dtype=dtype, device=device)[:, None]
    kj = torch.arange(m, dtype=dtype, device=device)[None, :]
    return torch.cos(qi - kj)


def broadcast_factors(phi: torch.Tensor, batch: int, seq: int,
                      heads: int) -> torch.Tensor:
    """A factor broadcast (a view, no copy) to ``(B, S, H, R)``.

    Takes ``(S, R)`` (shared by batch and heads), ``(H, S, R)`` (per head:
    a 3-D factor means this alone, and its leading dim must be ``heads``)
    or ``(B|1, S, H|1, R)``. Batch factors come as explicit 4-D."""
    if phi.ndim == 2:
        phi = phi[None, :, None, :]
    elif phi.ndim == 3:
        if phi.shape[0] != heads:
            raise ValueError(
                f"3-D factor leading dim {phi.shape[0]} != heads {heads}: a "
                f"3-D factor means per-head (H, S, R); pass batch factors as "
                f"explicit 4-D (B, S, 1, R) or (B, S, H, R)")
        phi = phi.transpose(0, 1)[None]
    elif phi.ndim != 4:
        raise ValueError(f"factor rank {phi.ndim} not in (2, 3, 4)")
    return phi.expand(batch, seq, heads, phi.shape[-1])

"""Naive float32 oracles for the attention kernels (port of
``repro.kernels.ref``): dense logits, dense softmax, no chunking.

Layout: q (B, N, H, D); k, v (B, M, K, D) with H % K == 0 (GQA).
Factors phi_q (B, N, H, R); phi_k (B, M, H|1, R). Dense bias (B|1, H, N, M).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.attention import DEFAULT_MASK_VALUE

__all__ = ["mha_reference", "decode_reference"]


def _expand_kv(x: torch.Tensor, h: int) -> torch.Tensor:
    """(B, M, K, D) -> (B, M, H, D) repeating each kv head over its group."""
    kvh = x.shape[2]
    return x if kvh == h else torch.repeat_interleave(x, h // kvh, dim=2)


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    phi_q: Optional[torch.Tensor] = None,
    phi_k: Optional[torch.Tensor] = None,
    mask_kind: str = "none",
    window: int = 0,
    q_offset: int = 0,
    kv_length: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense-softmax oracle for (FlashBias) attention. Returns (B, N, H, Dv)."""
    b, n, h, d = q.shape
    m = k.shape[1]
    scale = (1.0 / float(np.sqrt(d))) if scale is None else scale
    kf = _expand_kv(k, h).float()
    vf = _expand_kv(v, h).float()
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), kf) * scale
    if phi_q is not None:
        pk = phi_k.expand(b, m, h, phi_k.shape[-1])
        s = s + torch.einsum("bnhr,bmhr->bhnm", phi_q.float(), pk.float())
    if bias is not None:
        s = s + (bias if bias.ndim == 4 else bias[None]).float()
    q_pos = torch.arange(n, device=q.device) + q_offset
    k_pos = torch.arange(m, device=q.device)
    allowed = torch.ones((n, m), dtype=torch.bool, device=q.device)
    if mask_kind in ("causal", "local"):
        allowed &= q_pos[:, None] >= k_pos[None, :]
    if mask_kind == "local":
        allowed &= (q_pos[:, None] - k_pos[None, :]) < window
    if kv_length is not None:
        allowed &= (k_pos < kv_length)[None, :]
    s = torch.where(allowed[None, None], s,
                    torch.full_like(s, DEFAULT_MASK_VALUE))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, vf).to(q.dtype)


def decode_reference(
    q: torch.Tensor,            # (B, 1, H, D) — one new token
    k_cache: torch.Tensor,      # (B, S, K, D)
    v_cache: torch.Tensor,      # (B, S, K, Dv)
    lengths: torch.Tensor,      # (B,) int — valid cache entries per request
    *,
    phi_q: Optional[torch.Tensor] = None,   # (B, 1, H, R)
    phi_k: Optional[torch.Tensor] = None,   # (B, S, H|1, R)
    slopes: Optional[torch.Tensor] = None,  # (H,) ALiBi slopes
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode oracle. The query sits at position lengths[b]-1."""
    b, _, h, d = q.shape
    s_len = k_cache.shape[1]
    scale = (1.0 / float(np.sqrt(d))) if scale is None else scale
    kf = _expand_kv(k_cache, h).float()
    vf = _expand_kv(v_cache, h).float()
    s = torch.einsum("bhd,bmhd->bhm", q[:, 0].float(), kf) * scale
    if phi_q is not None:
        pk = phi_k.expand(b, s_len, h, phi_k.shape[-1])
        s = s + torch.einsum("bhr,bmhr->bhm", phi_q[:, 0].float(), pk.float())
    k_pos = torch.arange(s_len, device=q.device)
    if slopes is not None:
        rel = (k_pos[None, :] - (lengths - 1)[:, None]).float()   # (B, S)
        s = s + slopes.float()[None, :, None] * rel[:, None, :]
    allowed = k_pos[None, :] < lengths[:, None]                    # (B, S)
    s = torch.where(allowed[:, None, :], s,
                    torch.full_like(s, DEFAULT_MASK_VALUE))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhm,bmhd->bhd", p, vf)[:, None].to(q.dtype)

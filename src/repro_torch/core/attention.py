"""Attention with additive bias: dense and chunked online-softmax paths.

The port's counterpart of ``repro.core.attention``: the plain versions of
the kernels, the Eq. 3 concat form ``flashbias_concat_qk`` and the App. I
multiplicative form ``multiplicative_flashbias_attention``. Layouts follow
the reference (MaxText convention): q ``(B, N, H, D)``; k, v ``(B, M, K,
D)`` with ``H % K == 0`` (GQA); factors ``phi_q (B, N, H, R)``, ``phi_k
(B, M, H|1, R)``; dense bias ``(B|1, H, N, M)``. Masks are computed from
positions, never read.

Masked logits take ``DEFAULT_MASK_VALUE`` (a large finite negative, as in
the TPU kernels), not ``-inf``, and a row whose online-softmax sum stays 0
outputs 0.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

__all__ = ["MaskSpec", "attention", "flashbias_concat_qk", "eq3_folds",
           "multiplicative_flashbias_attention", "DEFAULT_MASK_VALUE"]

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """kind: "none" | "causal" | "local" (causal sliding window of ``window``)."""
    kind: str = "none"
    window: int = 0

    def __post_init__(self):
        if self.kind not in ("none", "causal", "local"):
            raise ValueError(f"mask kind {self.kind!r}")
        if self.kind == "local" and self.window <= 0:
            raise ValueError("a local mask needs window > 0")

    def block_mask(self, q_pos: torch.Tensor,
                   k_pos: torch.Tensor) -> Optional[torch.Tensor]:
        """Allowed-matrix ``(..., N, M)`` for positions; None = all allowed."""
        if self.kind == "none":
            return None
        diff = q_pos[..., :, None] - k_pos[..., None, :]        # i - j
        allowed = diff >= 0
        if self.kind == "local":
            allowed = allowed & (diff < self.window)
        return allowed


def _split_gqa(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B, S, H, E) -> (B, S, K, G, E) grouping q-heads under their kv head."""
    b, s, h, e = x.shape
    if h == kv_heads:
        return x[:, :, :, None, :]
    if h == 1:
        return x[:, :, :, None, :].expand(b, s, kv_heads, 1, e)
    if h % kv_heads:
        raise ValueError(f"{h} heads do not group over {kv_heads} kv heads")
    return x.reshape(b, s, kv_heads, h // kv_heads, e)


def _q_positions(n: int, q_offset, batch: int, device) -> torch.Tensor:
    off = torch.as_tensor(q_offset, device=device).reshape(-1)
    off = off.expand(batch) if off.numel() == 1 else off
    return torch.arange(n, device=device)[None, :] + off[:, None]  # (B, N)


def eq3_folds(q: torch.Tensor, phi_q: torch.Tensor, phi_k: torch.Tensor,
              phi_heads: int, kv_heads: int) -> bool:
    """Whether the Eq. 3 concat fold costs no precision, the reference's
    condition: the key factor lives per kv head (``phi_heads``, its head
    count, is 1 or ``kv_heads``) and promoting the factors to q's dtype
    loses nothing (float32 factors against a bf16 q, mixed-precision ALiBi,
    would quantize positions to bf16: that path keeps two products)."""
    dt = torch.promote_types(torch.promote_types(phi_q.dtype, phi_k.dtype),
                             q.dtype)
    return phi_heads in (1, kv_heads) and dt == q.dtype


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: MaskSpec = MaskSpec("none"),
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    phi_q: Optional[torch.Tensor] = None,
    phi_k: Optional[torch.Tensor] = None,
    q_offset: Union[int, torch.Tensor] = 0,
    kv_length: Optional[Union[int, torch.Tensor]] = None,
    impl: str = "chunked",
    chunk_size: int = 512,
) -> torch.Tensor:
    """``softmax(q k^T * scale + b + mask) v`` with ``b`` the dense ``bias``,
    the factored ``phi_q @ phi_k^T`` (FlashBias), or both.

    q_offset: absolute position of ``q[:, 0]`` (scalar or (B,)).
    kv_length: valid cache entries (scalar or (B,)); keys at positions
    ``>= kv_length`` are masked. Logits and softmax run in float32.

    Factors fold into q and k (Eq. 3, ``flashbias_concat_qk``: one product
    of depth D + R) where ``eq3_folds`` says it is exact, as the
    reference's plain attention does; elsewhere the factor product is a
    second einsum.
    """
    if impl not in ("dense", "chunked"):
        raise ValueError(f"attention impl {impl!r}")
    b, n, h, d = q.shape
    m, kvh = k.shape[1], k.shape[2]
    scale = (1.0 / float(np.sqrt(d))) if scale is None else scale
    if phi_q is not None and eq3_folds(q, phi_q, phi_k, phi_k.shape[2], kvh):
        q, k = flashbias_concat_qk(q, k, phi_q, phi_k, scale)
        phi_q = phi_k = None
    q5 = _split_gqa(q, kvh).float()                          # (B,N,K,G,D)
    g = q5.shape[3]
    phi_q5 = phi_k5 = None
    if phi_q is not None:
        r = phi_q.shape[-1]
        phi_q5 = _split_gqa(phi_q, kvh).float()
        phi_k5 = _split_gqa(phi_k.expand(b, m, h, r), kvh).float()
    bias4 = None
    if bias is not None:
        bias4 = (bias if bias.ndim == 4 else bias[None]).float()
    q_pos = _q_positions(n, q_offset, b, q.device)
    if kv_length is not None:
        kv_length = torch.as_tensor(kv_length, device=q.device).reshape(-1, 1)

    def logits(lo, hi):
        k_pos = torch.arange(lo, hi, device=q.device)
        s = torch.einsum("bnkgd,bmkd->bkgnm", q5,
                         k[:, lo:hi].float()) * scale
        if phi_q5 is not None:
            s = s + torch.einsum("bnkgr,bmkgr->bkgnm", phi_q5,
                                 phi_k5[:, lo:hi])
        if bias4 is not None:
            bb = bias4[..., lo:hi]
            s = s + bb.reshape(bb.shape[0], kvh, g, n, hi - lo)
        allowed = mask.block_mask(q_pos, k_pos)              # (B, N, Mc)
        if kv_length is not None:
            in_range = (k_pos[None, :] < kv_length)[:, None, :]
            allowed = in_range if allowed is None else allowed & in_range
        if allowed is not None:
            s = torch.where(allowed[:, None, None], s,
                            torch.full_like(s, DEFAULT_MASK_VALUE))
        return s                                             # (B,K,G,N,Mc)

    if impl == "dense" or m <= chunk_size:
        p = torch.softmax(logits(0, m), dim=-1)
        o = torch.einsum("bkgnm,bmkd->bnkgd", p, v.float())
        return o.reshape(b, n, h, v.shape[-1]).to(q.dtype)

    m_i = torch.full((b, kvh, g, n), -torch.inf, device=q.device)
    l_i = torch.zeros((b, kvh, g, n), device=q.device)
    acc = torch.zeros((b, kvh, g, n, v.shape[-1]), device=q.device)
    for lo in range(0, m, chunk_size):
        hi = min(lo + chunk_size, m)
        s = logits(lo, hi)
        m_new = torch.maximum(m_i, s.amax(dim=-1))
        corr = torch.exp(m_i - m_new)
        p = torch.exp(s - m_new[..., None])
        l_i = l_i * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgnm,bmkd->bkgnd", p, v[:, lo:hi].float())
        m_i = m_new
    o = acc / torch.where(l_i == 0, 1.0, l_i)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, n, h, -1).to(q.dtype)


def flashbias_concat_qk(q: torch.Tensor, k: torch.Tensor, phi_q: torch.Tensor,
                        phi_k: torch.Tensor, scale: Optional[float] = None):
    """``(q', k')`` of Eq. 3: ``softmax(q' k'^T * scale) == softmax(q k^T *
    scale + phi_q phi_k^T)`` with ``q' = [q | phi_q / scale]``, ``k' = [k |
    phi_k]``.

    q ``(B, N, H, D)``, k ``(B, M, Hk, D)``, ``phi_q (B, N, H, R)``,
    ``phi_k (B|1, M, 1|Hk, R)``: the key factor lives per kv head, so its
    head dim must be 1 or Hk."""
    b, n, h, d = q.shape
    hk = k.shape[2]
    scale = (1.0 / float(np.sqrt(d))) if scale is None else scale
    if phi_k.shape[2] not in (1, hk):
        raise ValueError(f"phi_k head dim {phi_k.shape[2]} incompatible "
                         f"with {hk} kv heads")
    phi_k = phi_k.expand(b, k.shape[1], hk, phi_k.shape[-1])
    q_aug = torch.cat([q, (phi_q / scale).to(q.dtype)], dim=-1)
    k_aug = torch.cat([k, phi_k.to(k.dtype)], dim=-1)
    return q_aug, k_aug


def multiplicative_flashbias_attention(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        phi_q: torch.Tensor, phi_k: torch.Tensor, *,
        mask: MaskSpec = MaskSpec("none"),
        scale: Optional[float] = None) -> torch.Tensor:
    """``softmax((q k^T * scale) * b) v`` with ``b = phi_q phi_k^T`` of rank
    R (App. I, Eq. 17): q and k expand channel-wise to ``C * R``,
    ``q' = [q * phi_q_1, ..., q * phi_q_R]``, so that ``q' k'^T = (q k^T) *
    b``. Factors broadcast to ``(B, S, H, R)``."""
    b, n, h, d = q.shape
    m = k.shape[1]
    scale = (1.0 / float(np.sqrt(d))) if scale is None else scale
    r = phi_q.shape[-1]
    phi_q = phi_q.expand(b, n, h, r)
    phi_k = phi_k.expand(b, m, h, r)
    q_exp = (q[..., None, :] * phi_q[..., :, None]).reshape(b, n, h, r * d)
    k_exp = (k[..., None, :] * phi_k[..., :, None]).reshape(b, m, h, r * d)
    return attention(q_exp, k_exp, v, mask=mask, scale=scale, impl="dense")

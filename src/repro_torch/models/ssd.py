"""Mamba2 SSD (state-space duality): the chunked scan and the decode step,
in plain PyTorch (port of ``repro.models.ssd``).

The sequence is split into chunks of length Q. Within a chunk the output
is the quadratic "1-semiseparable attention" form; across chunks a linear
recurrence carries the ``(H, P, N)`` state (Dao & Gu, arXiv:2405.21060).
There are no q k^T logits here, so FlashBias does not apply to this
family.

Layout: x ``(B, S, H, P)`` heads / head dim; b, c ``(B, S, N)`` (one
group); dt ``(B, S, H)``; a ``(H,)`` negative decay rates; state h
``(B, H, P, N)``.

This is the ``"torch"`` implementation that ``kernels.ops.ssd_scan``
dispatches to; the kernel path (``kernels/ssd_scan.py``) computes the same
``(y, h_fin)``, and the kernel's plain version is this scan on the
kernel's layout.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["ssd_scan", "ssd_decode_step"]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 256,
             h0: Optional[torch.Tensor] = None):
    """Chunked SSD forward, the reference's algorithm step for step.

    x: (B, S, H, P); dt: (B, S, H) (already softplus'd, > 0); a: (H,) < 0;
    b, c: (B, S, N). Returns (y (B, S, H, P), h_final (B, H, P, N)).
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = x.shape[1] // q

    xc = x.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h)
    bc = b.reshape(bsz, nc, q, n)
    cc = c.reshape(bsz, nc, q, n)

    dta = dtc * a[None, None, None, :]                  # (B,nc,Q,H) <= 0
    cum = torch.cumsum(dta, dim=2)                      # inclusive
    # intra-chunk: y_i += sum_{j<=i} (c_i . b_j) exp(cum_i - cum_j) dt_j x_j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                        torch.zeros((), dtype=seg.dtype, device=x.device))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)         # (B,nc,Qi,Qj)
    w = cb[..., None] * decay * dtc[:, :, None, :, :]    # (B,nc,Qi,Qj,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)

    # chunk summaries: state_c = sum_j exp(cum_last - cum_j) dt_j b_j (x) x_j
    last = cum[:, :, -1:, :]                             # (B,nc,1,H)
    sdec = torch.exp(last - cum)                         # (B,nc,Q,H)
    states = torch.einsum("bcqh,bcqhp,bcqn->bchpn", sdec * dtc, xc, bc)
    chunk_decay = torch.exp(last[:, :, 0, :])            # (B,nc,H)

    # inter-chunk recurrence, sequential over chunks; the state BEFORE each
    # chunk is kept for that chunk's output
    hstate = (torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
              if h0 is None else h0)
    h_prevs = []
    for j in range(nc):
        h_prevs.append(hstate)
        hstate = hstate * chunk_decay[:, j, :, None, None] + states[:, j]
    h_prevs = torch.stack(h_prevs, dim=1)                # (B,nc,H,P,N)

    # inter-chunk output: y_i += (c_i . h_prev) decayed to position i
    y_inter = torch.einsum("bcqh,bcqn,bchpn->bcqhp", torch.exp(cum), cc,
                           h_prevs)
    y = (y_intra + y_inter).reshape(bsz, nc * q, h, p)
    return y[:, :s], hstate


def ssd_decode_step(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """One-token SSD update.

    h: (B, H, P, N) state; x: (B, H, P); dt: (B, H); b, c: (B, N).
    Returns (y (B, H, P), h_new).
    """
    da = torch.exp(dt * a[None, :])                      # (B,H)
    dbx = torch.einsum("bh,bhp,bn->bhpn", dt, x, b)
    h_new = h * da[:, :, None, None] + dbx
    y = torch.einsum("bhpn,bn->bhp", h_new, c)
    return y, h_new

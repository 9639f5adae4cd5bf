"""The ``"io_stub"`` impl of ``kernels.ops``: the dry run's kernels (port
of the reference's ``impl="io_stub"``).

Each entry point below takes its kernel wrapper's arguments, runs the
wrapper's own validation and allocations (``_validated``, ``_check_*``,
``_buffers``: the float32 factor copies, the output, the decode kernels'
split partials, the SSD kernel's output and final state and chunk
states) and then, instead of launching, adds one call to ``TERMS[name]``
with:

- ``bytes``: each input the kernel reads once (q, k, v, the float32
  factors and slopes, or the whole cache) and each output it writes once
  (the decode kernels' new row read and written too);
- ``reread_bytes``: what kernel 1's tiling reads again beyond that: each
  64-row query block reads every K/V (and phi_k) tile its mask allows
  (``KERNEL1_TILE``), so a key tile is read once per query block that
  sees it;
- ``flops``: the kernel's matrix-product FLOPs over the (query, key)
  pairs its mask allows, exactly counted: ``2*D + 2*Dv + 2*R`` a pair,
  ALiBi counted as rank 2 (the reference's convention); the decode
  kernels over the whole cache (the stub cannot read the lengths); the
  SSD scan's four products per chunk.

Nothing is launched, no value is read and no output is written, so it
runs on fake tensors. The launch paths' pointer checks (alignment copies,
the built library's shared-memory limits) and the decode kernels'
arrival counters, made once per device, are left out.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import flash_decode as _decode
from repro_torch.kernels import flashbias_attn as _attn
from repro_torch.kernels import ssd_scan as _ssd

__all__ = ["KERNELS", "KERNEL1_TILE", "TERMS", "reset", "terms", "record",
           "allowed_pairs", "attention_terms", "flashbias_attention_fwd",
           "flashbias_attention_ragged_fwd", "flash_decode_fwd",
           "flash_decode_paged_fwd", "ssd_scan_fwd"]

KERNELS = ("flashbias_attention_fwd", "flashbias_attention_ragged_fwd",
           "flash_decode_fwd", "flash_decode_paged_fwd", "ssd_scan_fwd")

# kernel 1's (query rows, keys) per tile: kBQ, kBK of flashbias_attn.cu
KERNEL1_TILE = (64, 64)

TERMS: dict = {}


def reset() -> None:
    TERMS.clear()


def terms() -> dict:
    """{kernel: {"calls", "bytes", "reread_bytes", "flops"}} since the last
    ``reset``."""
    return {k: dict(v) for k, v in TERMS.items()}


def record(name: str, *, nbytes: float, flops: float,
           reread_bytes: float = 0.0) -> None:
    t = TERMS.setdefault(name, {"calls": 0, "bytes": 0.0,
                                "reread_bytes": 0.0, "flops": 0.0})
    t["calls"] += 1
    t["bytes"] += float(nbytes)
    t["reread_bytes"] += float(reread_bytes)
    t["flops"] += float(flops)


def nbytes(*tensors) -> int:
    """Bytes of the elements of each tensor given (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _rows(i: int, m: int, mask_kind: str, window: int, kv_len: int):
    """(first, last + 1) key a query at position ``i`` may see."""
    hi = kv_len
    lo = 0
    if mask_kind in ("causal", "local"):
        hi = min(hi, i + 1)
    if mask_kind == "local":
        lo = max(0, i - window + 1)
    return lo, max(lo, hi)


@functools.lru_cache(maxsize=256)
def allowed_pairs(n: int, m: int, mask_kind: str, window: int,
                  kv_len: int) -> int:
    """(query, key) pairs kernel 1's mask allows (``_allowed`` of the
    plain version, counted)."""
    total = 0
    for i in range(n):
        lo, hi = _rows(i, m, mask_kind, window, kv_len)
        total += hi - lo
    return total


@functools.lru_cache(maxsize=256)
def _tiles_visited(n: int, m: int, mask_kind: str, window: int,
                   kv_len: int) -> int:
    """Key tiles the query blocks of one (batch row, head) read together."""
    bq, bk = KERNEL1_TILE
    total = 0
    for q0 in range(0, n, bq):
        q1 = min(n, q0 + bq) - 1
        lo = _rows(q0, m, mask_kind, window, kv_len)[0]
        hi = _rows(q1, m, mask_kind, window, kv_len)[1]
        if hi > lo:
            total += -(-hi // bk) - lo // bk
    return total


def attention_terms(b: int, h: int, kvh: int, n: int, m: int, d: int,
                    dv: int, r: int, elem: int, mask_kind: str, window: int,
                    kv_len: int, *, flop_rank: int, factor_elem: int = 4):
    """(flops, reread_bytes) of one kernel-1 call with ``r`` float32 factor
    columns (0 without factors); ``flop_rank`` the bias rank its FLOPs
    count (2 for ALiBi computed in the kernel)."""
    pairs = allowed_pairs(n, m, mask_kind, window, kv_len)
    flops = b * h * pairs * (2 * d + 2 * dv + 2 * flop_rank)
    tile = KERNEL1_TILE[1] * ((d + dv) * elem + r * factor_elem)
    visited = b * h * _tiles_visited(n, m, mask_kind, window, kv_len) * tile
    once = b * kvh * m * (d + dv) * elem + b * h * m * r * factor_elem
    return flops, max(0, visited - once)


# ---------------------------------------------------------------------------
# The entry points (the wrappers' signatures)
# ---------------------------------------------------------------------------

def _attention(name, q, k, v, phi_q, phi_k, slopes, mask_kind, window,
               kv_len, extra=()):
    """Kernel 1 or 2: its inputs read once, its output written once, the
    tiles read again and the FLOPs of the pairs the mask allows
    (``kv_len`` keys; None: all)."""
    alibi = slopes is not None
    dims, (q, k, v), phi_q, phi_k, slopes, dv = _attn._validated(
        q, k, v, phi_q, phi_k, slopes, mask_kind, window, name)
    out = _attn._output(dims, q)
    b, h, kvh, n, m, d, dv_pad, r = dims
    flops, reread = attention_terms(
        b, h, kvh, n, m, d, dv_pad, r, out.element_size(), mask_kind,
        window, m if kv_len is None else int(kv_len),
        flop_rank=2 if alibi else r)
    record(name, nbytes=nbytes(q, k, v, phi_q, phi_k, slopes, *extra, out),
           flops=flops, reread_bytes=reread)
    return out[..., :dv].contiguous() if out.shape[-1] != dv else out


def flashbias_attention_fwd(q, k, v, phi_q=None, phi_k=None, slopes=None,
                            *, scale: float, mask_kind: str = "none",
                            window: int = 0, kv_len: Optional[int] = None):
    """Kernel 1's stub."""
    return _attention("flashbias_attention_fwd", q, k, v, phi_q, phi_k,
                      slopes, mask_kind, window, kv_len)


def flashbias_attention_ragged_fwd(q, k, v, phi_q, phi_k, slopes, lengths,
                                   *, scale: float, mask_kind: str = "none",
                                   window: int = 0):
    """Kernel 2's stub: every row counted at its full length (the stub
    reads no lengths)."""
    return _attention("flashbias_attention_ragged_fwd", q, k, v, phi_q,
                      phi_k, slopes, mask_kind, window, None,
                      extra=(lengths,))


def _decode_call(name, q, v, s_len, lengths, phi_q, slopes, k_new, v_new,
                 r, extra=()):
    """One decode call: q, the whole cache (``s_len`` keys a row) and the
    factors read once, the new row read and written, the output written;
    the FLOPs of G query rows against every key of each (b, kv head)."""
    b, kvh, g, d = q.shape
    dv = v.shape[-1]
    out = _decode._buffers(q, s_len, dv, r)[0]
    rank = r if phi_q is not None else (2 if slopes is not None else 0)
    cache = b * kvh * s_len * ((d + dv) * q.element_size() + 4 * r)
    record(name, nbytes=cache + 2 * nbytes(k_new, v_new) + nbytes(
        q, lengths, phi_q, slopes, out, *extra),
        flops=b * kvh * g * s_len * (2 * d + 2 * dv + 2 * rank))
    return out


def flash_decode_fwd(q, k_cache, v_cache, lengths, phi_q=None, phi_k=None,
                     slopes=None, *, scale: float, k_new=None, v_new=None):
    """Kernel 3's stub; the new row is not written."""
    s_len, phi_q, phi_k, slopes, r = _decode._check_contiguous(
        q, k_cache, v_cache, lengths, phi_q, phi_k, slopes, k_new, v_new)
    return _decode_call("flash_decode_fwd", q, v_cache, s_len, lengths,
                        phi_q, slopes, k_new, v_new, r)


def flash_decode_paged_fwd(q, k_pages, v_pages, lengths, page_table,
                           phi_q=None, phi_pages=None, slopes=None, *,
                           scale: float, k_new=None, v_new=None):
    """Kernel 4's stub, each row charged the table's full width; the new
    row is not written."""
    _, phi_q, phi_pages, slopes, r = _decode._check_paged(
        q, k_pages, v_pages, lengths, page_table, phi_q, phi_pages, slopes,
        k_new, v_new)
    return _decode_call("flash_decode_paged_fwd", q, v_pages,
                        page_table.shape[1] * k_pages.shape[2], lengths,
                        phi_q, slopes, k_new, v_new, r, extra=(page_table,))


def ssd_scan_fwd(x, dt, a, b, c, *, chunk: int = 256, h0=None):
    """Kernel 5's stub: y, the final state and the float32 chunk states
    and decays allocated (the tensor-core body's tile scratch left out);
    the inputs read once (b and c once per group), y and the final state
    written; the FLOPs of the four products of each chunk of q <= chunk
    steps: c.b^T (2 q^2 N), its masked product with x (2 q^2 P), the chunk
    state (2 q P N) and the state's output term (2 q P N), per (row,
    head)."""
    (bsz, h, s, p, n, _), dt, a, b, c, h0 = _ssd._validated(
        x, dt, a, b, c, h0, chunk)
    nc = -(-s // chunk)
    y = torch.empty_like(x)
    h_fin = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    torch.empty((bsz * h * nc * (p * n + 1),), dtype=torch.float32,
                device=x.device)
    full, tail = divmod(s, chunk)
    per = sum(k * (2 * q * q * (n + p) + 4 * q * p * n)
              for k, q in ((full, chunk), (1 if tail else 0, tail)))
    record("ssd_scan_fwd",
           nbytes=nbytes(x, dt, a, b[:, :1], c[:, :1], h0, y, h_fin),
           flops=bsz * h * per)
    return y, h_fin

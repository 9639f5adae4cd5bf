"""Single-token decode against a contiguous or a paged KV cache: the Hopper
CUDA kernel (``csrc/flash_decode.cu``) and its plain PyTorch versions.

Port of ``repro.kernels.flash_decode.flash_decode_fwd`` and
``flash_decode_paged_fwd``. Layout is the kernel's grouped head-major one:
q ``(B, KVH, G, D)`` (the G q-heads of a kv head are its rows),
``lengths (B,)`` int32, ``phi_q (B, KVH, G, R)`` float32, ``slopes
(KVH, G)``. Row ``b`` attends to its cache rows ``0 .. lengths[b]-1``; the
query sits at position ``lengths[b]-1``. Output ``(B, KVH, G, Dv)`` in q's
dtype; rows with length 0 output 0.

- Contiguous: caches ``(B, KVH, S, D|Dv)``, ``phi_k (B, KVH, S, R)``.
- Paged: pools ``(KVH, n_pages, ps, D|Dv)`` shared by every row,
  ``page_table (B, P)`` int32, factor slab ``phi_pages (1|KVH, n_pages,
  ps, R)`` float32 (a leading 1 is one slab for every kv head). Row ``b``'s
  logical key ``j`` lives on page ``page_table[b, min(j // ps, last)]``
  (``last = max(len-1, 0) // ps``) clipped into ``[0, n_pages)``, at offset
  ``j % ps``, exactly as the TPU kernel's index maps resolve it: stale or
  sentinel table entries can never fault.

With ``k_new (B, KVH, D)`` and ``v_new (B, KVH, Dv)`` (the cache's dtype) a
call first writes the new token's row in place, as the reference's decode
step scatters it before its kernel: only rows with ``lengths[b] > 0``, at
position ``lengths[b]-1`` (paged: on the page ``paged_write_plan`` finds,
dropped where that page lies outside the pool), then attends to the cache
as written.

``flash_decode_fwd`` and ``flash_decode_paged_fwd`` are the wrappers: on a
CUDA tensor they launch the kernel (or raise); on a CPU tensor they run the
plain version. Their ``.launches`` count kernel launches. The kernel splits
each row's keys into spans of ``split_span`` keys, one block per span, and
merges the spans in order: see the source.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.attention import DEFAULT_MASK_VALUE
from repro_torch.kernels import build

__all__ = ["flash_decode_torch", "flash_decode_fwd",
           "flash_decode_paged_torch", "flash_decode_paged_fwd",
           "paged_write_plan", "write_row", "write_paged_row", "expand_groups",
           "split_span", "MAX_GROUP"]

MAX_GROUP = 16                # q heads per kv head the kernel takes
MAX_SPAN = 128                # keys per split (the kernel takes <= 256)
SPAN_TILE_BYTES = 32 * 1024   # a split's staged k, v (and phi) rows
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232_448


def split_span(d: int, dv: int, r: int, dtype: torch.dtype) -> int:
    """Keys per split of the kernel's plan: 128, or the largest power of two
    whose staged k and v rows (padded to 16 bytes) and phi rows fit in
    SPAN_TILE_BYTES. A function of the static shapes only, so a row's plan
    never depends on another row."""
    size = torch.empty((), dtype=dtype).element_size()
    per16 = 16 // size
    padded = -(-d // per16) * per16 + -(-dv // per16) * per16
    per_key = padded * size + 4 * r
    span = MAX_SPAN
    while span > 1 and span * per_key > SPAN_TILE_BYTES:
        span //= 2
    return span


def write_row(k_cache, v_cache, lengths, k_new, v_new):
    """The new token's row at position ``lengths - 1`` of each row with
    ``lengths > 0``, in place; the other rows rewrite the row they hold."""
    active = lengths > 0
    bidx = torch.arange(lengths.shape[0], device=lengths.device)
    pos = torch.where(active, lengths - 1, 0)
    keep = active[:, None, None]
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[bidx, :, pos] = torch.where(keep, new, cache[bidx, :, pos])


def paged_write_plan(page_table: torch.Tensor, rows: torch.Tensor,
                     pos: torch.Tensor, active: torch.Tensor, n_pages: int,
                     ps: int):
    """Where writes land in the pool: entry ``i`` writes position ``pos[i]``
    of row ``rows[i]`` where ``active[i]``. Returns ``(page, offset, src,
    keep)``, one per entry, every index in range (a decode step has one
    entry per row, a prefill chunk one per valid position).

    The reference drops the writes of inactive entries and of entries whose
    table entry is a sentinel (``>= n_pages``) through out-of-range scatter
    indices; on a CUDA tensor such an index is a device-side assert. So an
    entry that must not write instead repeats the write of the first entry
    that does (``src``): duplicate indices then carry equal values and the
    result does not depend on their order. When no entry writes, every entry
    rewrites page 0's first row with itself (``keep`` False). All of it
    stays on the device: no host sync."""
    idx = torch.arange(rows.shape[0], device=rows.device)
    pos = pos.long()
    block = (pos // ps).clamp(max=page_table.shape[1] - 1)
    page = page_table[rows, block].long()
    ok = active & (page >= 0) & (page < n_pages)
    src = torch.where(ok, idx, torch.argmax(ok.to(torch.int32)))
    keep = ok[src]
    return (torch.where(keep, page[src], 0),
            torch.where(keep, pos[src] % ps, 0), src, keep)


def write_paged_row(k_pages, v_pages, lengths, page_table, k_new, v_new):
    """The new token's row into the pools (``paged_write_plan``, one entry
    per row at position ``lengths - 1``), in place."""
    active = lengths > 0
    page, off, src, keep = paged_write_plan(
        page_table, torch.arange(lengths.shape[0], device=lengths.device),
        torch.where(active, lengths - 1, 0), active, k_pages.shape[1],
        k_pages.shape[2])
    keep = keep[None, :, None]
    for pool, new in ((k_pages, k_new), (v_pages, v_new)):
        new = new[src].transpose(0, 1)                       # (KVH, B, E)
        pool[:, page, off] = torch.where(keep, new, pool[:, page, off])


def expand_groups(q: torch.Tensor, caches: tuple,
                  phi_q: Optional[torch.Tensor],
                  slopes: Optional[torch.Tensor], axis: int):
    """Per-q-head key factors may differ within a group, which the grouped
    layout (one key row per kv head) cannot express. Serve them at G = 1
    instead: q ``(B, KVH, G, *)`` becomes ``(B, H, 1, *)`` (so do
    ``phi_q`` and ``slopes (KVH, G) -> (H, 1)``), and each cache is repeated
    over the G heads of its group along its kv-head ``axis`` (1 for a
    contiguous ``(B, KVH, S, *)`` cache, 0 for a pool ``(KVH, n_pages, ps,
    *)``): one copy, G times the cache's size."""
    b, kvh, g = q.shape[:3]
    one = (lambda t: None if t is None
           else t.reshape(b, kvh * g, 1, t.shape[-1]))
    return (one(q), tuple(c.repeat_interleave(g, dim=axis) for c in caches),
            one(phi_q), None if slopes is None else slopes.reshape(-1, 1))


def flash_decode_torch(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    lengths: torch.Tensor,
    phi_q: Optional[torch.Tensor] = None,
    phi_k: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
    *, scale: float,
    k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the kernel: the row write, then dense float32
    logits over the cache. A per-q-head ``phi_k (B, KVH*G, S, R)`` (with G
    > 1) is served through ``expand_groups``: the write lands first, then
    the G q heads of each kv head attend as G kv heads of one."""
    lengths = lengths.to(q.device)
    if k_new is not None:
        write_row(k_cache, v_cache, lengths, k_new, v_new)
    b, kvh, g = q.shape[:3]
    if phi_k is not None and g > 1 and phi_k.shape[1] == kvh * g:
        q, (k_cache, v_cache), phi_q, slopes = expand_groups(
            q, (k_cache, v_cache), phi_q, slopes, axis=1)
    s_len = k_cache.shape[2]
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k_cache.float()) * scale
    if phi_q is not None:
        s = s + torch.einsum("bkgr,bksr->bkgs", phi_q.float(), phi_k.float())
    k_pos = torch.arange(s_len, device=q.device)
    if slopes is not None:
        rel = (k_pos[None] - (lengths - 1)[:, None]).float()        # (B, S)
        s = s + slopes.float()[None, :, :, None] * rel[:, None, None]
    valid = (k_pos[None] < lengths[:, None])[:, None, None]        # (B,1,1,S)
    s = torch.where(valid, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    o = torch.einsum("bkgs,bkse->bkge", torch.softmax(s, dim=-1),
                     v_cache.float())
    o = o * (lengths > 0)[:, None, None, None]
    return o.reshape(b, kvh, g, -1).to(q.dtype)


def flash_decode_paged_torch(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    lengths: torch.Tensor, page_table: torch.Tensor,
    phi_q: Optional[torch.Tensor] = None,
    phi_pages: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
    *, scale: float, max_pages: Optional[int] = None,
    k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the paged kernel: the row write, then each row's
    logical view of the pool gathered, capped at ``max_pages`` pages
    (default: the table's width), page ids resolved and clipped as the
    kernel does, then the contiguous plain version."""
    b, kvh = q.shape[:2]
    n_pages, ps = k_pages.shape[1], k_pages.shape[2]
    width = page_table.shape[1]
    cap = width if max_pages is None else max(1, min(int(max_pages), width))
    lengths = lengths.to(q.device)
    page_table = page_table.to(q.device)
    if k_new is not None:
        write_paged_row(k_pages, v_pages, lengths, page_table, k_new, v_new)
    last = (lengths.long() - 1).clamp(min=0) // ps                   # (B,)
    blocks = torch.minimum(torch.arange(cap, device=q.device)[None],
                           last[:, None])                            # (B, cap)
    pages = page_table.long().gather(1, blocks)
    pages = pages.clamp(0, n_pages - 1)

    def view(pool):           # (H', n_pages, ps, E) -> (B, H', cap*ps, E)
        rows = pool[:, pages].transpose(0, 1)
        return rows.reshape(b, pool.shape[0], cap * ps, pool.shape[-1])

    phi_k = None
    if phi_q is not None:
        phi_k = view(phi_pages).expand(b, kvh, cap * ps, phi_pages.shape[-1])
    return flash_decode_torch(q, view(k_pages), view(v_pages), lengths,
                              phi_q, phi_k, slopes, scale=scale)


@functools.cache
def _kernel():
    """The launch and shared-memory functions of the built library,
    bound once (building it on first use)."""
    lib = build.load("flash_decode")
    contiguous = lib.flash_decode_fwd
    contiguous.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
                           + [ctypes.c_float, ctypes.c_void_p])
    contiguous.restype = ctypes.c_int
    paged = lib.flash_decode_paged_fwd
    paged.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 12
                      + [ctypes.c_float, ctypes.c_void_p])
    paged.restype = ctypes.c_int
    smem = lib.flash_decode_smem_bytes
    smem.argtypes = [ctypes.c_int] * 6
    smem.restype = ctypes.c_longlong
    return contiguous, paged, smem


_ARRIVALS: dict = {}
MIN_ARRIVALS = 1024


def _arrivals(device: torch.device, n: int) -> torch.Tensor:
    """The kernel's per-(b, h) arrival counters on ``device``: zeroed once
    here, left at zero by every launch."""
    buf = _ARRIVALS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, MIN_ARRIVALS), dtype=torch.int32,
                          device=device)
        _ARRIVALS[device] = buf
    return buf


def _check(name: str, q, k, v, lengths, phi_q, phi_k, slopes, k_new, v_new,
           extra=()):
    """Checks both wrappers share; returns (phi_q, phi_k, slopes, r) with
    the float32 contiguous tensors the kernel reads (copies only where the
    caller's are not)."""
    b, kvh, g, d = q.shape
    dv = v.shape[-1]
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"group {g}: the kernel takes 1..{MAX_GROUP} q "
                         f"heads per kv head")
    if not 1 <= d <= 256 or not 1 <= dv <= 256:
        raise ValueError(f"head dims {d}/{dv}: the kernel takes 1..256")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                         f"float32 or bfloat16, all alike")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be ({b},) int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if (k_new is None) != (v_new is None):
        raise ValueError("the new row takes k_new and v_new together")
    if k_new is not None and (
            k_new.shape != (b, kvh, d) or v_new.shape != (b, kvh, dv)
            or k_new.dtype != q.dtype or v_new.dtype != q.dtype):
        raise ValueError(f"new row shapes {tuple(k_new.shape)} / "
                         f"{tuple(v_new.shape)} {k_new.dtype}; want "
                         f"(B,KVH,D) / (B,KVH,Dv) in the cache's dtype")
    r = 0
    if phi_q is not None:
        if phi_k is None or slopes is not None:
            raise ValueError("phi mode takes phi_q and phi_k, no slopes")
        r = phi_q.shape[-1]
        if phi_q.shape != (b, kvh, g, r) or phi_k.shape[-1] != r:
            raise ValueError(f"phi shapes {tuple(phi_q.shape)} / "
                             f"{tuple(phi_k.shape)}; want (B,KVH,G,R) "
                             f"and rank R key factors")
        phi_q = phi_q.float().contiguous()
        phi_k = phi_k.float().contiguous()
    if slopes is not None:
        if slopes.shape != (kvh, g):
            raise ValueError(f"slopes shape {tuple(slopes.shape)} != "
                             f"({kvh}, {g})")
        slopes = slopes.float().contiguous()
    tensors = [t for t in (q, k, v, lengths, phi_q, phi_k, slopes, k_new,
                           v_new, *extra) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: inputs on several devices")
    if not all(t.is_contiguous() for t in (q, k, v, lengths, k_new, v_new,
                                            *extra) if t is not None):
        raise ValueError(f"{name} takes contiguous q, caches, lengths, new "
                         f"rows and page table")
    return phi_q, phi_k, slopes, r


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _buffers(q, s_len, dv, r):
    """Output and split partials of one launch over ``s_len`` keys, and the
    split span."""
    b, kvh, g, d = q.shape
    span = split_span(d, dv, r, q.dtype)
    splits = -(-s_len // span)
    out = torch.empty((b, kvh, g, dv), dtype=q.dtype, device=q.device)
    part = torch.empty((b * kvh * splits * g * (dv + 2) if splits > 1 else 0,),
                       dtype=torch.float32, device=q.device)
    return out, part, span


def _launch_buffers(q, s_len, dv, r, smem):
    """Output, split partials and arrival counters of one launch, and the
    split span; raises where the shapes exceed the kernel's shared memory."""
    out, part, span = _buffers(q, s_len, dv, r)
    b, kvh, g, d = q.shape
    if smem(g, d, dv, r, span, _DTYPES[q.dtype]) > _SMEM_LIMIT:
        raise ValueError(f"group {g}, head dims {d}/{dv}, rank {r} exceed "
                         f"the kernel's shared memory")
    return out, part, _arrivals(q.device, b * kvh), span


def _check_contiguous(q, k_cache, v_cache, lengths, phi_q, phi_k, slopes,
                      k_new, v_new):
    """``flash_decode_fwd``'s checks; returns (S, phi_q, phi_k, slopes, r)
    as ``_check`` does."""
    b, kvh, g, d = q.shape
    s_len = k_cache.shape[2]
    if k_cache.shape != (b, kvh, s_len, d) or v_cache.shape[:3] != (b, kvh,
                                                                    s_len):
        raise ValueError(f"cache shapes {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if phi_k is not None and phi_k.shape[:3] != (b, kvh, s_len):
        raise ValueError(f"phi_k shape {tuple(phi_k.shape)}; want "
                         f"(B,KVH,S,R)")
    return (s_len, *_check("flash_decode_fwd", q, k_cache, v_cache, lengths,
                           phi_q, phi_k, slopes, k_new, v_new))


def _check_paged(q, k_pages, v_pages, lengths, page_table, phi_q, phi_pages,
                 slopes, k_new, v_new):
    """``flash_decode_paged_fwd``'s checks; returns (phi heads, phi_q,
    phi_pages, slopes, r) as ``_check`` does."""
    b, kvh, g, d = q.shape
    n_pages, ps = k_pages.shape[1], k_pages.shape[2]
    if (k_pages.shape != (kvh, n_pages, ps, d)
            or v_pages.shape[:3] != (kvh, n_pages, ps)):
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}; want (KVH, n_pages, ps, D)")
    if (page_table.dim() != 2 or page_table.shape[0] != b
            or page_table.shape[1] < 1 or page_table.dtype != torch.int32):
        raise ValueError(f"page_table must be ({b}, P) int32, got "
                         f"{tuple(page_table.shape)} {page_table.dtype}")
    phi_heads = 0
    if phi_pages is not None:
        phi_heads = phi_pages.shape[0]
        if phi_pages.dim() != 4 or phi_heads not in (1, kvh) or \
                phi_pages.shape[1:3] != (n_pages, ps):
            raise ValueError(f"phi slab shape {tuple(phi_pages.shape)}; "
                             f"want (1|KVH, n_pages, ps, R)")
    return (phi_heads, *_check("flash_decode_paged_fwd", q, k_pages, v_pages,
                               lengths, phi_q, phi_pages, slopes, k_new,
                               v_new, extra=(page_table,)))


def flash_decode_fwd(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    lengths: torch.Tensor,
    phi_q: Optional[torch.Tensor] = None,
    phi_k: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
    *, scale: float,
    k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel wrapper: launches ``flash_decode.cu`` on CUDA tensors, runs the
    plain version on CPU tensors."""
    build.refuse_dtensors("flash_decode_fwd", q, k_cache, v_cache, lengths,
                          phi_q, phi_k, slopes, k_new, v_new)
    if q.device.type == "cpu":
        return flash_decode_torch(q, k_cache, v_cache, lengths, phi_q, phi_k,
                                  slopes, scale=scale, k_new=k_new,
                                  v_new=v_new)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_fwd: no kernel for device {q.device}")
    s_len, phi_q, phi_k, slopes, r = _check_contiguous(
        q, k_cache, v_cache, lengths, phi_q, phi_k, slopes, k_new, v_new)
    b, kvh, g, d = q.shape
    dv = v_cache.shape[-1]
    fn, _, smem = _kernel()
    out, part, arrivals, span = _launch_buffers(q, s_len, dv, r, smem)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), _ptr(phi_q), _ptr(phi_k), _ptr(slopes),
             _ptr(k_new), _ptr(v_new), out.data_ptr(), _ptr(part),
             arrivals.data_ptr(), _DTYPES[q.dtype], b, kvh, g, s_len, d, dv,
             r, span, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode.cu launch failed: CUDA error {err}")
    flash_decode_fwd.launches += 1
    return out


flash_decode_fwd.launches = 0


def flash_decode_paged_fwd(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    lengths: torch.Tensor, page_table: torch.Tensor,
    phi_q: Optional[torch.Tensor] = None,
    phi_pages: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
    *, scale: float,
    k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel wrapper: launches the paged entry of ``flash_decode.cu`` on
    CUDA tensors, runs the plain version on CPU tensors. The kernel reads
    only rows below ``lengths[b]``, so it needs no page cap."""
    build.refuse_dtensors("flash_decode_paged_fwd", q, k_pages, v_pages,
                          lengths, page_table, phi_q, phi_pages, slopes,
                          k_new, v_new)
    if q.device.type == "cpu":
        return flash_decode_paged_torch(q, k_pages, v_pages, lengths,
                                        page_table, phi_q, phi_pages, slopes,
                                        scale=scale, k_new=k_new, v_new=v_new)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_paged_fwd: no kernel for device "
                         f"{q.device}")
    phi_heads, phi_q, phi_pages, slopes, r = _check_paged(
        q, k_pages, v_pages, lengths, page_table, phi_q, phi_pages, slopes,
        k_new, v_new)
    b, kvh, g, d = q.shape
    n_pages, ps, dv = k_pages.shape[1], k_pages.shape[2], v_pages.shape[-1]
    _, fn, smem = _kernel()
    width = page_table.shape[1]
    out, part, arrivals, span = _launch_buffers(q, width * ps, dv, r, smem)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             lengths.data_ptr(), page_table.data_ptr(), _ptr(phi_q),
             _ptr(phi_pages), _ptr(slopes), _ptr(k_new), _ptr(v_new),
             out.data_ptr(), _ptr(part), arrivals.data_ptr(),
             _DTYPES[q.dtype], b, kvh, g, width, n_pages, ps, d, dv, r,
             phi_heads, span, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_decode.cu paged launch failed: CUDA error "
                           f"{err}")
    flash_decode_paged_fwd.launches += 1
    return out


flash_decode_paged_fwd.launches = 0

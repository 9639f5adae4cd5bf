"""Single-token decode against a contiguous KV cache: the Hopper CUDA kernel
(``csrc/flash_decode.cu``) and its plain PyTorch version.

Port of ``repro.kernels.flash_decode.flash_decode_fwd`` (the contiguous
kernel; the paged one is still to be ported). Layout is the kernel's
grouped head-major one: q ``(B, KVH, G, D)`` (the G q-heads of a kv head are
its rows), caches ``(B, KVH, S, D|Dv)``, ``lengths (B,)`` int32,
``phi_q (B, KVH, G, R)``, ``phi_k (B, KVH, S, R)``, ``slopes (KVH, G)``.
Row ``b`` attends to cache rows ``0 .. lengths[b]-1``; the query sits at
position ``lengths[b]-1``. Output ``(B, KVH, G, Dv)`` in q's dtype; rows
with length 0 output 0.

``flash_decode_fwd`` is the wrapper: on a CUDA tensor it launches the
kernel (or raises); on a CPU tensor it runs ``flash_decode_torch``.
``flash_decode_fwd.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.attention import DEFAULT_MASK_VALUE
from repro_torch.kernels import build

__all__ = ["flash_decode_torch", "flash_decode_fwd", "MAX_GROUP"]

MAX_GROUP = 8                 # q heads per kv head the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232_448


def flash_decode_torch(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    lengths: torch.Tensor,
    phi_q: Optional[torch.Tensor] = None,
    phi_k: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
    *, scale: float,
) -> torch.Tensor:
    """Plain version of the kernel: dense float32 logits over the cache."""
    s_len = k_cache.shape[2]
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k_cache.float()) * scale
    if phi_q is not None:
        s = s + torch.einsum("bkgr,bksr->bkgs", phi_q.float(), phi_k.float())
    k_pos = torch.arange(s_len, device=q.device)
    lengths = lengths.to(q.device)
    if slopes is not None:
        rel = (k_pos[None] - (lengths - 1)[:, None]).float()        # (B, S)
        s = s + slopes.float()[None, :, :, None] * rel[:, None, None]
    valid = (k_pos[None] < lengths[:, None])[:, None, None]        # (B,1,1,S)
    s = torch.where(valid, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    o = torch.einsum("bkgs,bkse->bkge", torch.softmax(s, dim=-1),
                     v_cache.float())
    o = o * (lengths > 0)[:, None, None, None]
    return o.to(q.dtype)


@functools.cache
def _kernel():
    """The launch and shared-memory functions of the built library,
    bound once (building it on first use)."""
    lib = build.load("flash_decode")
    fn = lib.flash_decode_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    smem = lib.flash_decode_smem_bytes
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_longlong
    return fn, smem


def flash_decode_fwd(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    lengths: torch.Tensor,
    phi_q: Optional[torch.Tensor] = None,
    phi_k: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
    *, scale: float,
) -> torch.Tensor:
    """Kernel wrapper: launches ``flash_decode.cu`` on CUDA tensors, runs the
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_decode_torch(q, k_cache, v_cache, lengths, phi_q, phi_k,
                                  slopes, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_fwd: no kernel for device {q.device}")
    b, kvh, g, d = q.shape
    s_len, dv = k_cache.shape[2], v_cache.shape[-1]
    if k_cache.shape != (b, kvh, s_len, d) or v_cache.shape[:3] != (b, kvh,
                                                                    s_len):
        raise ValueError(f"cache shapes {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"group {g}: the kernel takes 1..{MAX_GROUP} q "
                         f"heads per kv head")
    if not 1 <= d <= 256 or not 1 <= dv <= 256:
        raise ValueError(f"head dims {d}/{dv}: the kernel takes 1..256")
    if (q.dtype not in _DTYPES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise ValueError(f"dtypes q {q.dtype}, k {k_cache.dtype}, v "
                         f"{v_cache.dtype}: float32 or bfloat16, all alike")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be ({b},) int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    r = 0
    if phi_q is not None:
        if phi_k is None or slopes is not None:
            raise ValueError("phi mode takes phi_q and phi_k, no slopes")
        r = phi_q.shape[-1]
        if phi_q.shape != (b, kvh, g, r) or phi_k.shape != (b, kvh, s_len, r):
            raise ValueError(f"phi shapes {tuple(phi_q.shape)} / "
                             f"{tuple(phi_k.shape)}; want (B,KVH,G,R)/"
                             f"(B,KVH,S,R)")
        phi_q = phi_q.float().contiguous()
        phi_k = phi_k.float().contiguous()
    if slopes is not None:
        if slopes.shape != (kvh, g):
            raise ValueError(f"slopes shape {tuple(slopes.shape)} != "
                             f"({kvh}, {g})")
        slopes = slopes.float().contiguous()
    tensors = [t for t in (q, k_cache, v_cache, lengths, phi_q, phi_k, slopes)
               if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode_fwd: inputs on several devices")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, lengths)):
        raise ValueError("flash_decode_fwd takes contiguous q, caches and "
                         "lengths")
    fn, smem = _kernel()
    if smem(g, d, dv, r) > _SMEM_LIMIT:
        raise ValueError(f"group {g}, head dims {d}/{dv}, rank {r} exceed "
                         f"the kernel's shared memory")
    out = torch.empty((b, kvh, g, dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), None if phi_q is None else phi_q.data_ptr(),
             None if phi_k is None else phi_k.data_ptr(),
             None if slopes is None else slopes.data_ptr(), out.data_ptr(),
             _DTYPES[q.dtype], b, kvh, g, s_len, d, dv, r, float(scale),
             stream)
    if err != 0:
        raise RuntimeError(f"flash_decode.cu launch failed: CUDA error {err}")
    flash_decode_fwd.launches += 1
    return out


flash_decode_fwd.launches = 0

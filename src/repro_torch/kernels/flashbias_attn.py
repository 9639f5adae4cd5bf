"""Flash attention forward with a FlashBias bias: the Hopper CUDA kernels
(``csrc/flashbias_attn.cu``) and their plain PyTorch version.

Port of ``repro.kernels.flashbias_attn.flashbias_attention_fwd`` and of its
ragged variant ``_attn_kernel_ragged``. Layout is head-major: q ``(B, H, N,
D)``, k ``(B, KVH, M, D)``, v ``(B, KVH, M, Dv)``, ``phi_q (B, H, N, R)``,
``phi_k (B, H, M, R)``, ``slopes (H,)``; the output is ``(B, H, N, Dv)`` in
q's dtype. Exactly one of {phi_q + phi_k, slopes, neither} selects the bias
mode (factored / in-kernel ALiBi / none).

Two wrappers, each with its own launch counter (``.launches``), both on the
one CUDA source:

- ``flashbias_attention_fwd`` (kernel 1): keys bounded by a static
  ``kv_len``;
- ``flashbias_attention_ragged_fwd`` (kernel 2): row ``b`` bounded by its
  own ``lengths[b]``, which stays on the device (the kernel reads it).

The source has two bodies, chosen by dtype: bf16 runs on the tensor cores
(wgmma, TMA loads), float32 on the CUDA cores. Each wrapper also counts the
launches that took the tensor-core body (``.tensor_core_launches``), as
the library reports the dtype's body. For the bf16 body the TMA loads need
row strides of 16 bytes: a head dim that is not a multiple of 8, or a rank
that is not a multiple of 4, is zero-padded here (which changes no logit),
and the output's padded columns are cut off.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor
it runs ``flashbias_attention_torch``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.attention import DEFAULT_MASK_VALUE
from repro_torch.kernels import build

__all__ = ["flashbias_attention_torch", "flashbias_attention_fwd",
           "flashbias_attention_ragged_fwd", "MASK_KINDS"]

MASK_KINDS = {"none": 0, "causal": 1, "local": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232_448          # dynamic shared memory a block may use (H100)
_MAX_RANK_TC = 256             # a TMA box holds at most 256 factor columns


def _allowed(n: int, m: int, mask_kind: str, window: int, kv_len: int,
             device) -> torch.Tensor:
    q_pos = torch.arange(n, device=device)[:, None]
    k_pos = torch.arange(m, device=device)[None, :]
    allowed = k_pos < kv_len
    if mask_kind in ("causal", "local"):
        allowed = allowed & (q_pos >= k_pos)
    if mask_kind == "local":
        allowed = allowed & (q_pos - k_pos < window)
    return allowed                                            # (N, M)


def flashbias_attention_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    phi_q: Optional[torch.Tensor] = None,
    phi_k: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
    *, scale: float, mask_kind: str = "none", window: int = 0,
    kv_len: Optional[int] = None,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the kernels: dense float32 logits and softmax.

    ``lengths (B,)`` (the ragged kernel's bound) masks row ``b``'s keys at
    positions ``>= lengths[b]`` in place of the static ``kv_len``, combined
    with the ``mask_kind`` mask. Differentiable (the ``ops`` backward
    recomputes through it). A row with no allowed key outputs 0, as the
    kernels' ``l == 0`` rows do."""
    b, h, n, _ = q.shape
    kvh, m = k.shape[1], k.shape[2]
    if lengths is not None and kv_len is not None:
        raise ValueError("pass kv_len or lengths, not both")
    kv_len = m if kv_len is None else kv_len
    g = h // kvh
    kf = k.float().repeat_interleave(g, dim=1) if g > 1 else k.float()
    vf = v.float().repeat_interleave(g, dim=1) if g > 1 else v.float()
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), kf) * scale
    if phi_q is not None:
        s = s + torch.einsum("bhnr,bhmr->bhnm", phi_q.float(),
                             phi_k.float().expand(b, h, m, -1))
    if slopes is not None:
        rel = (torch.arange(m, device=q.device)[None, :]
               - torch.arange(n, device=q.device)[:, None]).float()
        s = s + slopes.float()[:, None, None] * rel
    allowed = _allowed(n, m, mask_kind, window, kv_len, q.device)  # (N, M)
    if lengths is not None:
        in_range = (torch.arange(m, device=q.device)[None, :]
                    < lengths.to(q.device).reshape(-1, 1))          # (B, M)
        allowed = (allowed[None] & in_range[:, None, :])[:, None]  # B1NM
    s = torch.where(allowed, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    o = torch.einsum("bhnm,bhmd->bhnd", torch.softmax(s, dim=-1), vf)
    o = o * allowed.any(dim=-1, keepdim=True)
    return o.to(q.dtype)


@functools.cache
def _kernel():
    """The static and ragged launch functions and the shared-memory size
    function of the built library, bound once (building it on first use),
    and the dtypes its dispatch sends to the tensor-core body."""
    lib = build.load("flashbias_attn")
    fn = lib.flashbias_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ragged = lib.flashbias_attn_ragged_fwd
    ragged.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
    ragged.restype = ctypes.c_int
    smem = lib.flashbias_attn_smem_bytes
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_longlong
    body = lib.flashbias_attn_tensor_core
    body.argtypes = [ctypes.c_int]
    body.restype = ctypes.c_int
    tensor_core = {dt for dt, code in _DTYPES.items() if body(code)}
    return fn, ragged, smem, tensor_core


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _pad_last(t: Optional[torch.Tensor], mult: int):
    """``t`` with its last dim zero-padded to a multiple of ``mult``."""
    if t is None or t.shape[-1] % mult == 0:
        return t
    return F.pad(t, (0, -t.shape[-1] % mult))


def _aligned(t: Optional[torch.Tensor]):
    """``t``, copied where its data does not start on 16 bytes (TMA)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _checked(q, k, v, phi_q, phi_k, slopes, mask_kind, window, name):
    """Validate a CUDA launch's inputs; returns the dims, the (padded) q, k,
    v, the float32 contiguous factors and slopes, the output tensor and the
    output's true head dim."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    b, h, n, d = q.shape
    if k.ndim != 4 or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    kvh, m = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    if v.shape[:3] != k.shape[:3]:
        raise ValueError(f"v shape {tuple(v.shape)} vs k {tuple(k.shape)}")
    if h % kvh:
        raise ValueError(f"{h} heads do not group over {kvh} kv heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                         f"the kernel takes float32 or bfloat16, all alike")
    if mask_kind not in MASK_KINDS or (mask_kind == "local" and window < 1):
        raise ValueError(f"mask {mask_kind!r} window {window}")
    if not 1 <= d <= 256 or not 1 <= dv <= 256:
        raise ValueError(f"head dims {d}/{dv}: the kernel takes 1..256")
    r = 0
    if phi_q is not None:
        if phi_k is None or slopes is not None:
            raise ValueError("phi mode takes phi_q and phi_k, no slopes")
        r = phi_q.shape[-1]
        if phi_q.shape != (b, h, n, r) or phi_k.shape != (b, h, m, r):
            raise ValueError(f"phi shapes {tuple(phi_q.shape)} / "
                             f"{tuple(phi_k.shape)}; want (B,H,N,R)/(B,H,M,R)")
        phi_q = phi_q.float().contiguous()
        phi_k = phi_k.float().contiguous()
    if slopes is not None:
        if slopes.shape != (h,):
            raise ValueError(f"slopes shape {tuple(slopes.shape)} != ({h},)")
        slopes = slopes.float().contiguous()
    tensors = [t for t in (q, k, v, phi_q, phi_k, slopes) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: inputs on several devices")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{name} takes contiguous q, k, v")
    dv_out = dv
    if q.dtype == torch.bfloat16:
        if r > _MAX_RANK_TC:
            raise ValueError(f"rank {r} > {_MAX_RANK_TC}: the bf16 kernel "
                             f"loads a factor row in one box")
        q, k, v = (_aligned(_pad_last(t, 8)) for t in (q, k, v))
        phi_q, phi_k = _pad_last(phi_q, 4), _aligned(_pad_last(phi_k, 4))
        d, dv = q.shape[-1], v.shape[-1]
        r = 0 if phi_q is None else phi_q.shape[-1]
    if _kernel()[2](d, dv, r, _DTYPES[q.dtype]) > _SMEM_LIMIT:
        raise ValueError(f"head dims {d}/{dv} with rank {r} exceed the "
                         f"kernel's shared memory")
    out = torch.empty((b, h, n, dv), dtype=q.dtype, device=q.device)
    return (b, h, kvh, n, m, d, dv, r), (q, k, v), phi_q, phi_k, slopes, out, \
        dv_out


def _count(wrapper, dtype) -> None:
    wrapper.launches += 1
    if dtype in _kernel()[3]:
        wrapper.tensor_core_launches += 1


def flashbias_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    phi_q: Optional[torch.Tensor] = None,
    phi_k: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
    *, scale: float, mask_kind: str = "none", window: int = 0,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Kernel 1's wrapper: launches ``flashbias_attn.cu`` on CUDA tensors,
    runs the plain version on CPU tensors. Forward only."""
    if q.device.type == "cpu":
        return flashbias_attention_torch(
            q, k, v, phi_q, phi_k, slopes, scale=scale, mask_kind=mask_kind,
            window=window, kv_len=kv_len)
    dims, (q, k, v), phi_q, phi_k, slopes, out, dv = _checked(
        q, k, v, phi_q, phi_k, slopes, mask_kind, window,
        "flashbias_attention_fwd")
    m = dims[4]
    kv_len = m if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= m:
        raise ValueError(f"kv_len {kv_len} outside [0, {m}]")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(phi_q),
                       _ptr(phi_k), _ptr(slopes), out.data_ptr(),
                       _DTYPES[q.dtype], *dims, float(scale),
                       MASK_KINDS[mask_kind], int(window), kv_len, stream)
    if err != 0:
        raise RuntimeError(f"flashbias_attn.cu launch failed: CUDA error "
                           f"{err}")
    _count(flashbias_attention_fwd, q.dtype)
    return out[..., :dv].contiguous() if out.shape[-1] != dv else out


flashbias_attention_fwd.launches = 0
flashbias_attention_fwd.tensor_core_launches = 0


def flashbias_attention_ragged_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    phi_q: Optional[torch.Tensor], phi_k: Optional[torch.Tensor],
    slopes: Optional[torch.Tensor], lengths: torch.Tensor,
    *, scale: float, mask_kind: str = "none", window: int = 0,
) -> torch.Tensor:
    """Kernel 2's wrapper: row ``b`` attends to keys at positions
    ``< lengths[b]`` (combined with ``mask_kind``); a row with no allowed
    key outputs 0. ``lengths (B,)`` is never read back to the host: the
    kernel clamps it into ``[0, M]`` itself. Launches the ragged entry of
    ``flashbias_attn.cu`` on CUDA tensors, runs the plain version on CPU
    tensors. Forward only."""
    if q.device.type == "cpu":
        return flashbias_attention_torch(
            q, k, v, phi_q, phi_k, slopes, scale=scale, mask_kind=mask_kind,
            window=window, lengths=lengths)
    dims, (q, k, v), phi_q, phi_k, slopes, out, dv = _checked(
        q, k, v, phi_q, phi_k, slopes, mask_kind, window,
        "flashbias_attention_ragged_fwd")
    if lengths.shape != (dims[0],):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != "
                         f"({dims[0]},)")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(phi_q),
                       _ptr(phi_k), _ptr(slopes), lengths.data_ptr(),
                       out.data_ptr(), _DTYPES[q.dtype], *dims, float(scale),
                       MASK_KINDS[mask_kind], int(window), stream)
    if err != 0:
        raise RuntimeError(f"flashbias_attn.cu ragged launch failed: CUDA "
                           f"error {err}")
    _count(flashbias_attention_ragged_fwd, q.dtype)
    return out[..., :dv].contiguous() if out.shape[-1] != dv else out


flashbias_attention_ragged_fwd.launches = 0
flashbias_attention_ragged_fwd.tensor_core_launches = 0

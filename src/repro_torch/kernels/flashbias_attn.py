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

Kernel 1 can also write each row's log-sum-exp (``return_lse``), from which
the backward kernel (``csrc/flashbias_attn_bwd.cu``, its own library)
recomputes the probabilities: ``flashbias_attention_bwd`` and its plain
version ``flashbias_attention_bwd_torch`` take q, k, v, the output's
cotangent dO and that lse, and give the gradients of q, k, v and the
factors. The kernel takes bf16 q / k / v at widths ``bwd_width`` admits.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.attention import (DEFAULT_MASK_VALUE, eq3_folds,
                                        flashbias_concat_qk)
from repro_torch.kernels import build

__all__ = ["flashbias_attention_torch", "flashbias_attention_fwd",
           "flashbias_attention_ragged_fwd", "flashbias_attention_bwd_torch",
           "flashbias_attention_bwd", "bwd_width", "MASK_KINDS"]

MASK_KINDS = {"none": 0, "causal": 1, "local": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232_448          # dynamic shared memory a block may use (H100)
_MAX_RANK_TC = 256             # a TMA box holds at most 256 factor columns
# widths the backward kernel is built for: D, Dv and R zero-padded to one of
# them; with factors at most 96 (three accumulators of a warp's 16 rows at
# width 128 would not stay in registers)
_BWD_WIDTHS = (16, 32, 64, 96, 128)
_BWD_MAX_WIDTH_PHI = 96


def _allowed(n: int, m: int, mask_kind: str, window: int, kv_len: int,
             device, q_offset: int = 0) -> torch.Tensor:
    q_pos = torch.arange(q_offset, q_offset + n, device=device)[:, None]
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
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Plain version of the kernels: dense float32 logits and softmax.

    ``lengths (B,)`` (the ragged kernel's bound) masks row ``b``'s keys at
    positions ``>= lengths[b]`` in place of the static ``kv_len``, combined
    with the ``mask_kind`` mask. ``q_offset`` is the position of ``q``'s
    first row: ``q``, ``phi_q`` and the output are then the rows
    ``q_offset ..`` of a longer query, whose causal / local mask and ALiBi
    distances are built for these rows alone (the ``ops`` backward
    recomputes by such blocks). Differentiable. A row with no allowed key
    outputs 0, as the kernels' ``l == 0`` rows do.

    Factors fold into q and k (Eq. 3) where ``core.attention.eq3_folds``
    says it is exact, as the reference's plain path does (the kernels fold
    in the kernel).

    ``return_lse``: also each row's log-sum-exp of the masked logits,
    ``(B, H, N)`` float32 (natural log), +inf for a row with no allowed key,
    as kernel 1 writes it for the backward."""
    b, h, n, _ = q.shape
    kvh, m = k.shape[1], k.shape[2]
    if lengths is not None and kv_len is not None:
        raise ValueError("pass kv_len or lengths, not both")
    kv_len = m if kv_len is None else kv_len
    g = h // kvh
    if phi_q is not None and eq3_folds(q, phi_q, phi_k, phi_k.shape[1], kvh):
        q, k = (t.transpose(1, 2) for t in flashbias_concat_qk(
            *(t.transpose(1, 2) for t in (q, k, phi_q, phi_k)), scale))
        phi_q = phi_k = None
    kf = k.float().repeat_interleave(g, dim=1) if g > 1 else k.float()
    vf = v.float().repeat_interleave(g, dim=1) if g > 1 else v.float()
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), kf) * scale
    if phi_q is not None:
        s = s + torch.einsum("bhnr,bhmr->bhnm", phi_q.float(),
                             phi_k.float().expand(b, h, m, -1))
    if slopes is not None:
        rel = (torch.arange(m, device=q.device)[None, :]
               - torch.arange(q_offset, q_offset + n,
                              device=q.device)[:, None]).float()
        s = s + slopes.float()[:, None, None] * rel
    allowed = _allowed(n, m, mask_kind, window, kv_len, q.device,
                       q_offset)                                 # (N, M)
    if lengths is not None:
        in_range = (torch.arange(m, device=q.device)[None, :]
                    < lengths.to(q.device).reshape(-1, 1))          # (B, M)
        allowed = (allowed[None] & in_range[:, None, :])[:, None]  # B1NM
    s = torch.where(allowed, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    o = torch.einsum("bhnm,bhmd->bhnd", torch.softmax(s, dim=-1), vf)
    seen = allowed.any(dim=-1, keepdim=True)
    o = (o * seen).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1).masked_fill(~seen[..., 0], float("inf"))
    return o, lse


def _factor_needs(needs, phi_q) -> tuple:
    """``needs`` as five bools, the factors' two False without factors."""
    needs = tuple(bool(x) for x in needs)
    return needs if phi_q is not None else needs[:3] + (False, False)


def flashbias_attention_bwd_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor,
    phi_q: Optional[torch.Tensor] = None,
    phi_k: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
    *, scale: float, mask_kind: str = "none", window: int = 0,
    kv_len: Optional[int] = None, needs=(True,) * 5,
) -> tuple:
    """Plain version of the backward kernel, in float32, on the kernels'
    head-major layout: from the output's cotangent ``do`` and the forward's
    ``lse`` (``return_lse``), ``P = exp(s - lse)`` (0 where masked), ``dP =
    dO.v^T``, ``Delta = rowsum(P * dP)`` (rowsum(dO * o) for the exact
    output), ``dS = P * (dP - Delta)``; returns ``(dq, dk, dv, dphi_q,
    dphi_k)`` in the inputs' dtypes,
    None where ``needs`` (q, k, v, phi_q, phi_k) asks for none. dk and dv
    sum each kv head's group; ``dphi_k`` has ``phi_k``'s shape ``(B, H, M,
    R)``. Dense ``(B, H, N, M)`` scores: the reference at small shapes (at
    large ones ``ops._recompute_grads`` is the blocked float32 backward)."""
    b, h, n, _ = q.shape
    kvh, m = k.shape[1], k.shape[2]
    g = h // kvh
    kv_len = m if kv_len is None else kv_len
    needs = _factor_needs(needs, phi_q)
    kf = k.float().repeat_interleave(g, dim=1) if g > 1 else k.float()
    vf = v.float().repeat_interleave(g, dim=1) if g > 1 else v.float()
    qf, dof = q.float(), do.float()
    s = torch.einsum("bhnd,bhmd->bhnm", qf, kf) * scale
    if phi_q is not None:
        pqf, pkf = phi_q.float(), phi_k.float().expand(b, h, m, -1)
        s = s + torch.einsum("bhnr,bhmr->bhnm", pqf, pkf)
    if slopes is not None:
        rel = (torch.arange(m, device=q.device)[None, :]
               - torch.arange(n, device=q.device)[:, None]).float()
        s = s + slopes.float()[:, None, None] * rel
    allowed = _allowed(n, m, mask_kind, window, kv_len, q.device)
    p = torch.where(allowed, torch.exp(s - lse[..., None].float()), 0.0)
    dp = torch.einsum("bhne,bhme->bhnm", dof, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.einsum("bhnm,bhmd->bhnd", ds, kf) * scale
    dk = torch.einsum("bhnm,bhnd->bhmd", ds, qf) * scale
    dv = torch.einsum("bhnm,bhne->bhme", p, dof)
    group = lambda t: t.reshape(b, kvh, g, m, -1).sum(2) if g > 1 else t
    return (dq.to(q.dtype) if needs[0] else None,
            group(dk).to(k.dtype) if needs[1] else None,
            group(dv).to(v.dtype) if needs[2] else None,
            torch.einsum("bhnm,bhmr->bhnr", ds, pkf).to(phi_q.dtype)
            if needs[3] else None,
            torch.einsum("bhnm,bhnr->bhmr", ds, pqf).to(phi_k.dtype)
            if needs[4] else None)


@functools.cache
def _kernel():
    """The static and ragged launch functions and the shared-memory size
    function of the built library, bound once (building it on first use),
    and the dtypes its dispatch sends to the tensor-core body."""
    lib = build.load("flashbias_attn")
    fn = lib.flashbias_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
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


def _validated(q, k, v, phi_q, phi_k, slopes, mask_kind, window, name):
    """Validate a launch's inputs on any device; returns the dims, the
    (padded) q, k, v, the float32 contiguous factors and slopes and the
    output's true head dim."""
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
        q, k, v = (_pad_last(t, 8) for t in (q, k, v))
        phi_q, phi_k = _pad_last(phi_q, 4), _pad_last(phi_k, 4)
        d, dv = q.shape[-1], v.shape[-1]
        r = 0 if phi_q is None else phi_q.shape[-1]
    return (b, h, kvh, n, m, d, dv, r), (q, k, v), phi_q, phi_k, slopes, \
        dv_out


def _output(dims, q: torch.Tensor) -> torch.Tensor:
    b, h, _, n, _, _, dv, _ = dims
    return torch.empty((b, h, n, dv), dtype=q.dtype, device=q.device)


def _checked(q, k, v, phi_q, phi_k, slopes, mask_kind, window, name):
    """Validate a CUDA launch's inputs; returns the dims, the (padded) q, k,
    v, the float32 contiguous factors and slopes, the output tensor and the
    output's true head dim."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    dims, (q, k, v), phi_q, phi_k, slopes, dv_out = _validated(
        q, k, v, phi_q, phi_k, slopes, mask_kind, window, name)
    if q.dtype == torch.bfloat16:
        q, k, v, phi_k = (_aligned(t) for t in (q, k, v, phi_k))
    d, dv, r = dims[5:]
    if _kernel()[2](d, dv, r, _DTYPES[q.dtype]) > _SMEM_LIMIT:
        raise ValueError(f"head dims {d}/{dv} with rank {r} exceed the "
                         f"kernel's shared memory")
    return dims, (q, k, v), phi_q, phi_k, slopes, _output(dims, q), dv_out


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
    kv_len: Optional[int] = None, return_lse: bool = False,
):
    """Kernel 1's wrapper: launches ``flashbias_attn.cu`` on CUDA tensors,
    runs the plain version on CPU tensors. Forward only; ``return_lse``
    returns ``(o, lse)``, the rows' log-sum-exp as
    ``flashbias_attention_torch`` gives it (the backward's input)."""
    build.refuse_dtensors("flashbias_attention_fwd", q, k, v, phi_q, phi_k,
                          slopes)
    if q.device.type == "cpu":
        return flashbias_attention_torch(
            q, k, v, phi_q, phi_k, slopes, scale=scale, mask_kind=mask_kind,
            window=window, kv_len=kv_len, return_lse=return_lse)
    dims, (q, k, v), phi_q, phi_k, slopes, out, dv = _checked(
        q, k, v, phi_q, phi_k, slopes, mask_kind, window,
        "flashbias_attention_fwd")
    m = dims[4]
    kv_len = m if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= m:
        raise ValueError(f"kv_len {kv_len} outside [0, {m}]")
    lse = (torch.empty(dims[:2] + dims[3:4], dtype=torch.float32,
                       device=q.device) if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(phi_q),
                       _ptr(phi_k), _ptr(slopes), out.data_ptr(), _ptr(lse),
                       _DTYPES[q.dtype], *dims, float(scale),
                       MASK_KINDS[mask_kind], int(window), kv_len, stream)
    if err != 0:
        raise RuntimeError(f"flashbias_attn.cu launch failed: CUDA error "
                           f"{err}")
    _count(flashbias_attention_fwd, q.dtype)
    out = out[..., :dv].contiguous() if out.shape[-1] != dv else out
    return (out, lse) if return_lse else out


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
    build.refuse_dtensors("flashbias_attention_ragged_fwd", q, k, v, phi_q,
                          phi_k, slopes, lengths)
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


def bwd_width(d: int, dv: int, r: int) -> Optional[int]:
    """The width P the backward kernel runs at (D, Dv and R zero-padded to
    it, which changes no gradient), or None where its tiles and accumulators
    would not fit: a width over 128, or over 96 with factors (r > 0). Such a
    shape takes ``ops``' plain recompute."""
    need = max(d, dv, r)
    limit = _BWD_MAX_WIDTH_PHI if r else _BWD_WIDTHS[-1]
    return next((p for p in _BWD_WIDTHS if need <= p <= limit), None)


@functools.cache
def _bwd_kernel():
    """The backward kernel's launch function, bound once (building its
    library on first use), and its row block, to which lse2 and delta are
    padded."""
    lib = build.load("flashbias_attn_bwd")
    fn = lib.flashbias_attn_bwd
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flashbias_attn_bwd_rows.restype = ctypes.c_int
    return fn, lib.flashbias_attn_bwd_rows()


def _padded(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` zero-padded to ``width`` columns, contiguous, 16-byte aligned."""
    t = t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))
    return _aligned(t.contiguous())


def _split(phi: Optional[torch.Tensor], width: int):
    """Float32 factors as bf16 hi = bf16(x) and lo = bf16(x - hi), padded to
    ``width``: the two parts of the three-product split (hi.hi + hi.lo +
    lo.hi), rounded as kernel 1 rounds them."""
    if phi is None:
        return None, None
    x = _padded(phi.float(), width)
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def flashbias_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor,
    phi_q: Optional[torch.Tensor] = None,
    phi_k: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
    *, scale: float, mask_kind: str = "none", window: int = 0,
    kv_len: Optional[int] = None, needs=(True,) * 5,
) -> tuple:
    """The backward kernel's wrapper: on CUDA tensors launches
    ``flashbias_attn_bwd.cu`` (its delta pass, then its key-major pass where
    ``needs`` asks for k, v or phi_k and its query-major pass for q or
    phi_q; ``.device_kernels`` counts them), on CPU tensors runs
    ``flashbias_attention_bwd_torch``; the arguments and the result as
    there. The factors' hi / lo split is a small elementwise pass here; lse
    goes in as lse * log2(e) (the kernel's exponentials are base 2),
    padded with +inf to a multiple of the kernel's row block (which the
    library reports). Takes bf16 q, k, v (and dO) at widths ``bwd_width``
    admits and raises on anything else."""
    build.refuse_dtensors("flashbias_attention_bwd", q, k, v, do, lse,
                          phi_q, phi_k, slopes)
    kw = dict(scale=scale, mask_kind=mask_kind, window=window, kv_len=kv_len,
              needs=_factor_needs(needs, phi_q))
    if q.device.type == "cpu":
        return flashbias_attention_bwd_torch(q, k, v, do, lse, phi_q, phi_k,
                                             slopes, **kw)
    b, h, n, d = q.shape
    kvh, m, dv = k.shape[1], k.shape[2], v.shape[-1]
    r = 0 if phi_q is None else phi_q.shape[-1]
    width = bwd_width(d, dv, r)
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flashbias_attention_bwd takes bf16 q, k, v, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if width is None:
        raise ValueError(f"widths D {d}, Dv {dv}, R {r}: over the backward "
                         f"kernel's limit")
    if mask_kind not in MASK_KINDS or (mask_kind == "local" and window < 1):
        raise ValueError(f"mask {mask_kind!r} window {window}")
    if h % kvh or do.shape != (b, h, n, dv) or lse.shape != (b, h, n):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, dO {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}")
    kv_len = m if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= m:
        raise ValueError(f"kv_len {kv_len} outside [0, {m}]")
    dev = q.device
    launch, block = _bwd_kernel()
    n_pad = -(-n // block) * block
    lse2 = F.pad(lse.float() * math.log2(math.e), (0, n_pad - n),
                 value=float("inf")).contiguous()
    delta = torch.zeros((b, h, n_pad), dtype=torch.float32, device=dev)
    qp, kp, vp, dop = (_padded(t.to(torch.bfloat16), width)
                       for t in (q, k, v, do))
    pq_hi, pq_lo = _split(phi_q, width)
    pk_hi, pk_lo = _split(phi_k, width)
    if slopes is not None:
        slopes = slopes.detach().float().contiguous()
    needs = kw["needs"]
    keys = needs[1] or needs[2] or needs[4]
    empty = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
    dq = empty((b, h, n, width), torch.bfloat16) \
        if needs[0] or needs[3] else None
    dk = empty((b, kvh, m, width), torch.bfloat16) if keys else None
    dvo = empty((b, kvh, m, width), torch.bfloat16) if keys else None
    dpq = empty((b, h, n, width), torch.float32) if needs[3] else None
    dpk = empty((b, h, m, width), torch.float32) if needs[4] else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), dop.data_ptr(),
        *(_ptr(t) for t in (pq_hi, pq_lo, pk_hi, pk_lo)), lse2.data_ptr(),
        delta.data_ptr(), _ptr(slopes),
        *(_ptr(t) for t in (dq, dk, dvo, dpq, dpk)),
        b, h, kvh, n, m, n_pad, width, float(scale), MASK_KINDS[mask_kind],
        int(window), kv_len, stream)
    if err != 0:
        raise RuntimeError(f"flashbias_attn_bwd.cu launch failed: CUDA error "
                           f"{err}")
    flashbias_attention_bwd.launches += 1
    flashbias_attention_bwd.device_kernels += 1 + keys + (dq is not None)
    cut = lambda t, c, dt: None if t is None else t[..., :c].to(dt)
    return (cut(dq, d, q.dtype) if needs[0] else None,
            cut(dk, d, k.dtype) if needs[1] else None,
            cut(dvo, dv, v.dtype) if needs[2] else None,
            cut(dpq, r, phi_q.dtype) if needs[3] else None,
            cut(dpk, r, phi_k.dtype) if needs[4] else None)


flashbias_attention_bwd.launches = 0
flashbias_attention_bwd.device_kernels = 0

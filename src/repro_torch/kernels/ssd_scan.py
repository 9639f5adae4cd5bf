"""Mamba2 SSD chunk scan: the Hopper CUDA kernel (``csrc/ssd_scan.cu``) and
its plain PyTorch version.

Port of ``repro.kernels.ssd_scan.ssd_scan_fwd``. Layout is the TPU
kernel's: x ``(B, H, S, P)``, dt ``(B, H, S)`` or ``(B, H, S, 1)`` (already
softplus'd, > 0), a ``(H,)`` or ``(H, 1)`` negative decay rates, b / c
``(B, 1|H, S, N)`` (one group is read for every head). Both versions
return ``(y, h_fin)``: y ``(B, H, S, P)`` in x's dtype and the final state
``(B, H, P, N)`` in float32; ``h0`` seeds the state (zeros when None).
Where the TPU kernel needs ``S % chunk == 0``, the kernel bounds the last
chunk by its length and the plain version pads it with ``dt = 0``, which
computes the same.

``ssd_scan_fwd`` (kernel 5) counts its calls (``.launches``), the calls
that took the tensor-core body (``.tensor_core_launches``) and the device
kernels it launched (``.device_kernels``: four per tensor-core call with
one b/c group, three with per-head b / c, one on the CUDA-core body). On a
CUDA tensor it launches the kernel (or raises); on a CPU tensor it runs
``ssd_scan_torch``. The kernel reads x and writes y through their strides,
so the model hands it ``(B, S, H, P)`` tensors as transposed views, and y
comes back in x's memory layout. The tensor-core body's scratch (the chunk
states, their decays, and operand tiles already split into bf16 hi + lo:
the states before each chunk, x^T and, with one b/c group, c and b^T,
beside the c.b^T tiles; 302 MB at the SSM prefill shape) is allocated
here per call with ``torch.empty``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

__all__ = ["ssd_scan_torch", "ssd_scan_fwd"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SCRATCH = 7                      # scratch arrays of the tensor-core body


def _flat(dt: torch.Tensor, a: torch.Tensor):
    """dt as ``(B, H, S)`` and a as ``(H,)``, float32."""
    if dt.dim() == 4:
        dt = dt[..., 0]
    return dt.float(), a.reshape(-1).float()


def ssd_scan_torch(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, *, chunk: int = 256,
                   h0: Optional[torch.Tensor] = None):
    """Plain version of the kernel: the model's plain scan
    (``models.ssd.ssd_scan``, the reference's algorithm) in float32 on the
    kernel's layout. x and dt are seen as ``(B, S, H, ...)``; b / c with
    one group are read once for every head, per-head b / c are scanned one
    head at a time."""
    # imported here: the models package imports this module
    from repro_torch.models import ssd
    dt, a = _flat(dt, a)
    xf, dt = x.float().transpose(1, 2), dt.transpose(1, 2)
    h0 = None if h0 is None else h0.float()
    if b.shape[1] == 1:
        y, h_fin = ssd.ssd_scan(xf, dt, a, b[:, 0].float(), c[:, 0].float(),
                                chunk=chunk, h0=h0)
    else:
        parts = [ssd.ssd_scan(xf[:, :, i:i + 1], dt[:, :, i:i + 1],
                              a[i:i + 1], b[:, i].float(), c[:, i].float(),
                              chunk=chunk,
                              h0=None if h0 is None else h0[:, i:i + 1])
                 for i in range(x.shape[1])]
        y = torch.cat([y for y, _ in parts], dim=2)
        h_fin = torch.cat([h for _, h in parts], dim=1)
    return y.transpose(1, 2).to(x.dtype), h_fin


@functools.cache
def _kernel():
    """The launch and plan functions of the built library, bound once
    (building it on first use)."""
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    plan = lib.ssd_scan_plan
    plan.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    plan.restype = ctypes.c_int
    return fn, plan


def _strides3(t: torch.Tensor):
    return [t.stride(0), t.stride(1), t.stride(2)]


def _pairs_aligned(t: torch.Tensor) -> bool:
    """Whether the kernel can read t in pairs of adjacent elements: a unit
    last stride, even strides on the other axes longer than 1 and an
    address aligned to a pair."""
    return (t.stride(-1) == 1
            and all(st % 2 == 0 for st, size in zip(t.stride()[:-1],
                                                     t.shape[:-1]) if size > 1)
            and t.data_ptr() % (2 * t.element_size()) == 0)


def _validated(x, dt, a, b, c, h0, chunk):
    """Validate a launch's inputs on any device; returns (B, H, S, P, N,
    groups) and dt, a, b, c, h0 as the kernel reads them (dt and a
    flattened, b, c and h0 in float32)."""
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"x {tuple(x.shape)} {x.dtype}: the kernel takes a "
                         f"(B, H, S, P) float32 or bfloat16 tensor")
    bsz, h, s, p = x.shape
    dt, a = _flat(dt, a)
    if dt.shape != (bsz, h, s) or a.shape != (h,):
        raise ValueError(f"dt {tuple(dt.shape)} / a {tuple(a.shape)} do not "
                         f"match x {tuple(x.shape)}")
    b, c = b.float(), c.float()
    n = b.shape[-1]
    g = b.shape[1]
    for name, t in (("b", b), ("c", c)):
        if t.dim() != 4 or t.shape[0] != bsz or t.shape[2] != s \
                or t.shape[1] != g or t.shape[3] != n or g not in (1, h):
            raise ValueError(f"{name} {tuple(t.shape)}: want (B, 1|H, S, N) "
                             f"against x {tuple(x.shape)}")
    if p % 4 or n % 4:
        raise ValueError(f"P {p} and N {n} must be multiples of 4")
    if chunk < 1:
        raise ValueError(f"chunk {chunk} < 1")
    if h0 is not None:
        if h0.shape != (bsz, h, p, n):
            raise ValueError(f"h0 {tuple(h0.shape)} != {(bsz, h, p, n)}")
        h0 = h0.float().contiguous()
    a = a.contiguous()
    if any(t.device != x.device for t in (dt, a, b, c)):
        raise ValueError("ssd_scan_fwd: inputs on several devices")
    return (bsz, h, s, p, n, g), dt, a, b, c, h0


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, *, chunk: int = 256,
                 h0: Optional[torch.Tensor] = None):
    """Kernel 5's wrapper: launches ``ssd_scan.cu`` on CUDA tensors, runs the
    plain version on CPU tensors. x and y may be strided views whose last
    (P) axis has unit stride; b and c may be strided or broadcast over the
    head axis with a unit-stride last (N) axis."""
    build.refuse_dtensors("ssd_scan_fwd", x, dt, a, b, c, h0)
    if x.device.type == "cpu":
        return ssd_scan_torch(x, dt, a, b, c, chunk=chunk, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_fwd: no kernel for device {x.device}")
    (bsz, h, s, p, n, g), dt, a, b, c, h0 = _validated(x, dt, a, b, c, h0,
                                                       chunk)
    x, b, c = (t if _pairs_aligned(t) else t.contiguous() for t in (x, b, c))
    if h0 is not None and h0.data_ptr() % 16:   # read four floats at a time
        h0 = h0.clone()
    fn, plan = _kernel()
    y = torch.empty_like(x)           # x's memory layout, unit P stride
    h_fin = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    dims = (ctypes.c_int * 7)(bsz, h, s, p, n, g, chunk)
    sizes = (ctypes.c_longlong * _SCRATCH)()
    tensor_core = bool(plan(dims, sizes))
    # chunk states, decays, split states before each chunk, split x^T
    # tiles; with one b/c group c.b^T tiles and split c and b^T tiles
    scratch = [torch.empty((k,), dtype=torch.float32, device=x.device)
               if k else None for k in sizes]
    strides = (ctypes.c_longlong * 15)(
        *_strides3(x), *_strides3(dt), *_strides3(b), *_strides3(c),
        *_strides3(y))
    launched = ctypes.c_int(0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
             c.data_ptr(), None if h0 is None else h0.data_ptr(),
             y.data_ptr(), h_fin.data_ptr(), _DTYPES[x.dtype], dims, strides,
             (ctypes.c_void_p * _SCRATCH)(
                 *(None if t is None else t.data_ptr() for t in scratch)),
             ctypes.byref(launched), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan.cu launch failed: CUDA error {err} "
                           f"(P {p}, N {n}, chunk {chunk}, "
                           f"{'tensor-core' if tensor_core else 'CUDA-core'} "
                           f"body; a shared-memory request over the block's "
                           f"limit fails here)")
    ssd_scan_fwd.launches += 1
    ssd_scan_fwd.tensor_core_launches += tensor_core
    ssd_scan_fwd.device_kernels += launched.value
    return y, h_fin


ssd_scan_fwd.launches = 0
ssd_scan_fwd.tensor_core_launches = 0
ssd_scan_fwd.device_kernels = 0

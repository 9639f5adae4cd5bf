"""Public entry points the models call: ``flash_attention`` (prefill /
training), ``flash_decode`` (one token against a KV cache) and ``ssd_scan``
(the Mamba2 SSD chunk scan of an SSM prefill).

Port of ``repro.kernels.ops``. Implementations:

- ``"cuda"`` (the reference's ``"pallas"``): the hand-written Hopper
  kernels through their wrappers — on a CUDA tensor the kernel runs or the
  call raises; on a CPU tensor the wrapper runs the plain version.
- ``"torch"`` (the reference's ``"xla"``): the plain PyTorch versions, on
  any device. On a CUDA tensor this is taken only when asked for by name.
- ``"auto"``: ``"cuda"`` for a CUDA tensor, ``"torch"`` for a CPU tensor.

``ssd_scan`` is stricter: ``"cuda"`` on a tensor that is not on the card
raises, as the kernel has no CPU form.

Cache layout contract (the decode hot path): caches are stored kv-head-major
per layer (the reference's ``kv_layout="bhsd"``) — contiguous ``(B, KVH, S,
hd)``, paged pools ``(KVH, n_pages, ps, hd)`` with a ``(n_pages, ps, R)``
float32 factor slab — and handed to the kernels zero-copy. The port stores
``hd`` and ``R`` unpadded: the 128-lane pads of the reference are TPU tile
constraints.

``flash_attention`` is differentiable: a ``torch.autograd.Function`` whose
backward recomputes the forward through the plain path and differentiates
that (flash-style recompute, as the reference's ``_bwd`` does with its XLA
path). There is no backward kernel, as there is none on the TPU. With
``lengths`` (the ragged batch of the Pairformer serve path) the call runs
outside that Function, as the reference's ``_flash_attention_ragged`` does:
the plain path is differentiable by itself, the ragged kernel forward only.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.flash_decode import (
    flash_decode_fwd,
    flash_decode_paged_fwd,
    flash_decode_paged_torch,
    flash_decode_torch,
)
from repro_torch.kernels.flashbias_attn import (
    flashbias_attention_fwd,
    flashbias_attention_ragged_fwd,
    flashbias_attention_torch,
)
from repro_torch.kernels.ssd_scan import ssd_scan_fwd

__all__ = ["flash_attention", "flash_decode", "ssd_scan", "resolve_impl",
           "IMPLS"]

IMPLS = ("torch", "cuda")


def resolve_impl(impl: str, device: torch.device) -> str:
    """``"auto"`` -> ``"cuda"`` on a CUDA device, ``"torch"`` elsewhere."""
    if impl == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS + ('auto',)}")
    return impl


class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel (or the plain version); backward through
    the plain version's autograd, recomputing the forward."""

    @staticmethod
    def forward(ctx, q, k, v, phi_q, phi_k, slopes, mask_kind, window, scale,
                impl):
        ctx.save_for_backward(q, k, v, phi_q, phi_k, slopes)
        ctx.opts = {"mask_kind": mask_kind, "window": window, "scale": scale}
        fn = (flashbias_attention_torch if impl == "torch"
              else flashbias_attention_fwd)
        return fn(q, k, v, phi_q, phi_k, slopes, **ctx.opts)

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            out = flashbias_attention_torch(*leaves, **ctx.opts)
            wrt = [t for t, need in zip(leaves, needs)
                   if t is not None and need]
            grads = iter(torch.autograd.grad(out, wrt, grad_out))
        res = [next(grads) if t is not None and need else None
               for t, need in zip(leaves, needs)]
        return (*res, None, None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    phi_q: Optional[torch.Tensor] = None,
    phi_k: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,
    *,
    mask_kind: str = "none",
    window: int = 0,
    scale: Optional[float] = None,
    impl: str = "auto",
    layout: str = "bshd",
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """FlashBias attention.

    ``layout="bshd"``: canonical ``(B, N, H, D)`` q and ``(B, M, KVH, D)``
    k/v in and out, factors ``phi_q (B, N, H, R)``, ``phi_k (B, M, 1|KVH|H,
    R)``. ``layout="bhsd"``: the kernel's head-major ``(B, H, N, D)``,
    factors ``phi_q (B, H, N, R)``, ``phi_k (B, 1|KVH|H, M, R)``.
    Exactly one of {phi_q+phi_k, slopes ``(H,)``, neither} selects the bias
    mode (factored / in-kernel ALiBi / none). Differentiable in q, k, v and
    the factors.

    ``lengths (B,)`` takes the ragged path: row b attends only to keys at
    positions ``< lengths[b]`` (the serve engine's padded wave of
    variable-length requests); rows with length 0 output zeros. The
    ``"cuda"`` impl is then forward only and raises if an input requires
    grad; ``lengths`` is never read back to the host.
    """
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"layout {layout!r}")
    if phi_q is not None and slopes is not None:
        raise ValueError("pass factors or slopes, not both")
    scale = (1.0 / float(np.sqrt(q.shape[-1]))) if scale is None else scale
    impl = resolve_impl(impl, q.device)
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        if phi_q is not None:
            phi_q, phi_k = phi_q.transpose(1, 2), phi_k.transpose(1, 2)
    b, h, n, _ = q.shape
    if phi_q is not None:
        m, r = k.shape[2], phi_k.shape[-1]
        if phi_k.shape[1] not in (1, h):       # per-kv-head: expand per group
            if h % phi_k.shape[1]:
                raise ValueError(f"phi_k heads {phi_k.shape[1]} vs {h}")
            phi_k = phi_k.repeat_interleave(h // phi_k.shape[1], dim=1)
        phi_k = phi_k.expand(b, h, m, r)
    if lengths is not None:
        o = _flash_attention_ragged(q, k, v, phi_q, phi_k, slopes, lengths,
                                    mask_kind, window, scale, impl)
        return o.transpose(1, 2) if layout == "bshd" else o
    o = _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                              phi_q, phi_k, slopes, mask_kind, window, scale,
                              impl)
    return o.transpose(1, 2) if layout == "bshd" else o


def _flash_attention_ragged(q, k, v, phi_q, phi_k, slopes, lengths,
                            mask_kind, window, scale, impl):
    """The ragged path (head-major inputs): the plain version, or kernel 2
    forward only."""
    lengths = torch.as_tensor(lengths, device=q.device).to(torch.int32)
    kw = {"scale": scale, "mask_kind": mask_kind, "window": window}
    if impl == "torch":
        return flashbias_attention_torch(q, k, v, phi_q, phi_k, slopes,
                                         lengths=lengths, **kw)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, phi_q, phi_k, slopes)):
        raise RuntimeError("the ragged attention kernel is forward only: "
                           "use impl='torch' to differentiate")
    return flashbias_attention_ragged_fwd(q.contiguous(), k.contiguous(),
                                          v.contiguous(), phi_q, phi_k,
                                          slopes, lengths, **kw)


def _static_page_cap(lengths: torch.Tensor, ps: int, width: int,
                     max_pages: Optional[int]) -> int:
    """Bound on the pages any row references this step, for the plain
    path's gather: an explicit ``max_pages`` (the serve engine derives one
    from its host-side length mirror), else ``ceil(max(lengths)/ps)`` when
    the lengths lie on the CPU, else the table's full width — never a read
    back from the card."""
    if max_pages is not None:
        return max(1, min(int(max_pages), width))
    if lengths.device.type != "cpu":
        return width
    longest = int(lengths.max()) if lengths.numel() else 0
    return max(1, min(-(-longest // ps), width))


def flash_decode(
    q: torch.Tensor,                        # (B, 1, H, D)
    k_cache: torch.Tensor,                  # (B, KVH, S, D) | (KVH, n_pages, ps, D)
    v_cache: torch.Tensor,                  # (B, KVH, S, Dv) | (KVH, n_pages, ps, Dv)
    lengths: torch.Tensor,                  # (B,) int
    phi_q: Optional[torch.Tensor] = None,   # (B, 1, H|KVH, R)
    phi_k: Optional[torch.Tensor] = None,   # (B, KVH, S, R) | paged slab
    slopes: Optional[torch.Tensor] = None,  # (H,)
    *,
    scale: Optional[float] = None,
    impl: str = "auto",
    page_table: Optional[torch.Tensor] = None,   # (B, P) int32 -> paged
    max_pages: Optional[int] = None,
    k_new: Optional[torch.Tensor] = None,        # (B, KVH, D)
    v_new: Optional[torch.Tensor] = None,        # (B, KVH, Dv)
) -> torch.Tensor:
    """Single-token decode against a kernel-layout cache (the reference's
    ``kv_layout="bhsd"``). Returns ``(B, 1, H, Dv)``. The query of row ``b``
    sits at position ``lengths[b]-1``; rows with length 0 output 0.

    With ``page_table`` the caches are a shared page pool ``(KVH, n_pages,
    ps, *)``: ``page_table[b, j]`` maps row b's logical block j to its
    physical page, and entries past the mapped prefix may hold anything
    (they are clamped and length-masked). ``phi_k`` is then the factor slab
    ``(n_pages, ps, R)`` shared by every kv head, or ``(1|KVH, n_pages, ps,
    R)``. The plain path gathers each row's logical view, capped at
    ``max_pages`` pages (see ``_static_page_cap``); the kernel reads only
    live rows and needs no cap.

    With ``k_new`` and ``v_new`` (the new token's rows, in the cache's
    dtype) the call first writes them in place at position ``lengths[b]-1``
    of every row with ``lengths[b] > 0`` (paged: where ``paged_write_plan``
    puts them; a page outside the pool drops the write), then attends: the
    kernel does both in one launch."""
    b, _, h, d = q.shape
    kvh = k_cache.shape[0] if page_table is not None else k_cache.shape[1]
    if h % kvh:
        raise ValueError(f"{h} heads do not group over {kvh} kv heads")
    g = h // kvh
    scale = (1.0 / float(np.sqrt(d))) if scale is None else scale
    impl = resolve_impl(impl, q.device)
    qg = q[:, 0].reshape(b, kvh, g, d).contiguous()
    pq = None
    if phi_q is not None:
        if phi_q.shape[2] == kvh and kvh != h:   # shared within each group
            phi_q = phi_q.repeat_interleave(g, dim=2)
        pq = phi_q[:, 0].reshape(b, kvh, g, -1)
    sl = None if slopes is None else slopes.reshape(kvh, g)
    lengths = lengths.to(torch.int32).contiguous()
    new = {}
    if k_new is not None:
        new = {"k_new": k_new.contiguous(), "v_new": v_new.contiguous()}
    if page_table is None:
        fn = flash_decode_torch if impl == "torch" else flash_decode_fwd
        o = fn(qg, k_cache, v_cache, lengths, pq, phi_k, sl, scale=scale,
               **new)
        return o.reshape(b, 1, h, v_cache.shape[-1])
    if phi_k is not None and phi_k.dim() == 3:   # shared slab, no copy
        phi_k = phi_k[None]
    pt = page_table.to(torch.int32).contiguous()
    if impl == "torch":
        cap = _static_page_cap(lengths, k_cache.shape[2], pt.shape[1],
                               max_pages)
        o = flash_decode_paged_torch(qg, k_cache, v_cache, lengths, pt, pq,
                                     phi_k, sl, scale=scale, max_pages=cap,
                                     **new)
    else:
        o = flash_decode_paged_fwd(qg, k_cache, v_cache, lengths, pt, pq,
                                   phi_k, sl, scale=scale, **new)
    return o.reshape(b, 1, h, v_cache.shape[-1])


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 256,
             h0: Optional[torch.Tensor] = None, impl: str = "auto"):
    """Mamba2 SSD chunk scan in the model's layout: x ``(B, S, H, P)``, dt
    ``(B, S, H)``, a ``(H,)``, b / c ``(B, S, N)`` (one group), h0 ``(B, H,
    P, N)`` or None. Returns ``(y (B, S, H, P), h_fin (B, H, P, N))``.

    ``"torch"`` runs ``models.ssd.ssd_scan`` (the reference's algorithm);
    ``"cuda"`` launches kernel 5 on transposed views of x and y and a
    head-broadcast view of b and c, so nothing is copied, and raises for a
    tensor that is not on the card."""
    impl = resolve_impl(impl, x.device)
    if impl == "torch":
        # imported here: the models package imports this module
        from repro_torch.models import ssd
        return ssd.ssd_scan(x, dt, a, b, c, chunk=chunk, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan impl='cuda' needs a CUDA tensor, got "
                         f"{x.device}")
    y, h_fin = ssd_scan_fwd(x.transpose(1, 2), dt.transpose(1, 2), a,
                            b[:, None], c[:, None], chunk=chunk, h0=h0)
    return y.transpose(1, 2), h_fin

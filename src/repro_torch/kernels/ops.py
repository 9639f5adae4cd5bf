"""Public entry points the models call: ``flash_attention`` (prefill /
training), ``flash_decode`` (one token against a KV cache),
``flash_chunk_attention`` (a prefill chunk against a KV cache) and
``ssd_scan`` (the Mamba2 SSD chunk scan of an SSM prefill).

Port of ``repro.kernels.ops``. Implementations:

- ``"cuda"`` (the reference's ``"pallas"``): the hand-written Hopper
  kernels through their wrappers — on a CUDA tensor the kernel runs or the
  call raises; on a CPU tensor the wrapper runs the plain version.
- ``"torch"`` (the reference's ``"xla"``): the plain PyTorch versions, on
  any device. On a CUDA tensor this is taken only when asked for by name.
- ``"auto"``: ``"cuda"`` for a CUDA tensor, ``"torch"`` for a CPU tensor.
- ``"io_stub"`` (the dry run's only, as in the reference): the ``"cuda"``
  route on any device, each kernel wrapper replaced by its stub in
  ``kernels.io_stub``, which validates and allocates as the wrapper does
  and records the kernel's calls, bytes and FLOPs in place of the launch;
  the outputs are left unwritten. ``flash_attention``'s backward stays
  the plain recompute (the backward kernel has no stub yet).

``ssd_scan`` is stricter: ``"cuda"`` on a tensor that is not on the card
raises, as the kernel has no CPU form.

Cache layout contract (the decode hot path): the models store caches
kv-head-major per layer — contiguous ``(B, KVH, S, hd)``, paged pools
``(KVH, n_pages, ps, hd)`` with a ``(n_pages, ps, R)`` float32 factor slab
— and pass ``kv_layout="bhsd"``, which hands them to the kernels
zero-copy. The default, as in the reference, is the canonical
``kv_layout="bshd"`` (``(B, S, KVH, hd)``, pools ``(n_pages, ps, KVH,
hd)``) of a direct caller, adapted per call. The port stores ``hd`` and
``R`` unpadded: the 128-lane pads of the reference are TPU tile
constraints.

``flash_attention`` and ``ssd_scan`` are differentiable: each is a
``torch.autograd.Function``. ``flash_attention``'s backward takes one of
two routes (``backward_route``, chosen from the impl, q's dtype, which
inputs need a gradient and the widths, when the forward runs):

- ``"kernel"``: bf16 inputs on the ``"cuda"`` impl, no gradient asked of
  the slopes, widths the kernel fits. The forward (kernel 1) also writes
  each row's log-sum-exp, saved with the inputs, and the backward kernel
  (``flashbias_attention_bwd``, ``csrc/flashbias_attn_bwd.cu``) recomputes
  the probabilities from it and writes the gradients: the one backward
  kernel of the port, where the TPU recomputes through XLA.
- ``"recompute"`` (everything else: float32 inputs, the ``"torch"`` and
  ``"io_stub"`` impls, slopes that need a gradient, wider shapes): the
  forward recomputed through the plain path and differentiated
  (flash-style recompute, as the reference's ``_bwd`` does with its XLA
  path), by blocks of query rows, each block's float32 scores under
  ``BWD_SCORE_BYTES`` (one block wherever the whole scores fit): the plain
  path's ``(B, H, N, M)`` scores of the PDE solver's 32186 points would be
  33 GB a tensor.

``ssd_scan``'s backward recomputes the scan through its plain version
(there is no backward kernel for it, as there is none on the TPU). With
``lengths`` (the ragged batch of the Pairformer serve path)
``flash_attention`` runs outside that Function, as the reference's
``_flash_attention_ragged`` does: the plain path is differentiable by
itself, the ragged kernel forward only.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.attention import DEFAULT_MASK_VALUE
from repro_torch.kernels import io_stub
from repro_torch.kernels.flash_decode import (
    expand_groups,
    flash_decode_fwd,
    flash_decode_paged_fwd,
    flash_decode_paged_torch,
    flash_decode_torch,
    write_paged_row,
    write_row,
)
from repro_torch.kernels.flashbias_attn import (
    bwd_width,
    flashbias_attention_bwd,
    flashbias_attention_fwd,
    flashbias_attention_ragged_fwd,
    flashbias_attention_torch,
)
from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_torch
from repro_torch.spans import span

__all__ = ["flash_attention", "flash_decode", "flash_chunk_attention",
           "ssd_scan", "resolve_impl", "backward_route", "IMPLS"]

IMPLS = ("torch", "cuda", "io_stub")

# float32 scores of one query block of ``_FlashAttention.backward``'s
# recompute, (B, H, rows, M) x 4 bytes, stay at or under this
BWD_SCORE_BYTES = 2 << 30


def resolve_impl(impl: str, device: torch.device) -> str:
    """``"auto"`` -> ``"cuda"`` on a CUDA device, ``"torch"`` elsewhere."""
    if impl == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS + ('auto',)}")
    return impl


def backward_route(impl: str, dtype: torch.dtype, needs, d: int, dv: int,
                   r: int) -> str:
    """The route of ``_FlashAttention``'s backward for a resolved ``impl``,
    q's ``dtype``, ``needs`` (whether q, k, v, phi_q, phi_k and the slopes
    need a gradient) and the widths D, Dv and R (0 without factors):
    ``"kernel"`` for bf16 on ``"cuda"`` with a gradient asked of q, k, v or
    the factors and none of the slopes, at widths the backward kernel fits
    (``bwd_width``); ``"recompute"`` otherwise."""
    if impl != "cuda" or dtype != torch.bfloat16 or needs[5] \
            or not any(needs[:5]):
        return "recompute"
    return "recompute" if bwd_width(d, dv, r) is None else "kernel"


class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel (or the plain version); backward on the
    route ``backward_route`` picks: the backward kernel, from the rows'
    log-sum-exp the forward saved, or the plain version's
    autograd, recomputing the forward by query blocks
    (``backward_block_rows``)."""

    @staticmethod
    def forward(ctx, q, k, v, phi_q, phi_k, slopes, mask_kind, window, scale,
                impl):
        ctx.opts = {"mask_kind": mask_kind, "window": window, "scale": scale}
        ctx.route = backward_route(
            impl, q.dtype, ctx.needs_input_grad[:6], q.shape[-1],
            v.shape[-1], 0 if phi_q is None else phi_q.shape[-1])
        if ctx.route == "kernel":
            o, lse = flashbias_attention_fwd(q, k, v, phi_q, phi_k, slopes,
                                             return_lse=True, **ctx.opts)
            ctx.save_for_backward(q, k, v, phi_q, phi_k, slopes, lse)
            return o
        ctx.save_for_backward(q, k, v, phi_q, phi_k, slopes)
        fn = {"torch": flashbias_attention_torch,
              "io_stub": io_stub.flashbias_attention_fwd}.get(
                  impl, flashbias_attention_fwd)
        return fn(q, k, v, phi_q, phi_k, slopes, **ctx.opts)

    @staticmethod
    def backward(ctx, grad_out):
        with span("repro_torch.attn.bwd"):
            saved = ctx.saved_tensors  # unpacked once: remat allows no more
            needs = ctx.needs_input_grad[:6]
            if ctx.route == "kernel":
                q, k, v, phi_q, phi_k, slopes, lse = saved
                grads = flashbias_attention_bwd(
                    q, k, v, grad_out, lse, phi_q, phi_k, slopes,
                    needs=needs[:5], **ctx.opts)
                return (*grads, None, None, None, None, None)
            q, k = saved[:2]
            rows = backward_block_rows(q.shape[0], q.shape[1], q.shape[2],
                                       k.shape[2])
            return (*_recompute_grads(saved, needs, ctx.opts, grad_out, rows),
                    None, None, None, None)


def backward_block_rows(b: int, h: int, n: int, m: int) -> int:
    """Query rows per block of ``_FlashAttention.backward``'s recompute:
    all ``n`` where the float32 ``(b, h, n, m)`` scores fit in
    ``BWD_SCORE_BYTES``, else as many as do (at least one)."""
    return max(1, min(n, BWD_SCORE_BYTES // max(1, b * h * m * 4)))


def _recompute_grads(saved, needs, opts, grad_out, rows: int) -> list:
    """Gradients of the plain attention, recomputed ``rows`` query rows at
    a time (one block where ``rows`` covers N): each block's rows of ``q``
    and ``phi_q`` get their own gradient; those of ``k``, ``v``, ``phi_k``
    and ``slopes`` add up over the blocks. Every input is differentiated as
    a float32 copy (the plain version computes in float32 anyway) and its
    gradient cast back once, so a bf16 input's gradient is rounded once,
    not per block. A ``phi_k`` broadcast over heads or batch gets a
    gradient of the broadcast shape, which autograd sums back into the
    caller's factor."""
    f32 = [None if t is None else t.detach().float() for t in saved]
    shared = {i: f32[i].requires_grad_(needs[i]) for i in (1, 2, 4, 5)
              if f32[i] is not None}
    n = saved[0].shape[2]
    sums = {i: None for i in shared}
    parts = {0: [], 3: []}
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        block = {i: f32[i][:, :, lo:hi].detach().requires_grad_(needs[i])
                 for i in (0, 3) if f32[i] is not None}
        leaves = [block.get(i, shared.get(i)) for i in range(6)]
        wrt = [i for i in range(6) if leaves[i] is not None and needs[i]]
        with torch.enable_grad():
            out = flashbias_attention_torch(*leaves, q_offset=lo, **opts)
            grads = torch.autograd.grad(out, [leaves[i] for i in wrt],
                                        grad_out[:, :, lo:hi].float())
        for i, g in zip(wrt, grads):
            if i in parts:
                parts[i].append(g)
            else:
                sums[i] = g if sums[i] is None else sums[i] + g
    res = [None] * 6
    for i in wrt:
        g = torch.cat(parts[i], dim=2) if i in parts else sums[i]
        res[i] = g.to(saved[i].dtype)
    return res


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
    with span("repro_torch.attn.fwd"):
        if layout not in ("bshd", "bhsd"):
            raise ValueError(f"layout {layout!r}")
        if phi_q is not None and slopes is not None:
            raise ValueError("pass factors or slopes, not both")
        scale = (1.0 / float(np.sqrt(q.shape[-1]))) if scale is None \
            else scale
        impl = resolve_impl(impl, q.device)
        if layout == "bshd":
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            if phi_q is not None:
                phi_q, phi_k = phi_q.transpose(1, 2), phi_k.transpose(1, 2)
        b, h, n, _ = q.shape
        if phi_q is not None:
            m, r = k.shape[2], phi_k.shape[-1]
            if phi_k.shape[1] not in (1, h):   # per-kv-head: expand per group
                if h % phi_k.shape[1]:
                    raise ValueError(f"phi_k heads {phi_k.shape[1]} vs {h}")
                phi_k = phi_k.repeat_interleave(h // phi_k.shape[1], dim=1)
            phi_k = phi_k.expand(b, h, m, r)
        if lengths is not None:
            o = _flash_attention_ragged(q, k, v, phi_q, phi_k, slopes,
                                        lengths, mask_kind, window, scale,
                                        impl)
            return o.transpose(1, 2) if layout == "bshd" else o
        o = _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                  v.contiguous(), phi_q, phi_k, slopes,
                                  mask_kind, window, scale, impl)
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
    fn = (io_stub.flashbias_attention_ragged_fwd if impl == "io_stub"
          else flashbias_attention_ragged_fwd)
    return fn(q.contiguous(), k.contiguous(), v.contiguous(), phi_q, phi_k,
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


def _head_major(k_cache, v_cache, phi_k, paged: bool, kv_layout: str):
    """Head-major views (no copy) of canonical ``kv_layout="bshd"`` caches:
    ``(B, S, KVH, *) -> (B, KVH, S, *)``, pools ``(n_pages, ps, KVH, *) ->
    (KVH, n_pages, ps, *)``, ``phi_k (B, S, X, R) -> (B, X, S, R)`` and a
    per-head slab ``(n_pages, ps, X, R) -> (X, n_pages, ps, R)``. Views of
    ``"bhsd"`` caches pass through."""
    if kv_layout not in ("bshd", "bhsd"):
        raise ValueError(f"kv_layout {kv_layout!r}")
    if kv_layout == "bhsd":
        return k_cache, v_cache, phi_k
    if paged:
        hm = lambda t: t.permute(2, 0, 1, 3)
        if phi_k is not None and phi_k.dim() == 4:
            phi_k = hm(phi_k)
    else:
        hm = lambda t: t.transpose(1, 2)
        if phi_k is not None:
            phi_k = hm(phi_k)
    return hm(k_cache), hm(v_cache), phi_k


def flash_decode(
    q: torch.Tensor,                        # (B, 1, H, D)
    k_cache: torch.Tensor,                  # see kv_layout
    v_cache: torch.Tensor,
    lengths: torch.Tensor,                  # (B,) int
    phi_q: Optional[torch.Tensor] = None,   # (B, 1, H|KVH, R)
    phi_k: Optional[torch.Tensor] = None,
    slopes: Optional[torch.Tensor] = None,  # (H,)
    *,
    scale: Optional[float] = None,
    impl: str = "auto",
    page_table: Optional[torch.Tensor] = None,   # (B, P) int32 -> paged
    max_pages: Optional[int] = None,
    k_new: Optional[torch.Tensor] = None,        # (B, KVH, D)
    v_new: Optional[torch.Tensor] = None,        # (B, KVH, Dv)
    kv_layout: str = "bshd",
) -> torch.Tensor:
    """Single-token decode against a KV cache. Returns ``(B, 1, H, Dv)``.
    The query of row ``b`` sits at position ``lengths[b]-1``; rows with
    length 0 output 0.

    ``kv_layout`` selects the cache layout, with the reference's default:

    - ``"bshd"`` (canonical; what a direct caller holds): caches ``(B, S,
      KVH, *)``, paged pools ``(n_pages, ps, KVH, *)``; ``phi_k (B, S,
      1|KVH|H, R)`` or the paged slab ``(n_pages, ps, R)`` / ``(n_pages,
      ps, 1|KVH|H, R)``. On the card the caches reach kernels 3–4 after one
      transpose into the kernel layout (a copy per call, as the reference
      adapts them per call).
    - ``"bhsd"`` (the kernel layout the models store): ``(B, KVH, S, *)``,
      pools ``(KVH, n_pages, ps, *)`` handed to the kernels zero-copy;
      ``phi_k (B, 1|KVH|H, S, R)`` or ``(B, S, R)``, the paged slab
      ``(n_pages, ps, R)`` shared by every kv head or ``(1|KVH|H, n_pages,
      ps, R)``.

    With ``page_table`` the caches are a shared page pool: ``page_table[b,
    j]`` maps row b's logical block j to its physical page, and entries
    past the mapped prefix may hold anything (they are clamped and
    length-masked). The plain path gathers each row's logical view, capped
    at ``max_pages`` pages (see ``_static_page_cap``); the kernel reads only
    live rows and needs no cap.

    Per-q-head key factors (``phi_k`` over all H heads, H > KVH) may differ
    within a group, which the kernels' grouped layout cannot express. The
    reference sends them to XLA; here every impl serves them through
    ``expand_groups``: the keys and values are repeated over each group (a
    copy G times the cache's size, made while a bshd cache is transposed)
    and the call runs at G = 1, on the card through kernel 3 or 4.

    With ``k_new`` and ``v_new`` (the new token's rows ``(B, KVH, *)``, in
    the cache's dtype) the call first writes them in place at position
    ``lengths[b]-1`` of every row with ``lengths[b] > 0`` (paged: where
    ``paged_write_plan`` puts them; a page outside the pool drops the
    write), then attends. On a bhsd cache the kernel does both in one
    launch; where the call copies the cache (bshd on the card, per-q-head
    factors) the row is written into the caller's cache first."""
    paged = page_table is not None
    k_cache, v_cache, phi_k = _head_major(k_cache, v_cache, phi_k, paged,
                                          kv_layout)
    b, _, h, d = q.shape
    kvh = k_cache.shape[0] if paged else k_cache.shape[1]
    if h % kvh:
        raise ValueError(f"{h} heads do not group over {kvh} kv heads")
    g = h // kvh
    scale = (1.0 / float(np.sqrt(d))) if scale is None else scale
    impl = resolve_impl(impl, q.device)
    lengths = lengths.to(torch.int32).contiguous()
    if paged:
        page_table = page_table.to(torch.int32).contiguous()
    qg = q[:, 0].reshape(b, kvh, g, d)
    pq = sl = None
    if phi_q is not None:
        if phi_q.shape[2] == kvh and kvh != h:   # shared within each group
            phi_q = phi_q.repeat_interleave(g, dim=2)
        pq = phi_q[:, 0].reshape(b, kvh, g, -1)
        if phi_k.dim() == 3:                     # kv-head-shared factors
            phi_k = phi_k[None] if paged else phi_k[:, None]
    if slopes is not None:
        sl = slopes.reshape(kvh, g)
    per_q_head = phi_k is not None and g > 1 and \
        phi_k.shape[0 if paged else 1] == h
    copied = per_q_head or (impl != "torch" and kv_layout == "bshd")
    if k_new is not None and copied:
        # the row lands in the caller's cache before the copy is made
        write = write_paged_row if paged else write_row
        args = (page_table,) if paged else ()
        write(k_cache, v_cache, lengths, *args, k_new, v_new)
        k_new = v_new = None
    if per_q_head:
        qg, (k_cache, v_cache), pq, sl = expand_groups(
            qg, (k_cache, v_cache), pq, sl, axis=0 if paged else 1)
        kvh, g = h, 1
    if phi_k is not None and not paged:
        phi_k = phi_k.expand(b, kvh, k_cache.shape[2], phi_k.shape[-1])
    new = {}
    if k_new is not None:
        new = {"k_new": k_new.contiguous(), "v_new": v_new.contiguous()}
    if impl != "torch":
        k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    qg = qg.contiguous()
    dv = v_cache.shape[-1]
    if not paged:
        fn = {"torch": flash_decode_torch,
              "io_stub": io_stub.flash_decode_fwd}.get(impl, flash_decode_fwd)
        o = fn(qg, k_cache, v_cache, lengths, pq, phi_k, sl, scale=scale,
               **new)
        return o.reshape(b, 1, h, dv)
    if impl == "torch":
        cap = _static_page_cap(lengths, k_cache.shape[2],
                               page_table.shape[1], max_pages)
        o = flash_decode_paged_torch(qg, k_cache, v_cache, lengths,
                                     page_table, pq, phi_k, sl, scale=scale,
                                     max_pages=cap, **new)
    else:
        fn = (io_stub.flash_decode_paged_fwd if impl == "io_stub"
              else flash_decode_paged_fwd)
        o = fn(qg, k_cache, v_cache, lengths, page_table, pq, phi_k, sl,
               scale=scale, **new)
    return o.reshape(b, 1, h, dv)


def flash_chunk_attention(
    q: torch.Tensor,                        # (B, C, H, D) chunk queries
    k_cache: torch.Tensor,                  # (B, KVH, S, D) | (KVH, n_pages, ps, D)
    v_cache: torch.Tensor,                  # (B, KVH, S, Dv) | (KVH, n_pages, ps, Dv)
    offsets: torch.Tensor,                  # (B,) int: position of q[:, 0]
    chunk_lens: torch.Tensor,               # (B,) int: valid queries (0 = frozen)
    slopes: Optional[torch.Tensor] = None,  # (H,) ALiBi
    *,
    scale: Optional[float] = None,
    impl: str = "auto",
    page_table: Optional[torch.Tensor] = None,   # (B, P) int32 -> paged
    max_pages: Optional[int] = None,
    kv_layout: str = "bshd",
) -> torch.Tensor:
    """Offset-masked chunk attention for chunked prefill. Returns ``(B, C,
    H, Dv)`` in q's dtype.

    Query ``i`` of row ``b`` sits at position ``offsets[b] + i`` and sees
    the keys at positions ``<= offsets[b] + i``: the chunk's own keys must
    already be in the cache (write, then attend). Rows with ``chunk_lens[b]
    == 0`` are frozen lanes whose output nobody reads. ALiBi adds ``slopes
    * (k_pos - q_pos)`` from absolute positions.

    ``kv_layout`` as in ``flash_decode``: ``"bshd"`` (the default) takes
    contiguous ``(B, S, KVH, *)`` caches or pools ``(n_pages, ps, KVH, *)``,
    ``"bhsd"`` the kernel layout ``(B, KVH, S, *)`` / ``(KVH, n_pages, ps,
    *)``; either is read through a view, without a copy. With
    ``page_table`` the pools are gathered into a view of
    ``_static_page_cap`` pages per row (table entries clamped into the
    pool; the causal mask discards what lies past the written prefix).

    Port of ``repro.kernels.ops.flash_chunk_attention``, which routes every
    impl to XLA: chunk attention runs once per chunk on the admission path,
    so there is no Pallas kernel to port and every impl here is the plain
    float32 einsums, mask and softmax. ``offsets`` and ``chunk_lens`` may
    lie on the host or the card; nothing is read back from the card. At
    the full width of ``gpt2_alibi_15b`` (B 4, KVH 64, C 256, a 2048-key
    view) one float32 logits tensor is 0.54 GB, and the softmax makes a
    second: they fit."""
    b, c, h, d = q.shape
    scale = (1.0 / float(np.sqrt(d))) if scale is None else scale
    resolve_impl(impl, q.device)        # validated; every impl is plain
    k_cache, v_cache, _ = _head_major(k_cache, v_cache, None,
                                      page_table is not None, kv_layout)
    dev = q.device
    offsets = torch.as_tensor(offsets).to(torch.int32)
    chunk_lens = torch.as_tensor(chunk_lens).to(torch.int32)
    if page_table is not None:
        kvh, n_pages, ps = k_cache.shape[:3]
        cap = _static_page_cap(offsets + chunk_lens, ps, page_table.shape[1],
                               max_pages)
        pt = page_table[:, :cap].long().clamp(0, n_pages - 1)

        def view(pool):                 # (KVH, B, cap, ps, E) -> (B, KVH, S, E)
            return pool[:, pt].reshape(kvh, b, cap * ps,
                                       pool.shape[-1]).transpose(0, 1)
        kv, vv = view(k_cache), view(v_cache)
    else:
        kv, vv = k_cache, v_cache
    kvh, s_len, dv = kv.shape[1], kv.shape[2], vv.shape[-1]
    g = h // kvh
    qg = q.reshape(b, c, kvh, g, d).permute(0, 2, 3, 1, 4).float()
    s = torch.einsum("bkgcd,bksd->bkgcs", qg, kv.float()).mul_(scale)
    k_pos = torch.arange(s_len, device=dev)
    q_pos = offsets.to(dev)[:, None] + torch.arange(c, device=dev)  # (B, C)
    if slopes is not None:
        rel = (k_pos[None, None] - q_pos[:, :, None]).float()       # (B, C, S)
        s.addcmul_(slopes.float().reshape(kvh, g)[None, :, :, None, None],
                   rel[:, None, None])
    valid = k_pos[None, None] <= q_pos[:, :, None]
    s.masked_fill_(~valid[:, None, None], DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    del s
    o = torch.einsum("bkgcs,bkse->bkgce", p, vv.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, c, h, dv).to(q.dtype)


class _SSDScan(torch.autograd.Function):
    """Forward through kernel 5; backward through the plain version's
    autograd (``ssd_scan_torch`` on the kernel's layout), recomputing the
    forward, as ``_FlashAttention`` does for attention."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, h0, chunk, impl="cuda"):
        ctx.save_for_backward(x, dt, a, b, c, h0)
        ctx.chunk = chunk
        fn = io_stub.ssd_scan_fwd if impl == "io_stub" else ssd_scan_fwd
        y, h_fin = fn(x.transpose(1, 2), dt.transpose(1, 2), a, b[:, None],
                      c[:, None], chunk=chunk, h0=h0)
        return y.transpose(1, 2), h_fin

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            x, dt, a, b, c, h0 = leaves
            y, h_fin = ssd_scan_torch(x.transpose(1, 2), dt.transpose(1, 2),
                                      a, b[:, None], c[:, None],
                                      chunk=ctx.chunk, h0=h0)
            wrt = [t for t, need in zip(leaves, needs)
                   if t is not None and need]
            grads = iter(torch.autograd.grad(
                (y.transpose(1, 2), h_fin), wrt, (grad_y, grad_h),
                allow_unused=True))
        res = [next(grads) if t is not None and need else None
               for t, need in zip(leaves, needs)]
        return (*res, None, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 256,
             h0: Optional[torch.Tensor] = None, impl: str = "auto"):
    """Mamba2 SSD chunk scan in the model's layout: x ``(B, S, H, P)``, dt
    ``(B, S, H)``, a ``(H,)``, b / c ``(B, S, N)`` (one group), h0 ``(B, H,
    P, N)`` or None. Returns ``(y (B, S, H, P), h_fin (B, H, P, N))``.

    ``"torch"`` runs ``models.ssd.ssd_scan`` (the reference's algorithm);
    ``"cuda"`` launches kernel 5 on transposed views of x and y and a
    head-broadcast view of b and c, so nothing is copied, and raises for a
    tensor that is not on the card. Both are differentiable: the kernel's
    backward recomputes the scan through its plain version (there is no
    backward kernel, as there is none on the TPU; the reference's
    model-level scan is differentiable XLA)."""
    impl = resolve_impl(impl, x.device)
    if impl == "torch":
        # imported here: the models package imports this module
        from repro_torch.models import ssd
        return ssd.ssd_scan(x, dt, a, b, c, chunk=chunk, h0=h0)
    if impl == "cuda" and x.device.type != "cuda":
        raise ValueError(f"ssd_scan impl='cuda' needs a CUDA tensor, got "
                         f"{x.device}")
    return _SSDScan.apply(x, dt, a, b, c, h0, chunk, impl)

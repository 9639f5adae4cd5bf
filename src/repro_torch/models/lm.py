"""Decoder LM, dense family: FlashBias-ALiBi attention + SwiGLU MLP.

Port of the dense paths of ``repro.models.lm``. The parameter tree has the
reference's nested keys and stacked leading-``L`` shapes (``lm_template``),
so the reference's parameters carry across as a dict copy. Layers run as a
Python loop in place of ``jax.lax.scan``; each layer's weights are cast to
the compute dtype as they are used (an already-cast tree passes through
untouched, which is how the serve backend avoids re-casting every step).

Entry points:

- ``prefill(params, batch, cfg, max_len, lengths)`` — run (ragged,
  right-padded) prompts, return the last valid position's logits and the
  kv-head-major cache ``(L, B, KVH, max_len, hd)``;
- ``decode_step(params, cache, tokens, cfg)`` — one token per row against
  the cache. Rows with ``length == 0`` are frozen. The cache's k/v tensors
  are UPDATED IN PLACE (one row per active slot), where the reference
  returns new arrays: it saves a cache-sized copy per step;
- ``init_cache`` and ``insert_cache_at_slots`` for the serve engine;
- ``init_paged_cache``, ``insert_paged_cache_at_slots`` and
  ``grow_page_tables_at_slots`` for the paged engine: a page pool shared by
  every slot, per-slot page tables, and the float32 ALiBi key-factor slab
  ``pages_phi``. ``decode_step`` takes either cache.

Sliding-window (ring) caches and the other families wait for later slices.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (
    PDef,
    embed_lookup,
    rmsnorm,
    stack_layers,
    swiglu,
    tree_map,
    unembed_logits,
)

__all__ = ["lm_template", "cast_layers", "prefill", "decode_step",
           "init_cache", "insert_cache_at_slots", "init_paged_cache",
           "insert_paged_cache_at_slots", "grow_page_tables_at_slots"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.family} family is not ported yet (ROADMAP.md Queue A "
            f"item 7)")
    if cfg.window:
        raise NotImplementedError(
            "sliding-window (ring) KV caches are not ported yet (ROADMAP.md "
            "Queue A item 7)")
    if cfg.bias_kind == "alibi" and cfg.bias_mode != "flashbias":
        raise NotImplementedError(
            "the dense-bias baseline (bias_mode='dense') is not ported yet")


# ---------------------------------------------------------------------------
# Template
# ---------------------------------------------------------------------------

def _layer_template(cfg: ArchConfig) -> dict:
    d, hp, kvp = cfg.d_model, cfg.heads_padded, cfg.kv_heads_padded
    hd, f = cfg.resolved_head_dim, cfg.d_ff
    sd, sd_out = 0.02, 0.02 / np.sqrt(2 * cfg.n_layers)
    return {
        "ln1": PDef((d,), ("zeros",)),
        "attn": {
            "wq": PDef((d, hp, hd), ("normal", sd)),
            "wk": PDef((d, kvp, hd), ("normal", sd)),
            "wv": PDef((d, kvp, hd), ("normal", sd)),
            "wo": PDef((hp, hd, d), ("normal", sd_out)),
            "slopes": PDef((hp,), ("slopes", cfg.n_heads)),
        },
        "mlp": {
            "wi": PDef((d, f, 2), ("normal", sd)),
            "wo": PDef((f, d), ("normal", sd_out)),
        },
        "ln2": PDef((d,), ("zeros",)),
    }


def lm_template(cfg: ArchConfig) -> dict:
    _check_supported(cfg)
    return {
        "embed": PDef((cfg.vocab_padded, cfg.d_model), ("normal", 0.02)),
        "layers": stack_layers(_layer_template(cfg), cfg.n_layers),
        "final_norm": PDef((cfg.d_model,), ("zeros",)),
    }


def cast_layers(params: dict, cfg: ArchConfig) -> dict:
    """The tree with ``layers`` and ``embed`` in the compute dtype (as the
    reference's per-call ``_compute_layers`` cast makes them) and
    ``final_norm`` kept as is. Serving casts once with this; the model
    functions then find nothing left to cast."""
    dt = _dtype(cfg)
    out = dict(params)
    out["layers"] = tree_map(lambda x: x.to(dt), params["layers"])
    out["embed"] = params["embed"].to(dt)
    return out


def _layer(params: dict, i: int, dt: torch.dtype) -> dict:
    return tree_map(lambda x: x[i].to(dt), params["layers"])


# ---------------------------------------------------------------------------
# Attention (FlashBias-ALiBi)
# ---------------------------------------------------------------------------

def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (d, H, E) -> (B, S, H, E)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, E) @ (H, E, d) -> (B, S, d)."""
    return o.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _slopes(lp: dict, cfg: ArchConfig) -> Optional[torch.Tensor]:
    return lp["slopes"].float() if cfg.bias_kind == "alibi" else None


def _attention(lp: dict, x: torch.Tensor, cfg: ArchConfig):
    """Causal prefill attention. Returns (y, k, v) with k, v head-major
    ``(B, KVH, S, hd)``, the cache layout."""
    q = _project(x, lp["wq"]).transpose(1, 2).contiguous()
    k = _project(x, lp["wk"]).transpose(1, 2).contiguous()
    v = _project(x, lp["wv"]).transpose(1, 2).contiguous()
    o = ops.flash_attention(q, k, v, slopes=_slopes(lp, cfg),
                            mask_kind="causal", impl=cfg.attn_impl,
                            layout="bhsd")
    return _out_proj(o.transpose(1, 2), lp["wo"]), k, v


def _attention_decode(lp: dict, x: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, lengths: torch.Tensor,
                      active: torch.Tensor, cfg: ArchConfig, *,
                      paged: Optional[dict] = None) -> torch.Tensor:
    """One-token attention against one layer's cache, contiguous ``(B, KVH,
    S, hd)`` or (``paged`` given) a page pool ``(KVH, n_pages, ps, hd)``.
    The new token's k/v row is written at position ``lengths - 1`` BEFORE
    attending (in place). Frozen rows (``active`` False) write nothing: a
    contiguous row rewrites the row it holds, and a paged row repeats an
    active row's write (see ``_paged_write_plan``), so a lane never touches
    a page it no longer owns.

    Paged with a factor slab (``paged["phi"]``): the ALiBi bias comes from
    the cached key factors ``[1, pos]`` against ``phi_q = slope * [-(len-1),
    1]`` (phi mode, FlashBias Sec. 4.3), as the reference's paged path
    computes it; ``paged["phi_q"]`` holds the slope-free ``[-(len-1), 1]``,
    built once per step."""
    q = _project(x, lp["wq"])                                # (B, 1, H, E)
    k_new = _project(x, lp["wk"])[:, 0]                      # (B, KVH, E)
    v_new = _project(x, lp["wv"])[:, 0]
    slopes = _slopes(lp, cfg)
    if paged is None:
        bidx = torch.arange(x.shape[0], device=x.device)
        pos = torch.where(active, lengths - 1, 0)
        keep = active[:, None, None]
        k_cache[bidx, :, pos] = torch.where(keep, k_new,
                                            k_cache[bidx, :, pos])
        v_cache[bidx, :, pos] = torch.where(keep, v_new,
                                            v_cache[bidx, :, pos])
        o = ops.flash_decode(q, k_cache, v_cache, lengths, slopes=slopes,
                             impl=cfg.attn_impl)
        return _out_proj(o, lp["wo"])
    page, off, src, keep = paged["write"]
    keep = keep[None, :, None]
    for pool, new in ((k_cache, k_new), (v_cache, v_new)):
        new = new[src].transpose(0, 1)                       # (KVH, B, E)
        pool[:, page, off] = torch.where(keep, new, pool[:, page, off])
    phi_q = phi_k = None
    if slopes is not None and paged["phi"] is not None:
        phi_q = paged["phi_q"] * slopes.reshape(1, 1, -1, 1)   # (B,1,H,2)
        phi_k, slopes = paged["phi"], None
    o = ops.flash_decode(q, k_cache, v_cache, lengths, phi_q=phi_q,
                         phi_k=phi_k, slopes=slopes, impl=cfg.attn_impl,
                         page_table=paged["table"],
                         max_pages=paged["max_pages"])
    return _out_proj(o, lp["wo"])


def _paged_write_plan(page_table: torch.Tensor, lengths: torch.Tensor,
                      active: torch.Tensor, n_pages: int, ps: int):
    """Where each row's new token lands in the pool: ``(page, offset, src,
    keep)``, all ``(B,)``, every index in range.

    The reference drops the writes of frozen rows and of rows whose table
    entry is a sentinel (``>= n_pages``) through out-of-range scatter
    indices; on a CUDA tensor such an index is a device-side assert. So a
    row that must not write instead repeats the write of the first row that
    does (``src``): duplicate indices then carry equal values and the
    result does not depend on their order. When no row writes, every row
    rewrites page 0's first row with itself (``keep`` False). All of it
    stays on the device: no host sync in the decode step."""
    b = lengths.shape[0]
    bidx = torch.arange(b, device=lengths.device)
    pos = torch.where(active, lengths - 1, 0).long()
    block = (pos // ps).clamp(max=page_table.shape[1] - 1)
    page = page_table[bidx, block].long()
    ok = active & (page >= 0) & (page < n_pages)
    first = torch.argmax(ok.to(torch.int32))
    src = torch.where(ok, bidx, first)
    page = torch.where(ok[src], page[src], 0)
    off = torch.where(ok[src], pos[src] % ps, 0)
    return page, off, src, ok[src]


def _mlp(lp: dict, x: torch.Tensor) -> torch.Tensor:
    return swiglu(rmsnorm(x, lp["ln2"]), lp["mlp"]["wi"], lp["mlp"]["wo"])


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _embed_in(params: dict, tokens: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    x = embed_lookup(params["embed"], tokens).to(_dtype(cfg))
    return x * float(np.sqrt(cfg.d_model))


def _logits(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    hid = rmsnorm(x, params["final_norm"])
    return unembed_logits(hid, params["embed"].to(hid.dtype))


def prefill(params: dict, batch: dict, cfg: ArchConfig, *,
            max_len: Optional[int] = None,
            lengths: Optional[torch.Tensor] = None):
    """Run the prompts; return (last-position logits (B, 1, V), cache).

    ``lengths`` (B,) enables ragged right-padded prompts: row ``b``'s
    prompt is positions ``0 .. lengths[b]-1`` and its logits are gathered
    there (the causal mask already keeps padding out of real queries). The
    cache holds every computed position, zero-padded to ``max_len``."""
    _check_supported(cfg)
    if batch.get("frontend") is not None:
        raise NotImplementedError("frontend embeddings are not ported yet")
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prompt width {s}")
    dt, dev = _dtype(cfg), tokens.device
    shape = (cfg.n_layers, b, cfg.kv_heads_padded, max_len,
             cfg.resolved_head_dim)
    alloc = torch.zeros if max_len > s else torch.empty
    k_cache = alloc(shape, dtype=dt, device=dev)
    v_cache = alloc(shape, dtype=dt, device=dev)
    x = _embed_in(params, tokens, cfg)
    for i in range(cfg.n_layers):
        lp = _layer(params, i, dt)
        y, k, v = _attention(lp["attn"], rmsnorm(x, lp["ln1"]), cfg)
        k_cache[i, :, :, :s] = k
        v_cache[i, :, :, :s] = v
        x = x + y
        x = x + _mlp(lp, x)
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    lengths = lengths.to(device=dev, dtype=torch.int32)
    last = x[torch.arange(b, device=dev), (lengths - 1).long()][:, None]
    cache = {"length": lengths, "k": k_cache, "v": v_cache}
    return _logits(params, last, cfg), cache


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ArchConfig, *, max_pages: Optional[int] = None):
    """One decode step: ``tokens (B, 1)`` land at position
    ``cache["length"]``. Rows with length 0 are inactive and frozen: no
    cache write, no length advance. Returns (logits (B, 1, V), cache) — the
    new cache dict shares the k/v tensors (or pools), which were updated in
    place.

    A paged cache (``"pages_k"`` in it) is read through its page table;
    ``max_pages`` caps the pages any row references this step (the serve
    engine passes a power-of-two rounding of its host-side longest length)
    and bounds the plain path's gather. The new position's factor row
    ``[1, pos]`` is written to the slab once, outside the layer loop."""
    _check_supported(cfg)
    active = cache["length"] > 0
    lengths = cache["length"] + active.to(torch.int32)
    dt = _dtype(cfg)
    x = _embed_in(params, tokens, cfg)
    paged = None
    if "pages_k" in cache:
        n_pages, ps = cache["pages_k"].shape[2], cache["pages_k"].shape[3]
        table = cache["page_table"]
        write = _paged_write_plan(table, lengths, active, n_pages, ps)
        phi = cache.get("pages_phi")
        paged = {"write": write, "table": table, "phi": phi,
                 "max_pages": max_pages}
        if phi is not None:
            page, off, src, keep = write
            pos = (lengths - 1).float()
            one = torch.ones_like(pos)
            row = torch.stack([one, pos], -1)[src]
            phi[page, off] = torch.where(keep[:, None], row, phi[page, off])
            paged["phi_q"] = torch.stack([-pos, one], -1)[:, None, None]
        k_all, v_all = cache["pages_k"], cache["pages_v"]
    else:
        k_all, v_all = cache["k"], cache["v"]
    for i in range(cfg.n_layers):
        lp = _layer(params, i, dt)
        x = x + _attention_decode(lp["attn"], rmsnorm(x, lp["ln1"]),
                                  k_all[i], v_all[i], lengths, active, cfg,
                                  paged=paged)
        x = x + _mlp(lp, x)
    return _logits(params, x, cfg), {**cache, "length": lengths}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda",
               length: int = 0) -> dict:
    """Zeroed kernel-layout cache ``(L, B, KVH, max_len, hd)``."""
    _check_supported(cfg)
    shape = (cfg.n_layers, batch, cfg.kv_heads_padded, max_len,
             cfg.resolved_head_dim)
    return {
        "length": torch.full((batch,), length, dtype=torch.int32,
                             device=device),
        "k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
        "v": torch.zeros(shape, dtype=_dtype(cfg), device=device),
    }


def insert_cache_at_slots(dst: dict, src: dict, slots) -> dict:
    """Copy wave-cache rows of ``src`` into batch slots of ``dst``, in place.

    ``slots[i]`` is the destination slot of wave row ``i``; out-of-range
    entries (``>= n_slots``) are dropped, so a fixed-size wave can carry
    padding rows. A wave cache shorter than the slot cache fills the slot's
    leading positions and zeroes the rest."""
    n_slots = dst["length"].shape[0]
    pairs = [(i, int(s)) for i, s in enumerate(slots) if 0 <= int(s) < n_slots]
    if not pairs:
        return dst
    dev = dst["length"].device
    src_rows = torch.tensor([i for i, _ in pairs], device=dev)
    dst_rows = torch.tensor([s for _, s in pairs], device=dev)
    s_len = src["k"].shape[3]
    if s_len > dst["k"].shape[3]:
        raise ValueError(f"wave cache length {s_len} exceeds the slot "
                         f"cache's {dst['k'].shape[3]}")
    for key in ("k", "v"):
        dst[key][:, dst_rows, :, :s_len] = src[key][:, src_rows]
        dst[key][:, dst_rows, :, s_len:] = 0
    dst["length"][dst_rows] = src["length"][src_rows]
    return dst


# ---------------------------------------------------------------------------
# Paged cache
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ArchConfig, batch: int, n_pages: int,
                     page_size: int, pages_per_slot: Optional[int] = None,
                     *, device="cuda") -> dict:
    """Paged cache: a page pool shared by every slot plus per-slot page
    tables.

    - ``pages_k`` / ``pages_v`` ``(L, KVH, n_pages, ps, hd)``: the decode
      kernel's kv-head-major layout, handed to it zero-copy.
    - ``pages_phi`` ``(n_pages, ps, 2)`` float32 (ALiBi configs): the rank-2
      key factor ``[1, pos]`` of every cached position, layer- and
      kv-head-shared, float32 so positions stay exact.
    - ``page_table`` ``(batch, pages_per_slot)`` int32: slot b's logical
      block j -> physical page; unmapped entries may hold anything (decode
      clamps them and the length mask discards what they read).

    The port stores ``hd`` and the slab's rank unpadded: the reference's
    128-lane pads are Pallas TPU tile constraints, and the Hopper kernel
    reads rows of any width."""
    _check_supported(cfg)
    shape = (cfg.n_layers, cfg.kv_heads_padded, n_pages, page_size,
             cfg.resolved_head_dim)
    cache = {
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
        "pages_k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
        "pages_v": torch.zeros(shape, dtype=_dtype(cfg), device=device),
        "page_table": torch.zeros((batch, pages_per_slot or n_pages),
                                  dtype=torch.int32, device=device),
    }
    if cfg.bias_kind == "alibi":
        cache["pages_phi"] = torch.zeros((n_pages, page_size, 2),
                                         dtype=torch.float32, device=device)
    return cache


def _host_ids(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu()
    return np.asarray(x, np.int64)


def insert_paged_cache_at_slots(dst: dict, src: dict, slots, tables) -> dict:
    """Scatter a prefilled wave into the paged cache, whole pages at a time,
    in place.

    ``src`` is a contiguous wave cache from ``prefill`` whose length S is a
    page multiple. ``tables`` (W, pages_per_slot) holds each wave row's full
    page-table row: the pages covering its prompt, then any pages reserved
    for decode growth; entries outside ``[0, n_pages)`` (the sentinel
    ``n_pages``) are skipped, and so are rows whose ``slots`` entry is out
    of range (``>= n_slots``). ``slots`` and ``tables`` are host arrays;
    they are filtered on the host, so no out-of-range index reaches the
    device. Prompt pages take K/V content and position factors; the page
    table and ``length`` land at ``slots``."""
    slots, tables = _host_ids(slots), _host_ids(tables)
    n_pages, ps = dst["pages_k"].shape[2], dst["pages_k"].shape[3]
    n_slots = dst["length"].shape[0]
    s = src["k"].shape[3]
    if s % ps:
        raise ValueError(f"wave cache length {s} is not a multiple of the "
                         f"page size {ps}")
    p_w = s // ps
    dev = dst["length"].device
    rows, blocks = np.nonzero((tables[:, :p_w] >= 0)
                              & (tables[:, :p_w] < n_pages))
    if rows.size:
        ids = torch.as_tensor(tables[rows, blocks], device=dev)
        r_t = torch.as_tensor(rows, device=dev)
        b_t = torch.as_tensor(blocks, device=dev)
        for key, pool_key in (("k", "pages_k"), ("v", "pages_v")):
            kv = src[key]                                # (L, W, KVH, S, hd)
            l, w, kvh, _, hd = kv.shape
            pages = kv.reshape(l, w, kvh, p_w, ps, hd).transpose(1, 2)
            dst[pool_key][:, :, ids] = pages[:, :, r_t, b_t]
        if "pages_phi" in dst:
            pos = torch.arange(s, dtype=torch.float32, device=dev)
            slab = torch.stack([torch.ones_like(pos), pos], -1)
            dst["pages_phi"][ids] = slab.reshape(p_w, ps, 2)[b_t]
    keep = np.nonzero((slots >= 0) & (slots < n_slots))[0]
    if keep.size:
        k_t = torch.as_tensor(keep, device=dev)
        s_t = torch.as_tensor(slots[keep], device=dev)
        dst["page_table"][s_t] = torch.as_tensor(
            tables[keep], dtype=torch.int32, device=dev)
        dst["length"][s_t] = src["length"][k_t.to(src["length"].device)]
    return dst


def grow_page_tables_at_slots(dst: dict, slots, tables) -> dict:
    """Rewrite the page-table rows of slots that grew a page mid-flight, in
    place. Only the int32 table rows move: the pages already holding K/V
    and factor rows stay. ``tables`` (W, pages_per_slot) carries each
    growing slot's full new row; rows whose ``slots`` entry is out of range
    (``>= n_slots``) are skipped, on the host."""
    slots, tables = _host_ids(slots), _host_ids(tables)
    n_slots = dst["length"].shape[0]
    keep = np.nonzero((slots >= 0) & (slots < n_slots))[0]
    if keep.size:
        dev = dst["page_table"].device
        dst["page_table"][torch.as_tensor(slots[keep], device=dev)] = \
            torch.as_tensor(tables[keep], dtype=torch.int32, device=dev)
    return dst

"""Decoder LM, dense and SSM families: FlashBias-ALiBi attention + SwiGLU
MLP (dense), or the Mamba2 SSD block alone (ssm).

Port of the dense and SSM paths of ``repro.models.lm``. The parameter tree
has the reference's nested keys and stacked leading-``L`` shapes
(``lm_template``), so the reference's parameters carry across as a dict
copy. Layers run as a Python loop in place of ``jax.lax.scan``; each
layer's weights are cast to the compute dtype as they are used (an
already-cast tree passes through untouched, which is how the serve backend
avoids re-casting every step).

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

The SSM family (``mamba2_130m``) caches a constant-size state per slot:
``ssm_h (L, B, Hs, P, N)`` in float32 and the causal-conv tails ``conv_x``
and ``conv_bc`` in the compute dtype. Its prefill runs the SSD chunk scan
through ``ops.ssd_scan`` (kernel 5 on the card); its decode step updates
the state and the tails IN PLACE for active rows, as k/v are.

Sliding-window (ring) caches, MoE and the hybrid family wait for later
slices.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import paged_write_plan
from repro_torch.models import ssd
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
    if cfg.family not in ("dense", "ssm"):
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

def _attn_template(cfg: ArchConfig) -> dict:
    d, hp, kvp = cfg.d_model, cfg.heads_padded, cfg.kv_heads_padded
    hd = cfg.resolved_head_dim
    sd, sd_out = 0.02, 0.02 / np.sqrt(2 * cfg.n_layers)
    return {
        "wq": PDef((d, hp, hd), ("normal", sd)),
        "wk": PDef((d, kvp, hd), ("normal", sd)),
        "wv": PDef((d, kvp, hd), ("normal", sd)),
        "wo": PDef((hp, hd, d), ("normal", sd_out)),
        "slopes": PDef((hp,), ("slopes", cfg.n_heads)),
    }


def _mlp_template(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": PDef((d, f, 2), ("normal", 0.02)),
        "wo": PDef((f, d), ("normal", 0.02 / np.sqrt(2 * cfg.n_layers))),
    }


def _ssm_template(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    hs, p, n = cfg.ssm_heads_padded, cfg.ssm_head_dim, cfg.ssm_state
    w, sd = cfg.conv_width, 0.02
    return {
        "in_x": PDef((d, hs, p), ("normal", sd)),
        "in_z": PDef((d, hs, p), ("normal", sd)),
        "in_b": PDef((d, n), ("normal", sd)),
        "in_c": PDef((d, n), ("normal", sd)),
        "in_dt": PDef((d, hs), ("normal", sd)),
        "conv_w": PDef((w, hs, p), ("normal", 0.2)),
        "conv_bc_w": PDef((w, 2 * n), ("normal", 0.2)),
        "a_log": PDef((hs,), ("zeros",)),
        "dt_bias": PDef((hs,), ("zeros",)),
        "d_skip": PDef((hs,), ("ones",)),
        "gate_norm": PDef((hs, p), ("zeros",)),
        "out": PDef((hs, p, d), ("normal", sd / np.sqrt(2 * cfg.n_layers))),
    }


def _layer_template(cfg: ArchConfig) -> dict:
    layer = {"ln1": PDef((cfg.d_model,), ("zeros",))}
    if cfg.family == "ssm":
        layer["ssm"] = _ssm_template(cfg)
        return layer
    layer["attn"] = _attn_template(cfg)
    layer["mlp"] = _mlp_template(cfg)
    layer["ln2"] = PDef((cfg.d_model,), ("zeros",))
    return layer


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
                      cfg: ArchConfig, *, slopes: Optional[torch.Tensor],
                      phi_q: Optional[torch.Tensor] = None,
                      paged: Optional[dict] = None) -> torch.Tensor:
    """One-token attention against one layer's cache, contiguous ``(B, KVH,
    S, hd)`` or (``paged`` given) a page pool ``(KVH, n_pages, ps, hd)``.
    The new token's k/v row is written at position ``lengths - 1`` BEFORE
    attending, in place, by the decode call itself (``ops.flash_decode``'s
    ``k_new`` / ``v_new``): frozen rows (length 0) write nothing, and a
    paged row whose page is a sentinel drops its write.

    ``slopes`` are this layer's float32 ALiBi slopes (or None). Paged with a
    factor slab, ``phi_q`` (this layer's ``slope * [-(len-1), 1]``, built
    once per step) selects phi mode: the ALiBi bias comes from the cached
    key factors ``[1, pos]`` (FlashBias Sec. 4.3), as the reference's paged
    path computes it."""
    q = _project(x, lp["wq"])                                # (B, 1, H, E)
    new = {"k_new": _project(x, lp["wk"])[:, 0],             # (B, KVH, E)
           "v_new": _project(x, lp["wv"])[:, 0]}
    if paged is None:
        o = ops.flash_decode(q, k_cache, v_cache, lengths, slopes=slopes,
                             impl=cfg.attn_impl, **new)
        return _out_proj(o, lp["wo"])
    phi_k = None
    if phi_q is not None:
        phi_k, slopes = paged["phi"], None
    o = ops.flash_decode(q, k_cache, v_cache, lengths, phi_q=phi_q,
                         phi_k=phi_k, slopes=slopes, impl=cfg.attn_impl,
                         page_table=paged["table"],
                         max_pages=paged["max_pages"], **new)
    return _out_proj(o, lp["wo"])


def _mlp(lp: dict, x: torch.Tensor) -> torch.Tensor:
    return swiglu(rmsnorm(x, lp["ln2"]), lp["mlp"]["wi"], lp["mlp"]["wo"])


# ---------------------------------------------------------------------------
# SSM branch (Mamba2 SSD)
# ---------------------------------------------------------------------------

def _ssm_proj(sp: dict, x: torch.Tensor):
    """The five input projections, in the compute dtype."""
    return (_project(x, sp["in_x"]), _project(x, sp["in_z"]),
            x @ sp["in_b"], x @ sp["in_c"], x @ sp["in_dt"])


def _causal_conv(seq: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None,
                 lengths: Optional[torch.Tensor] = None):
    """Depthwise causal conv. seq: (B, S, ...) w: (W, ...); tail: (B, W-1,
    ...). Returns (out, new_tail).

    With ``lengths`` (B,) the returned tail holds the last W-1 inputs at or
    before position ``lengths[b]-1`` (ragged right-padded prefill): position
    ``p`` lives at index ``p + W-1`` of the padded buffer, so the tail spans
    indices ``lengths[b] .. lengths[b]+W-2``."""
    width = w.shape[0]
    if tail is None:
        tail = torch.zeros((seq.shape[0], width - 1) + seq.shape[2:],
                           dtype=seq.dtype, device=seq.device)
    full = torch.cat([tail, seq], dim=1)
    s = seq.shape[1]
    out = full[:, :s] * w[0]
    for i in range(1, width):
        out = out + full[:, i:i + s] * w[i]
    if width == 1:
        new_tail = tail
    elif lengths is None:
        new_tail = full[:, -(width - 1):]
    else:
        idx = (lengths.long()[:, None]
               + torch.arange(width - 1, device=seq.device))
        idx = idx.reshape(idx.shape + (1,) * (full.dim() - 2))
        new_tail = torch.gather(full, 1, idx.expand(
            (-1, -1) + full.shape[2:]))
    return out, new_tail


def _ssm_gate_out(sp: dict, y: torch.Tensor, xs: torch.Tensor,
                  z: torch.Tensor, dt_: torch.dtype) -> torch.Tensor:
    """Skip term, SiLU gate and gated norm in float32, cast back to the
    compute dtype before the output projection. y, xs, z: (..., Hs, P)."""
    y = y + sp["d_skip"].float()[:, None] * xs.float()
    y = y * F.silu(z.float())
    return _out_proj(rmsnorm(y, sp["gate_norm"]).to(dt_), sp["out"])


def _ssm_conv_inputs(sp: dict, x: torch.Tensor, cfg: ArchConfig,
                     tail_x=None, tail_bc=None, lengths=None):
    """Projections and both causal convs: (xs, z, b, c, dt_raw, tail_x,
    tail_bc), xs / b / c after the conv and SiLU."""
    xs, z, bmat, cmat, dt = _ssm_proj(sp, x)
    xs, tail_x = _causal_conv(xs, sp["conv_w"], tail_x, lengths)
    xs = F.silu(xs)
    bc = torch.cat([bmat, cmat], dim=-1)
    bc, tail_bc = _causal_conv(bc, sp["conv_bc_w"], tail_bc, lengths)
    bc = F.silu(bc)
    n = cfg.ssm_state
    return xs, z, bc[..., :n], bc[..., n:], dt, tail_x, tail_bc


def _ssm_dt_a(sp: dict, dt: torch.Tensor):
    dt = F.softplus(dt.float() + sp["dt_bias"].float())
    return dt, -torch.exp(sp["a_log"].float())


def _ssm_forward(sp: dict, x: torch.Tensor, cfg: ArchConfig, *,
                 lengths: Optional[torch.Tensor] = None):
    """Full-sequence SSD. Returns (y (B, S, D), h_fin, tail_x, tail_bc).

    ``lengths`` (B,) marks the valid prefix of a right-padded batch: padded
    positions get dt = 0, which makes their state update the identity, so
    ``h_fin`` and the conv tails are the state after position
    ``lengths[b]-1``."""
    xs, z, bmat, cmat, dt, tail_x, tail_bc = _ssm_conv_inputs(
        sp, x, cfg, lengths=lengths)
    dt, a = _ssm_dt_a(sp, dt)
    if lengths is not None:
        keep = (torch.arange(x.shape[1], device=x.device)[None, :]
                < lengths[:, None])
        dt = torch.where(keep[:, :, None], dt,
                         torch.zeros((), device=x.device))
    y, h_fin = ops.ssd_scan(xs.float(), dt, a, bmat.float(), cmat.float(),
                            chunk=cfg.ssd_chunk, impl=cfg.attn_impl)
    return _ssm_gate_out(sp, y, xs, z, x.dtype), h_fin, tail_x, tail_bc


def _ssm_decode(sp: dict, x: torch.Tensor, h: torch.Tensor,
                tail_x: torch.Tensor, tail_bc: torch.Tensor,
                cfg: ArchConfig):
    """One-token SSD update; x (B, 1, D). Returns (y, h, tail_x,
    tail_bc)."""
    xs, z, bmat, cmat, dt, tail_x, tail_bc = _ssm_conv_inputs(
        sp, x, cfg, tail_x, tail_bc)
    dt, a = _ssm_dt_a(sp, dt)
    y1, h = ssd.ssd_decode_step(h, xs[:, 0].float(), dt[:, 0], a,
                                bmat[:, 0].float(), cmat[:, 0].float())
    out = _ssm_gate_out(sp, y1, xs[:, 0], z[:, 0], x.dtype)
    return out[:, None], h, tail_x, tail_bc


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
    if cfg.family == "ssm":
        return _ssm_prefill(params, batch["tokens"], cfg, lengths)
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


def _ssm_prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                 lengths: Optional[torch.Tensor]):
    """SSM prefill: the last valid position's logits and the constant-size
    cache (state and conv tails frozen at ``lengths[b]-1``)."""
    b, s = tokens.shape
    dt, dev = _dtype(cfg), tokens.device
    if lengths is not None:
        lengths = lengths.to(device=dev, dtype=torch.int32)
    x = _embed_in(params, tokens, cfg)
    states, tails_x, tails_bc = [], [], []
    for i in range(cfg.n_layers):
        lp = _layer(params, i, dt)
        y, h_fin, tail_x, tail_bc = _ssm_forward(
            lp["ssm"], rmsnorm(x, lp["ln1"]), cfg, lengths=lengths)
        states.append(h_fin)
        tails_x.append(tail_x)
        tails_bc.append(tail_bc)
        x = x + y
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    last = x[torch.arange(b, device=dev), (lengths - 1).long()][:, None]
    cache = {"length": lengths, "ssm_h": torch.stack(states),
             "conv_x": torch.stack(tails_x), "conv_bc": torch.stack(tails_bc)}
    return _logits(params, last, cfg), cache


def _ssm_decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                     cfg: ArchConfig):
    """SSM decode: state and conv tails of active rows updated in place;
    rows with length 0 keep theirs bit-identical."""
    active = cache["length"] > 0
    lengths = cache["length"] + active.to(torch.int32)
    dt = _dtype(cfg)
    x = _embed_in(params, tokens, cfg)
    keep4 = active[:, None, None, None]
    for i in range(cfg.n_layers):
        lp = _layer(params, i, dt)
        h, tx, tbc = cache["ssm_h"][i], cache["conv_x"][i], cache["conv_bc"][i]
        y, h_new, tx_new, tbc_new = _ssm_decode(
            lp["ssm"], rmsnorm(x, lp["ln1"]), h, tx, tbc, cfg)
        h.copy_(torch.where(keep4, h_new, h))
        tx.copy_(torch.where(keep4, tx_new, tx))
        tbc.copy_(torch.where(active[:, None, None], tbc_new, tbc))
        x = x + y
    return _logits(params, x, cfg), {**cache, "length": lengths}


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
    if cfg.family == "ssm":
        return _ssm_decode_step(params, cache, tokens, cfg)
    active = cache["length"] > 0
    lengths = cache["length"] + active.to(torch.int32)
    dt = _dtype(cfg)
    x = _embed_in(params, tokens, cfg)
    # every layer's float32 slopes (and, paged in phi mode, phi_q) at once:
    # one copy per step, not one per layer
    slopes = phi_q = paged = None
    if cfg.bias_kind == "alibi":
        slopes = params["layers"]["attn"]["slopes"].to(dt).float()  # (L, H)
    if "pages_k" in cache:
        n_pages, ps = cache["pages_k"].shape[2], cache["pages_k"].shape[3]
        table = cache["page_table"]
        phi = cache.get("pages_phi")
        paged = {"table": table, "phi": phi, "max_pages": max_pages}
        if phi is not None:
            page, off, src, keep = paged_write_plan(table, lengths, active,
                                                    n_pages, ps)
            pos = (lengths - 1).float()
            one = torch.ones_like(pos)
            row = torch.stack([one, pos], -1)[src]
            phi[page, off] = torch.where(keep[:, None], row, phi[page, off])
            if slopes is not None:                 # (L, B, 1, H, 2)
                phi_q = (torch.stack([-pos, one], -1)[None, :, None, None]
                         * slopes[:, None, None, :, None])
        k_all, v_all = cache["pages_k"], cache["pages_v"]
    else:
        k_all, v_all = cache["k"], cache["v"]
    for i in range(cfg.n_layers):
        lp = _layer(params, i, dt)
        x = x + _attention_decode(
            lp["attn"], rmsnorm(x, lp["ln1"]), k_all[i], v_all[i], lengths,
            cfg, slopes=None if slopes is None else slopes[i],
            phi_q=None if phi_q is None else phi_q[i], paged=paged)
        x = x + _mlp(lp, x)
    return _logits(params, x, cfg), {**cache, "length": lengths}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda",
               length: int = 0) -> dict:
    """Zeroed cache: kernel-layout k/v ``(L, B, KVH, max_len, hd)``, or for
    the SSM family the constant-size ``ssm_h (L, B, Hs, P, N)`` float32
    state and the conv tails ``conv_x (L, B, W-1, Hs, P)`` and ``conv_bc
    (L, B, W-1, 2N)`` (``max_len`` does not size them)."""
    _check_supported(cfg)
    cache = {"length": torch.full((batch,), length, dtype=torch.int32,
                                  device=device)}
    l, dt = cfg.n_layers, _dtype(cfg)
    if cfg.family == "ssm":
        hs, p, n = cfg.ssm_heads_padded, cfg.ssm_head_dim, cfg.ssm_state
        w = cfg.conv_width
        cache["ssm_h"] = torch.zeros((l, batch, hs, p, n),
                                     dtype=torch.float32, device=device)
        cache["conv_x"] = torch.zeros((l, batch, w - 1, hs, p), dtype=dt,
                                      device=device)
        cache["conv_bc"] = torch.zeros((l, batch, w - 1, 2 * n), dtype=dt,
                                       device=device)
        return cache
    shape = (l, batch, cfg.kv_heads_padded, max_len, cfg.resolved_head_dim)
    cache["k"] = torch.zeros(shape, dtype=dt, device=device)
    cache["v"] = torch.zeros(shape, dtype=dt, device=device)
    return cache


def insert_cache_at_slots(dst: dict, src: dict, slots) -> dict:
    """Copy wave-cache rows of ``src`` into batch slots of ``dst``, in place.

    ``slots[i]`` is the destination slot of wave row ``i``; out-of-range
    entries (``>= n_slots``) are dropped, so a fixed-size wave can carry
    padding rows. Every layer-major ``(L, B, ...)`` leaf is copied; a k/v
    wave cache shorter than the slot cache fills the slot's leading
    positions and zeroes the rest."""
    n_slots = dst["length"].shape[0]
    pairs = [(i, int(s)) for i, s in enumerate(slots) if 0 <= int(s) < n_slots]
    if not pairs:
        return dst
    dev = dst["length"].device
    src_rows = torch.tensor([i for i, _ in pairs], device=dev)
    dst_rows = torch.tensor([s for _, s in pairs], device=dev)
    for key in dst:
        if key == "length":
            continue
        if key not in ("k", "v"):
            dst[key][:, dst_rows] = src[key][:, src_rows]
            continue
        s_len = src[key].shape[3]
        if s_len > dst[key].shape[3]:
            raise ValueError(f"wave cache length {s_len} exceeds the slot "
                             f"cache's {dst[key].shape[3]}")
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
    if cfg.family != "dense":
        raise ValueError(f"{cfg.family} caches are constant-size: no pages")
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

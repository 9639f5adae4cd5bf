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
- ``init_cache`` and ``insert_cache_at_slots`` for the serve engine.

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
           "init_cache", "insert_cache_at_slots"]

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
                      active: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """One-token attention against one layer's contiguous cache
    ``(B, KVH, S, hd)``. The new token's k/v row is written at position
    ``lengths - 1`` BEFORE attending (in place); frozen rows (``active``
    False) rewrite the row they hold, so their cache is unchanged."""
    q = _project(x, lp["wq"])                                # (B, 1, H, E)
    k_new = _project(x, lp["wk"])[:, 0]                      # (B, KVH, E)
    v_new = _project(x, lp["wv"])[:, 0]
    bidx = torch.arange(x.shape[0], device=x.device)
    pos = torch.where(active, lengths - 1, 0)
    keep = active[:, None, None]
    k_cache[bidx, :, pos] = torch.where(keep, k_new, k_cache[bidx, :, pos])
    v_cache[bidx, :, pos] = torch.where(keep, v_new, v_cache[bidx, :, pos])
    o = ops.flash_decode(q, k_cache, v_cache, lengths, slopes=_slopes(lp, cfg),
                         impl=cfg.attn_impl)
    return _out_proj(o, lp["wo"])


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
                cfg: ArchConfig):
    """One decode step: ``tokens (B, 1)`` land at position
    ``cache["length"]``. Rows with length 0 are inactive and frozen: no
    cache write, no length advance. Returns (logits (B, 1, V), cache) — the
    new cache dict shares the k/v tensors, which were updated in place."""
    _check_supported(cfg)
    active = cache["length"] > 0
    lengths = cache["length"] + active.to(torch.int32)
    dt = _dtype(cfg)
    x = _embed_in(params, tokens, cfg)
    for i in range(cfg.n_layers):
        lp = _layer(params, i, dt)
        x = x + _attention_decode(lp["attn"], rmsnorm(x, lp["ln1"]),
                                  cache["k"][i], cache["v"][i], lengths,
                                  active, cfg)
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

"""Decoder LM, dense, MoE, SSM and hybrid families: FlashBias-ALiBi
attention + SwiGLU MLP (dense), attention + a routed mixture of SwiGLU
experts (moe), the Mamba2 SSD block alone (ssm), or attention and SSD
branches side by side, each rms-normed and averaged, + SwiGLU MLP (hybrid).

Port of the LM paths of ``repro.models.lm``. The
parameter tree has the reference's nested keys and stacked leading-``L``
shapes (``lm_template``), so the reference's parameters carry across as a
dict copy. Layers run as a Python loop in place of ``jax.lax.scan``; each
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
- ``prefill_chunk(params, cache, tokens, cfg, offsets, chunk_lens,
  final_lens)`` — chunked prefill: one fixed-width chunk per row appended
  to the slot cache, UPDATED IN PLACE as ``decode_step`` does (contiguous
  and paged KV, or the SSM state carried from the previous chunk);
- ``init_cache`` and ``insert_cache_at_slots`` for the serve engine;
- ``init_paged_cache``, ``insert_paged_cache_at_slots`` and
  ``grow_page_tables_at_slots`` for the paged engine: a page pool shared by
  every slot, per-slot page tables, and the float32 ALiBi key-factor slab
  ``pages_phi``. ``decode_step`` and ``prefill_chunk`` take either cache;
  ``copy_paged_pages`` is prefix caching's copy-on-write.

Under an ambient mesh (``repro_torch.dist.use_mesh_rules``, set by the
sharded serve backend) the serve entry points run one rank's local shards:
its heads, kv heads, FFN columns, experts and vocab rows, with the sums and
gathers over ranks of ``repro_torch.dist.collectives`` (after ``wo``, the
FFN, the MoE combine, the embedding lookup; the logits over ``vocab``),
and the ALiBi slopes of its own heads. Outside a mesh those helpers are
the identity.

The SSM family (``mamba2_130m``) caches a constant-size state per slot:
``ssm_h (L, B, Hs, P, N)`` in float32 and the causal-conv tails ``conv_x``
and ``conv_bc`` in the compute dtype. Its prefill runs the SSD chunk scan
through ``ops.ssd_scan`` (kernel 5 on the card); its decode step updates
the state and the tails IN PLACE for active rows, as k/v are.

Sliding-window attention (``cfg.window``): prefill runs kernel 1 in its
``local`` mask mode. Where the window is shorter than the slot length
(``max_len``) the attention cache is a RING of ``window`` rows per slot:
slot ``s`` holds the last position ``p`` with ``p = s (mod window)``. Decode
writes the new row at ``(len-1) % window`` and attends over the ring in
plain torch (the reference's dense XLA window path; no decode kernel runs
there); a chunk attends to the ring as it was plus its own keys and only
then rotates in. The hybrid family (``hymba_15b``) carries the SSM state
beside its ring and runs kernel 5 in its prefill.

A hybrid whose window covers ``max_len`` keeps a full cache and pages it as
the dense family does, its SSM state and conv tails staying per-slot leaves
of the paged cache. As in the reference, only whole-prompt prefill applies
the window there (kernel 1's ``local`` mode): paged decode and paged chunk
attention take no window, so a request that grows past it attends to every
key.

The MoE family (``granite_moe_3b_a800m``, ``llama4_scout_17b_a16e``)
replaces the MLP with ``_moe_ffn``: top-k routing with capacity dispatch,
built from indices (a running count per expert, then scatters and gathers
through ``(B, E, C, D)`` buffers) where the reference builds one-hot
einsums.

``cfg.bias_mode="dense"`` is the dense-bias baseline of the dense family:
its prefill adds the materialized ALiBi bias to the logits (plain chunked
attention, no kernel); decode and chunked prefill are those of flashbias
mode, as in the reference.

The frontend configs (``musicgen_medium``, audio; ``phi3_vision_42b``,
vision) are dense models whose prompts open with ``frontend_len``
precomputed embedding rows (``batch["frontend"]``), the reference's stub of
the EnCodec / CLIP towers.

Training: ``loss_fn(params, batch, cfg)`` is the next-token cross-entropy
over the token region (the frontend rows excluded) plus 0.01 x the MoE
load-balance value, through ``forward_hidden`` (``_layer_train`` per layer
under ``cfg.remat``). Parameters stay float32 masters, cast to the compute
dtype once per call (``_compute_layers``), so gradients flow back to them.
Attention runs ``ops.flash_attention`` (kernel 1 forward on the card, its
backward the plain version's, recomputed) and the SSM branch
``ops.ssd_scan`` (kernel 5 forward, likewise).

Sharded training (the ambient mesh of ``train.make_train_step(mesh=)``)
runs the same functions on one rank's masters as laid out by
``models.common.TrainLayout``: its rows of the batch, its heads, FFN
columns, experts and vocab rows, and its ``fsdp`` shard of each weight,
gathered one layer at a time inside the layer's remat body
(``collectives.fsdp_gather``). Where a replicated activation enters a
tensor-parallel region it passes ``collectives.copy_to`` (Megatron's *f*)
and where partial products leave it ``collectives.reduce_from`` (*g*); the
logits are gathered over ``vocab`` with a slicing backward
(``gather_from``) before the cross-entropy. The SSM branch runs whole on
every ``model`` rank, as it serves.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.attention import MaskSpec, attention
from repro_torch.core.bias import alibi_dense
from repro_torch.dist.collectives import (axis_rank, axis_size, copy_to,
                                          fsdp_gather, gather_from,
                                          local_part, local_range,
                                          reduce_from)
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import paged_write_plan, write_paged_row
from repro_torch.models import ssd
from repro_torch.models.common import (
    PDef,
    compute_dtype,
    cross_entropy_loss,
    embed_lookup,
    rmsnorm,
    stack_layers,
    swiglu,
    template_map,
    tree_map,
    unembed_logits,
)

__all__ = ["lm_template", "cast_layers", "loss_fn", "forward_hidden",
           "prefill", "decode_step",
           "prefill_chunk", "init_cache", "insert_cache_at_slots",
           "init_paged_cache", "insert_paged_cache_at_slots",
           "grow_page_tables_at_slots", "copy_paged_pages"]

_ATTN = ("dense", "moe", "hybrid")       # families with attention layers
_SSM = ("ssm", "hybrid")                 # families with SSD layers
_SSM_LEAVES = ("ssm_h", "conv_x", "conv_bc")   # per-slot SSM cache leaves


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.family} family is not ported yet (ROADMAP.md Queue A "
            f"item 8)")
    if cfg.cache_layout != "kernel":
        raise ValueError(
            f"cache_layout={cfg.cache_layout!r}: the legacy canonical "
            f"layout is the reference's TPU layout A/B baseline and is not "
            f"ported; the port keeps kv-head-major caches "
            f"(cache_layout='kernel')")


def _is_ring(cfg: ArchConfig, k_cache: torch.Tensor) -> bool:
    """A layer's contiguous cache ``(B, KVH, S, hd)`` is a ring when it
    holds exactly ``window`` rows (the reference's test)."""
    return bool(cfg.window) and k_cache.shape[2] == cfg.window


# ---------------------------------------------------------------------------
# Template
# ---------------------------------------------------------------------------

def _attn_template(cfg: ArchConfig) -> dict:
    d, hp, kvp = cfg.d_model, cfg.heads_padded, cfg.kv_heads_padded
    hd = cfg.resolved_head_dim
    sd, sd_out = 0.02, 0.02 / np.sqrt(2 * cfg.n_layers)
    return {
        "wq": PDef((d, hp, hd), ("fsdp", "heads", None), ("normal", sd)),
        "wk": PDef((d, kvp, hd), ("fsdp", "kv_heads", None), ("normal", sd)),
        "wv": PDef((d, kvp, hd), ("fsdp", "kv_heads", None), ("normal", sd)),
        "wo": PDef((hp, hd, d), ("heads", None, "fsdp"), ("normal", sd_out)),
        "slopes": PDef((hp,), (None,), ("slopes", cfg.n_heads)),
    }


def _mlp_template(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": PDef((d, f, 2), ("fsdp", "mlp", None), ("normal", 0.02)),
        "wo": PDef((f, d), ("mlp", "fsdp"),
                   ("normal", 0.02 / np.sqrt(2 * cfg.n_layers))),
    }


def _ssm_template(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    hs, p, n = cfg.ssm_heads_padded, cfg.ssm_head_dim, cfg.ssm_state
    w, sd = cfg.conv_width, 0.02
    return {
        "in_x": PDef((d, hs, p), ("fsdp", "heads", None), ("normal", sd)),
        "in_z": PDef((d, hs, p), ("fsdp", "heads", None), ("normal", sd)),
        "in_b": PDef((d, n), ("fsdp", None), ("normal", sd)),
        "in_c": PDef((d, n), ("fsdp", None), ("normal", sd)),
        "in_dt": PDef((d, hs), ("fsdp", "heads"), ("normal", sd)),
        "conv_w": PDef((w, hs, p), (None, "heads", None), ("normal", 0.2)),
        "conv_bc_w": PDef((w, 2 * n), (None, None), ("normal", 0.2)),
        "a_log": PDef((hs,), ("heads",), ("zeros",)),
        "dt_bias": PDef((hs,), ("heads",), ("zeros",)),
        "d_skip": PDef((hs,), ("heads",), ("ones",)),
        "gate_norm": PDef((hs, p), ("heads", None), ("zeros",)),
        "out": PDef((hs, p, d), ("heads", None, "fsdp"),
                    ("normal", sd / np.sqrt(2 * cfg.n_layers))),
    }


def _moe_template(cfg: ArchConfig) -> dict:
    d, f, ep = cfg.d_model, cfg.d_ff, cfg.experts_padded
    return {
        "router": PDef((d, ep), ("fsdp", None), ("normal", 0.02)),
        "wi": PDef((ep, d, f, 2), ("expert", "fsdp", None, None),
                   ("normal", 0.02)),
        "wo": PDef((ep, f, d), ("expert", None, "fsdp"),
                   ("normal", 0.02 / np.sqrt(2 * cfg.n_layers))),
    }


def _layer_template(cfg: ArchConfig) -> dict:
    layer = {"ln1": PDef((cfg.d_model,), (None,), ("zeros",))}
    if cfg.family in _ATTN:
        layer["attn"] = _attn_template(cfg)
    if cfg.family in _SSM:
        layer["ssm"] = _ssm_template(cfg)
    if cfg.family == "hybrid":
        layer["branch_norm_attn"] = PDef((cfg.d_model,), (None,), ("zeros",))
        layer["branch_norm_ssm"] = PDef((cfg.d_model,), (None,), ("zeros",))
    if cfg.family == "moe":
        layer["moe"] = _moe_template(cfg)
    elif cfg.family in _ATTN:
        layer["mlp"] = _mlp_template(cfg)
    if cfg.family in _ATTN:
        layer["ln2"] = PDef((cfg.d_model,), (None,), ("zeros",))
    return layer


def lm_template(cfg: ArchConfig) -> dict:
    _check_supported(cfg)
    return {
        "embed": PDef((cfg.vocab_padded, cfg.d_model), ("vocab", "fsdp"),
                      ("normal", 0.02)),
        "layers": stack_layers(_layer_template(cfg), cfg.n_layers),
        "final_norm": PDef((cfg.d_model,), (None,), ("zeros",)),
    }


def cast_layers(params: dict, cfg: ArchConfig) -> dict:
    """The tree with ``layers`` and ``embed`` in the compute dtype (as the
    reference's per-call ``_compute_layers`` cast makes them) and
    ``final_norm`` kept as is. Serving casts once with this; the model
    functions then find nothing left to cast."""
    dt = compute_dtype(cfg)
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


def _heads_out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The attention's output projection, summed over the ranks that hold
    the other heads (the reference's ``constrain(y, "batch", "seq",
    None)`` after ``wo``; *g*: the backward passes the gradient as it
    is)."""
    return reduce_from(_out_proj(o, wo), "heads")


def _slopes(lp: dict, cfg: ArchConfig) -> Optional[torch.Tensor]:
    """The float32 ALiBi slopes of this rank's heads (all heads outside a
    mesh): the ``slopes`` leaf is replicated while the heads are split, so
    each rank's gradient holds its own heads' entries only, and ``copy_to``
    sums them over the ranks into the whole."""
    if cfg.bias_kind != "alibi":
        return None
    return local_part(copy_to(lp["slopes"].float(), "heads"), -1, "heads")


def _attention(lp: dict, x: torch.Tensor, cfg: ArchConfig):
    """Causal prefill attention, or with ``cfg.window`` causal within the
    last ``window`` positions (kernel 1's ``local`` mode). Returns (y, k, v)
    with k, v head-major ``(B, KVH, S, hd)``, the cache layout.

    ALiBi with ``bias_mode`` other than "flashbias" is the dense-bias
    baseline (the paper's A/B): the float32 ``alibi_dense`` bias of the
    real heads' published slopes (not the layer's ``slopes`` leaf, as in
    the reference), zero for the padding heads, added to the logits by the
    plain chunked ``attention`` on canonical projections. Decode and
    chunked prefill take the slopes in either mode."""
    if cfg.bias_kind == "alibi" and cfg.bias_mode != "flashbias":
        n = x.shape[1]
        bias = alibi_dense(n, n, cfg.n_heads, device=x.device)
        bias = F.pad(bias, (0, 0, 0, 0, 0, cfg.heads_padded - cfg.n_heads))
        q, k, v = (_project(x, lp[w]) for w in ("wq", "wk", "wv"))
        o = attention(q, k, v, mask=MaskSpec(_mask_kind(cfg), cfg.window),
                      bias=local_part(bias, 0, "heads")[None],
                      impl="chunked", chunk_size=cfg.attn_chunk)
        return (_heads_out(o, lp["wo"]), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous())
    q = _project(x, lp["wq"]).transpose(1, 2).contiguous()
    k = _project(x, lp["wk"]).transpose(1, 2).contiguous()
    v = _project(x, lp["wv"]).transpose(1, 2).contiguous()
    o = ops.flash_attention(q, k, v, slopes=_slopes(lp, cfg),
                            mask_kind=_mask_kind(cfg), window=cfg.window,
                            impl=cfg.attn_impl, layout="bhsd")
    return _heads_out(o.transpose(1, 2), lp["wo"]), k, v


def _mask_kind(cfg: ArchConfig) -> str:
    return "local" if cfg.window else "causal"


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
    path computes it.

    A ring cache (``window`` rows) takes the new row at slot ``(len-1) %
    window`` and is attended in plain torch (``_ring_window_attention``),
    as the reference does outside any kernel.

    Under a mesh that splits the slots over ``batch``, the pool is
    replicated over those ranks, so every replica takes every slot's row:
    ``paged["all_rows"]`` holds all slots' lengths and table rows, the new
    rows are gathered over ``batch`` and written first, and the kernel then
    attends for this rank's slots only."""
    q = _project(x, lp["wq"])                                # (B, 1, H, E)
    new = {"k_new": _project(x, lp["wk"])[:, 0],             # (B, KVH, E)
           "v_new": _project(x, lp["wv"])[:, 0]}
    if paged is not None and paged.get("all_rows") is not None:
        lens_all, table_all = paged["all_rows"]
        write_paged_row(k_cache, v_cache, lens_all, table_all,
                        *(gather_from(new[k], 0, "batch")
                          for k in ("k_new", "v_new")))
        new = {}
    if paged is None and _is_ring(cfg, k_cache):
        _ring_write(k_cache, v_cache, new["k_new"], new["v_new"], lengths)
        o = _ring_window_attention(q, k_cache, v_cache, lengths, slopes)
        return _heads_out(o, lp["wo"])
    if paged is None:
        o = ops.flash_decode(q, k_cache, v_cache, lengths, slopes=slopes,
                             impl=cfg.attn_impl, kv_layout="bhsd", **new)
        return _heads_out(o, lp["wo"])
    phi_k = None
    if phi_q is not None:
        phi_k, slopes = paged["phi"], None
    o = ops.flash_decode(q, k_cache, v_cache, lengths, phi_q=phi_q,
                         phi_k=phi_k, slopes=slopes, impl=cfg.attn_impl,
                         page_table=paged["table"],
                         max_pages=paged["max_pages"], kv_layout="bhsd",
                         **new)
    return _heads_out(o, lp["wo"])


def _ring_positions(last: torch.Tensor, w: int) -> torch.Tensor:
    """(B, W) absolute position each ring slot holds after position
    ``last`` (B,) was written: ``last - ((last - s) mod w)``, negative for
    a slot nothing has been written to."""
    slot = torch.arange(w, device=last.device)
    last = last.long()[:, None]
    return last - torch.remainder(last - slot[None, :], w)


def _ring_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor,
                lengths: torch.Tensor) -> None:
    """Write each active row's new k/v ``(B, KVH, hd)`` at ring slot
    ``(len-1) % window``, in place; a frozen row (length 0) writes back
    what its slot holds. No host read-back."""
    b, w = k_cache.shape[0], k_cache.shape[2]
    rows = torch.arange(b, device=k_cache.device)
    slot = torch.remainder(lengths.long() - 1, w)
    keep = (lengths > 0)[:, None, None]
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[rows, :, slot] = torch.where(keep, new.to(cache.dtype),
                                           cache[rows, :, slot])


def _ring_window_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor,
                           slopes: Optional[torch.Tensor]) -> torch.Tensor:
    """One-token attention over a ring ``(B, KVH, W, hd)`` in float32, as
    the reference's ``_ring_window_attention``: slot ``s`` holds absolute
    position ``p = len-1 - ((len-1 - s) mod W)``, valid iff ``p >= 0``; the
    ALiBi bias comes from the absolute positions. q (B, 1, H, E) -> (B, 1,
    H, E) in q's dtype."""
    b, _, h, e = q.shape
    kvh, w = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    last = lengths.long() - 1
    pos = _ring_positions(last, w)                       # (B, W)
    qg = q[:, 0].reshape(b, kvh, g, e).float()
    s = torch.einsum("bkge,bkwe->bkgw", qg, k_cache.float()) * (
        1.0 / float(np.sqrt(e)))
    if slopes is not None:
        rel = (pos - last[:, None]).float()              # <= 0
        s = s + slopes.reshape(kvh, g)[None, :, :, None] \
            * rel[:, None, None, :]
    s = torch.where((pos >= 0)[:, None, None, :], s,
                    torch.full((), -1e30, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bkwe->bkge", p, v_cache.float())
    return o.reshape(b, 1, h, e).to(q.dtype)


def _ring_chunk_attention(q: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, offsets: torch.Tensor,
                          chunk_lens: torch.Tensor,
                          slopes: Optional[torch.Tensor]) -> torch.Tensor:
    """C-token chunk attention against a ring ``(B, KVH, W, hd)`` that the
    chunk has NOT been written to yet, in float32, as the reference's ring
    branch of ``_attention_chunk``: a later chunk position may alias the
    ring slot an earlier query still needs, so queries read old keys from
    the ring as it was (slot valid if written and inside the query's
    window) plus the chunk's own keys (causal, inside the window). q (B, C,
    H, E), k_new / v_new (B, C, KVH, E) -> (B, C, H, E) in q's dtype."""
    b, c, h, e = q.shape
    kvh, w = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    dev = q.device
    scale = 1.0 / float(np.sqrt(e))
    i = torch.arange(c, device=dev)
    offs = offsets.long()
    pos = offs[:, None] + i[None, :]                             # (B, C)
    p_old = _ring_positions(offs - 1, w)                         # (B, W)
    written = (p_old >= 0) & (offs[:, None] > 0)
    qg = q.reshape(b, c, kvh, g, e).permute(0, 2, 3, 1, 4).float()
    kn = k_new.permute(0, 2, 1, 3).float()                       # (B,KVH,C,E)
    vn = v_new.permute(0, 2, 1, 3).float()
    s_old = torch.einsum("bkgce,bkwe->bkgcw", qg, k_cache.float()) * scale
    s_in = torch.einsum("bkgce,bkje->bkgcj", qg, kn) * scale
    if slopes is not None:
        sl = slopes.reshape(kvh, g)[None, :, :, None, None]
        rel_old = (p_old[:, None, :] - pos[:, :, None]).float()
        rel_in = (i[None, :] - i[:, None]).float()               # (C, C)
        s_old = s_old + sl * rel_old[:, None, None]
        s_in = s_in + sl * rel_in[None, None, None]
    m_old = written[:, None, :] & (p_old[:, None, :] > pos[:, :, None] - w)
    m_in = (((i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < w))
            [None] & (i[None, None, :] < chunk_lens.long()[:, None, None]))
    neg = torch.full((), -1e30, device=dev)
    p_all = torch.softmax(torch.cat([
        torch.where(m_old[:, None, None], s_old, neg),
        torch.where(m_in[:, None, None], s_in, neg)], dim=-1), dim=-1)
    o = (torch.einsum("bkgcw,bkwe->bkgce", p_all[..., :w], v_cache.float())
         + torch.einsum("bkgcj,bkje->bkgce", p_all[..., w:], vn))
    return o.permute(0, 3, 1, 2, 4).reshape(b, c, h, e).to(q.dtype)


def _attention_chunk(lp: dict, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cfg: ArchConfig, *,
                     slopes: Optional[torch.Tensor], chunk: dict,
                     paged: Optional[dict] = None) -> torch.Tensor:
    """C-token chunk attention against one layer's cache, contiguous ``(B,
    KVH, S, hd)`` or (``paged`` given) a page pool ``(KVH, n_pages, ps,
    hd)``. The chunk's k/v rows are scattered into the cache FIRST, in
    place, at the places ``chunk`` planned (``_chunk_plan``: rows with
    ``chunk_lens 0`` write nothing), and the queries then attend to the
    written cache under the offset causal mask
    (``ops.flash_chunk_attention``). A ring cache attends FIRST
    (``_ring_chunk_attention``) and then takes the chunk's rows at their
    ring slots."""
    q = _project(x, lp["wq"])                                # (B, C, H, E)
    k_new, v_new = _project(x, lp["wk"]), _project(x, lp["wv"])
    if paged is None and _is_ring(cfg, k_cache):
        o = _ring_chunk_attention(q, k_new, v_new, k_cache, v_cache,
                                  chunk["offsets"], chunk["chunk_lens"],
                                  slopes)
        rows, cols, pos = chunk["rows"], chunk["cols"], chunk["pos"]
        if rows is not None:
            k_cache[rows, :, pos] = k_new[rows, cols]
            v_cache[rows, :, pos] = v_new[rows, cols]
        return _heads_out(o, lp["wo"])
    if paged is None:
        rows, cols, pos = chunk["rows"], chunk["cols"], chunk["pos"]
        if rows is not None:
            k_cache[rows, :, pos] = k_new[rows, cols]
            v_cache[rows, :, pos] = v_new[rows, cols]
        o = ops.flash_chunk_attention(
            q, k_cache, v_cache, chunk["offsets"], chunk["chunk_lens"],
            slopes, impl=cfg.attn_impl, kv_layout="bhsd")
        return _heads_out(o, lp["wo"])
    if chunk["page"] is not None:
        page, off, keep = chunk["page"], chunk["off"], chunk["keep"]
        rows, cols = chunk["src_rows"], chunk["src_cols"]
        if chunk.get("all_rows"):        # every slot's rows, every replica
            k_new, v_new = (gather_from(t, 0, "batch")
                            for t in (k_new, v_new))
        for pool, new in ((k_cache, k_new), (v_cache, v_new)):
            val = new[rows, cols].transpose(0, 1)            # (KVH, n, E)
            pool[:, page, off] = torch.where(keep, val, pool[:, page, off])
    o = ops.flash_chunk_attention(
        q, k_cache, v_cache, chunk["offsets"], chunk["chunk_lens"], slopes,
        impl=cfg.attn_impl, page_table=paged["table"],
        max_pages=paged["max_pages"], kv_layout="bhsd")
    return _heads_out(o, lp["wo"])


def _ffn(lp: dict, x: torch.Tensor, cfg: ArchConfig,
         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer's FFN update of the rms-normed residual: the SwiGLU MLP,
    or (moe) the routed experts, ``valid`` (B, S) marking the positions
    that take expert capacity."""
    h = rmsnorm(x, lp["ln2"])
    if cfg.family == "moe":
        return _moe_ffn(lp["moe"], h, cfg, valid)[0]
    return reduce_from(swiglu(copy_to(h, "mlp"), lp["mlp"]["wi"],
                              lp["mlp"]["wo"]), "mlp")


# ---------------------------------------------------------------------------
# MoE FFN (capacity dispatch)
# ---------------------------------------------------------------------------

def _moe_capacity(cfg: ArchConfig, s: int) -> int:
    """Slots per expert in a call of width ``s`` (the reference's rule)."""
    c = int(np.ceil(s * cfg.top_k / cfg.experts_padded * cfg.capacity_factor))
    return max(1, c)


def _moe_route(mp: dict, x: torch.Tensor, cfg: ArchConfig):
    """The router: float32 logits with the padded experts' set to -1e30,
    softmax, top k, gates renormalised over the k. x (B, S, D) -> (probs
    (B, S, E), gates (B, S, K), experts (B, S, K))."""
    logits = (x @ mp["router"]).float()
    if cfg.n_experts < cfg.experts_padded:       # padded experts never win
        logits = logits.masked_fill(torch.arange(
            cfg.experts_padded, device=x.device) >= cfg.n_experts, -1e30)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx


def _moe_ffn(mp: dict, x: torch.Tensor, cfg: ArchConfig,
             valid: Optional[torch.Tensor] = None):
    """Top-k routed SwiGLU experts with capacity dispatch, the reference's
    ``_moe_ffn``. x (B, S, D) -> (y (B, S, D), aux):

    - the router (``_moe_route``);
    - each batch row's entries in slot-major order (every position's first
      choice before any second choice, sequence order within a choice)
      take their expert's next slot while fewer than ``_moe_capacity(cfg,
      S)`` are taken; the rest are dropped;
    - ``valid`` (B, S) bool: invalid positions take no capacity and get a
      zero update;
    - ``aux`` is the Switch load-balance value over the real experts.

    The dispatch is built from indices: a running count per expert gives
    each entry its slot, kept entries are scattered into a ``(B, E, C, D)``
    buffer (dropped ones into a spare row), the expert products run as
    batched GEMMs, and each position gathers its k outputs back and sums
    them with its gates in float32.

    Under a mesh that splits the experts (``"expert"``), every rank routes
    the whole batch, runs its own experts' GEMMs, and the ranks sum the
    gated outputs in float32 (the reference's combine over ``expert``).
    The router's own gradient is whole on every rank; the dispatched rows
    and the gates pass ``copy_to``, whose backward sums the parts the
    ranks' experts give."""
    b, s, d = x.shape
    ep, k = cfg.experts_padded, cfg.top_k
    cap = _moe_capacity(cfg, s)
    dev = x.device
    probs, gates, idx = _moe_route(mp, x, cfg)                   # (B, S, K)
    sel = idx.transpose(1, 2).reshape(b, k * s)                  # slot-major
    gate = copy_to(gates, "expert").transpose(1, 2).reshape(b * k * s, 1)
    ok = (torch.ones_like(sel, dtype=torch.bool) if valid is None
          else valid[:, None, :].expand(b, k, s).reshape(b, k * s))
    # (B, E, K*S): the running count is a scan along the innermost axis
    onehot = ((sel[:, None, :] == torch.arange(ep, device=dev)[:, None])
              & ok[:, None, :]).to(torch.int32)
    pos = (onehot.cumsum(-1, dtype=torch.int32) - onehot).gather(
        1, sel[:, None, :])[:, 0]
    keep = ok & (pos < cap)
    spare = b * ep * cap
    row = (torch.arange(b, device=dev)[:, None] * ep + sel) * cap + pos
    row = torch.where(keep, row, spare).reshape(-1)              # (B*K*S,)
    xin = x.new_zeros((spare + 1, d))
    # kept entries land on distinct rows; every dropped one on the spare
    xin[row] = copy_to(x, "expert")[:, None].expand(b, k, s, d).reshape(-1, d)
    wi = mp["wi"]                                                # (E,D,F,2)
    el = wi.shape[0]                     # this rank's experts (all: ep)
    e0 = axis_rank("expert") * el
    xe = xin[:spare].view(b, ep, cap, d)[:, e0:e0 + el].transpose(
        0, 1).reshape(el, b * cap, d)
    h2 = torch.bmm(xe, wi.reshape(el, d, -1)).unflatten(-1, wi.shape[2:])
    eo = torch.bmm(F.silu(h2[..., 0]) * h2[..., 1], mp["wo"])   # (E,B*C,D)
    if el < ep:                          # the other ranks' experts add 0
        eo = F.pad(eo.view(el, b, cap, d),
                   (0, 0, 0, 0, 0, 0, e0, ep - e0 - el))
    eo = eo.view(ep, b, cap, d).transpose(0, 1).reshape(spare, d)
    eo = torch.cat([eo, eo.new_zeros((1, d))])
    y = reduce_from((eo[row].float() * gate).view(b, k, s, d).sum(1),
                    "expert")
    counts = torch.zeros((b, ep), device=dev).scatter_add_(
        1, sel, keep.float())
    frac = counts / max(s * k, 1)
    aux = cfg.n_experts * (frac * probs.mean(1)).sum(-1).mean()
    return y.to(x.dtype), aux


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
                 h0: Optional[torch.Tensor] = None,
                 tail_x: Optional[torch.Tensor] = None,
                 tail_bc: Optional[torch.Tensor] = None,
                 lengths: Optional[torch.Tensor] = None):
    """Full-sequence SSD. Returns (y (B, S, D), h_fin, tail_x, tail_bc).

    ``h0`` and the conv tails ``tail_x`` / ``tail_bc`` carry the state of
    the positions before ``x`` (a prefill chunk's; zeros when None).
    ``lengths`` (B,) marks the valid prefix of a right-padded batch: padded
    positions get dt = 0, which makes their state update the identity, so
    ``h_fin`` and the conv tails are the state after position
    ``lengths[b]-1``."""
    xs, z, bmat, cmat, dt, tail_x, tail_bc = _ssm_conv_inputs(
        sp, x, cfg, tail_x, tail_bc, lengths)
    dt, a = _ssm_dt_a(sp, dt)
    if lengths is not None:
        keep = (torch.arange(x.shape[1], device=x.device)[None, :]
                < lengths[:, None])
        dt = torch.where(keep[:, :, None], dt,
                         torch.zeros((), device=x.device))
    y, h_fin = ops.ssd_scan(xs.float(), dt, a, bmat.float(), cmat.float(),
                            chunk=cfg.ssd_chunk, h0=h0, impl=cfg.attn_impl)
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

def _embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``tokens``. With the table split over ``vocab`` (a
    mesh), each rank looks up the ids its rows hold, zeroes the others, and
    the ranks sum: one nonzero term per entry, so the rows are exact. The
    sum is *g*: in training each rank's table takes the gradient of the
    rows it looked up."""
    if axis_size("vocab") == 1:
        return embed_lookup(table, tokens)
    local = tokens - axis_rank("vocab") * table.shape[0]
    hit = ((local >= 0) & (local < table.shape[0]))[..., None]
    rows = embed_lookup(table, local.clamp(0, table.shape[0] - 1))
    return reduce_from(torch.where(hit, rows, torch.zeros_like(rows)),
                       "vocab")


def _embed_in(params: dict, tokens: torch.Tensor,
              frontend: Optional[torch.Tensor],
              cfg: ArchConfig) -> torch.Tensor:
    """Token embeddings in the compute dtype, scaled by sqrt(d_model), with
    the frontend rows ``(B, F, D)`` (precomputed audio / vision embeddings)
    prepended in the compute dtype, unscaled, as the reference does."""
    dt = compute_dtype(cfg)
    x = _embed_rows(params["embed"], tokens).to(dt)
    x = x * float(np.sqrt(cfg.d_model))
    if frontend is not None:
        x = torch.cat([frontend.to(dt), x], dim=1)
    return x


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _layer_train(lp: dict, x: torch.Tensor, cfg: ArchConfig):
    """Full-sequence layer (training): the prefill layer without its cache
    entries. Returns (x, aux), ``aux`` the MoE load-balance value (0 for
    the other families). Attention is causal, or local with ``cfg.window``
    (the hybrid family's)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(x, lp["ln1"])
    y = ys = None
    if cfg.family in _ATTN:
        y = _attention(lp["attn"], copy_to(h, "heads"), cfg)[0]
    if cfg.family in _SSM:
        ys = _ssm_forward(lp["ssm"], h, cfg)[0]
    x = _mix(lp, x, y, ys, cfg)
    if cfg.family == "moe":
        y2, aux = _moe_ffn(lp["moe"], rmsnorm(x, lp["ln2"]), cfg)
        x = x + y2
    elif cfg.family in _ATTN:
        x = x + _ffn(lp, x, cfg)
    return x, aux


# matrix products without a batch dim: what the "dots" policy saves, as the
# reference's ``dots_with_no_batch_dims_saveable`` (bmm is left out). The
# functional collectives of a sharded step (the FSDP gathers) are not
# among them: their outputs are recomputed, so the backward gathers again
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, cfg: ArchConfig):
    """``fn`` under ``cfg.remat``: ``"none"`` keeps every activation;
    ``"full"`` checkpoints it (``torch.utils.checkpoint``, non-reentrant),
    saving its inputs only and recomputing the rest in the backward;
    ``"dots"`` checkpoints it with a selective policy that saves the
    outputs of the matrix products without a batch dim and recomputes the
    rest. A kernel launched through ctypes is no aten op, so no policy can
    keep its output: under ``"full"`` and ``"dots"`` kernel 1 (and kernel
    5) runs again when the backward recomputes the layer."""
    if cfg.remat == "none":
        return fn
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts)
    if cfg.remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if cfg.remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _dots_policy)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=ctx)
    raise ValueError(f"remat {cfg.remat!r} not in ('none', 'dots', 'full')")


def _compute_layers(params: dict, cfg: ArchConfig,
                    cast: bool = True) -> dict:
    """The stacked layer weights cast to the compute dtype once and split
    into per-layer views (the reference casts them before its layer scan):
    {key: (layer 0, ..., layer L-1)}. Gradients flow back to the float32
    masters through one cast and one stack per leaf. Indexing the stacked
    masters per layer instead would make each layer's backward fill and add
    a gradient of the whole stack (a 3.9 GB MLP leaf of GPT-2 1.5B, 48
    times per microbatch).

    Under a mesh the masters are this rank's local shards and the split is
    local. Where ``fsdp`` spans more than one rank, ``cast=False`` keeps
    the float32 views: ``forward_hidden`` casts each layer's shards and
    gathers its ``fsdp`` ones (``_fsdp_dims``, ``_gather_fsdp``) one layer
    at a time inside the layer's remat body, so only one layer's weights
    are whole at a time, in the compute dtype, remat gathers them again in
    the backward (ZeRO-3), and the gradient is reduce-scattered in
    float32."""
    dt = compute_dtype(cfg)
    return tree_map(lambda x: (x.to(dt) if cast else x).unbind(0),
                    params["layers"])


def _fsdp_dims(tmpl: dict, tree: dict, lead: int = 0) -> dict:
    """Per leaf of ``tree`` (local shards of ``tmpl``'s leaves), the dim of
    its ``fsdp`` axis where the shard is split (smaller than the
    template's), else None; ``lead`` leading dims are dropped from the
    index (the stacked layers')."""
    def dim(p, t, _):
        if "fsdp" not in p.axes:
            return None
        d = p.axes.index("fsdp")
        return None if t.shape[d] == p.shape[d] else d - lead
    return template_map(dim, tmpl, tree)


def _gather_fsdp(tree: dict, dims: dict, dtype: torch.dtype) -> dict:
    """``tree`` cast to ``dtype``, every leaf whose ``dims`` entry is set
    gathered over ``fsdp`` along that dim (``fsdp_gather``: the gradient
    reduce-scattered in the leaf's float32)."""
    if isinstance(tree, dict):
        return {k: _gather_fsdp(tree[k], dims[k], dtype) for k in tree}
    return tree.to(dtype) if dims is None else fsdp_gather(tree, dims,
                                                           dtype)


def _whole_embed(params: dict, cfg: ArchConfig) -> dict:
    """``params`` with the tied ``embed`` table gathered over ``fsdp``
    where this rank holds a shard of its ``d_model`` columns (float32, as
    the lookup reads it; ``loss_fn`` gathers it once for both uses)."""
    p = lm_template(cfg)["embed"]
    d = p.axes.index("fsdp")
    if axis_size("fsdp") == 1 or params["embed"].shape[d] == p.shape[d]:
        return params
    return dict(params, embed=fsdp_gather(params["embed"], d))


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                   frontend: Optional[torch.Tensor] = None):
    """Embedding, the layers (each under ``cfg.remat``) and the final norm.
    Returns (hidden (B, F + S, D), aux summed over the layers). The float32
    master weights are cast to the compute dtype per call
    (``_compute_layers``), so gradients flow back to the masters; under a
    mesh each layer's ``fsdp`` shards are gathered inside its body, and the
    ``embed`` table must be whole over ``fsdp`` (``_whole_embed``)."""
    _check_supported(cfg)
    x = _embed_in(params, tokens, frontend, cfg)
    dims = None
    if axis_size("fsdp") > 1:
        dims = _fsdp_dims(lm_template(cfg)["layers"], params["layers"],
                          lead=1)
    layers = _compute_layers(params, cfg, cast=dims is None)
    dt = compute_dtype(cfg)

    def body(x, i):
        lp = tree_map(lambda t: t[i], layers)
        if dims is not None:
            lp = _gather_fsdp(lp, dims, dt)
        return _layer_train(lp, x, cfg)

    body = _maybe_remat(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = body(x, i)
        aux = aux + a
    return rmsnorm(x, params["final_norm"]), aux


def loss_fn(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Next-token cross-entropy over the token region (the frontend rows
    excluded) against ``batch["labels"]``, plus 0.01 x the MoE aux. Under
    a mesh splitting ``vocab``, the logits of this rank's vocab rows are
    gathered over the ranks before the cross-entropy (``gather_from``:
    every rank then computes the whole loss of its batch rows)."""
    params = _whole_embed(params, cfg)
    frontend = batch.get("frontend")
    hid, aux = forward_hidden(params, batch["tokens"], cfg, frontend)
    if frontend is not None:
        hid = hid[:, frontend.shape[1]:]
    logits = gather_from(unembed_logits(copy_to(hid, "vocab"),
                                        params["embed"].to(hid.dtype)),
                         -1, "vocab")
    return cross_entropy_loss(logits, batch["labels"], cfg.vocab) \
        + 0.01 * aux


def _logits(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Tied unembedding; a ``vocab``-split table's logits are gathered over
    the ranks (the reference constrains them to ``vocab``)."""
    hid = rmsnorm(x, params["final_norm"])
    return gather_from(unembed_logits(hid, params["embed"].to(hid.dtype)),
                       -1, "vocab")


def _mix(lp: dict, x: torch.Tensor, y: Optional[torch.Tensor],
         ys: Optional[torch.Tensor], cfg: ArchConfig) -> torch.Tensor:
    """The residual update of a layer's token mixers: the attention output
    (dense, moe), the SSD output (ssm), or their rms-normed mean
    (hybrid)."""
    if cfg.family in ("dense", "moe"):
        return x + y
    if cfg.family == "ssm":
        return x + ys
    return x + 0.5 * (rmsnorm(y, lp["branch_norm_attn"])
                      + rmsnorm(ys, lp["branch_norm_ssm"]))


def _ring_gather(k: torch.Tensor, lengths: torch.Tensor,
                 w: int) -> torch.Tensor:
    """The ring a prompt longer than the window leaves: slot ``s`` of row
    ``b`` holds position ``p = len_b-1 - ((len_b-1 - s) mod w)``, clipped to
    0 where no such position exists (junk that decode's ``p >= 0`` test
    never reads). k (B, KVH, S, hd) -> (B, KVH, w, hd)."""
    pos = _ring_positions(lengths - 1, w).clamp(0, k.shape[2] - 1)
    idx = pos[:, None, :, None].expand(-1, k.shape[1], -1, k.shape[3])
    return torch.gather(k, 2, idx)


def prefill(params: dict, batch: dict, cfg: ArchConfig, *,
            max_len: Optional[int] = None,
            lengths: Optional[torch.Tensor] = None):
    """Run the prompts; return (last-position logits (B, 1, V), cache).

    ``lengths`` (B,) enables ragged right-padded prompts: row ``b``'s
    prompt is positions ``0 .. lengths[b]-1`` and its logits are gathered
    there (the causal mask already keeps padding out of real queries; the
    SSD state and conv tails freeze at ``lengths[b]-1``). The attention
    cache holds every computed position, zero-padded to ``max_len``; with a
    window shorter than ``max_len`` it is a ring of ``window`` rows, padded
    when the prompt fits the window and gathered otherwise (slot ``s`` holds
    the last position ``p = s (mod window)`` of each row's prompt). The SSM
    and hybrid families carry ``ssm_h`` / ``conv_x`` / ``conv_bc``.

    ``batch["frontend"]`` (B, F, D), where given, is prepended to the token
    embeddings (``_embed_in``): the sequence is then F + S positions wide,
    the valid prompt of row ``b`` (frontend included) is positions ``0 ..
    lengths[b]-1``, and ALiBi distances, cache positions and the page
    budget count the frontend rows."""
    _check_supported(cfg)
    tokens, frontend = batch["tokens"], batch.get("frontend")
    b = tokens.shape[0]
    s = tokens.shape[1] + (0 if frontend is None else frontend.shape[1])
    max_len = max_len or s
    dt, dev = compute_dtype(cfg), tokens.device
    if lengths is not None:
        lengths = lengths.to(device=dev, dtype=torch.int32)
    full = torch.full((b,), s, dtype=torch.int32, device=dev)
    cache = {}
    if cfg.family in _ATTN:
        ring = bool(cfg.window) and cfg.window < max_len
        sc = cfg.window if ring else max_len
        if sc < s and not ring:
            raise ValueError(f"max_len {max_len} < prompt width {s}")
        shape = (cfg.n_layers, b,            # this rank's kv heads
                 cfg.kv_heads_padded // axis_size("kv_heads"), sc,
                 cfg.resolved_head_dim)
        alloc = torch.zeros if sc > s else torch.empty
        cache["k"] = alloc(shape, dtype=dt, device=dev)
        cache["v"] = alloc(shape, dtype=dt, device=dev)
    states, tails_x, tails_bc = [], [], []
    valid = None                     # MoE capacity ignores the padding
    if lengths is not None and cfg.family == "moe":
        valid = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    x = _embed_in(params, tokens, frontend, cfg)
    for i in range(cfg.n_layers):
        lp = _layer(params, i, dt)
        h = rmsnorm(x, lp["ln1"])
        y = ys = None
        if cfg.family in _ATTN:
            y, k, v = _attention(lp["attn"], h, cfg)
            for key, new in (("k", k), ("v", v)):
                if sc >= s:
                    cache[key][i, :, :, :s] = new
                else:
                    cache[key][i] = _ring_gather(
                        new, full if lengths is None else lengths, sc)
        if cfg.family in _SSM:
            ys, h_fin, tail_x, tail_bc = _ssm_forward(lp["ssm"], h, cfg,
                                                      lengths=lengths)
            states.append(h_fin)
            tails_x.append(tail_x)
            tails_bc.append(tail_bc)
        x = _mix(lp, x, y, ys, cfg)
        if cfg.family in _ATTN:
            x = x + _ffn(lp, x, cfg, valid)
    if lengths is None:
        lengths = full
    last = x[torch.arange(b, device=dev), (lengths - 1).long()][:, None]
    cache["length"] = lengths
    if states:
        cache.update(ssm_h=torch.stack(states), conv_x=torch.stack(tails_x),
                     conv_bc=torch.stack(tails_bc))
    return _logits(params, last, cfg), cache


def _ssm_decode_layer(sp: dict, x: torch.Tensor, cache: dict, i: int,
                      active: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Layer ``i``'s SSD decode: state and conv tails of active rows updated
    in place; rows with length 0 keep theirs bit-identical."""
    h, tx, tbc = cache["ssm_h"][i], cache["conv_x"][i], cache["conv_bc"][i]
    y, h_new, tx_new, tbc_new = _ssm_decode(sp, x, h, tx, tbc, cfg)
    keep4 = active[:, None, None, None]
    h.copy_(torch.where(keep4, h_new, h))
    tx.copy_(torch.where(keep4, tx_new, tx))
    tbc.copy_(torch.where(active[:, None, None], tbc_new, tbc))
    return y


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ArchConfig, *, max_pages: Optional[int] = None):
    """One decode step: ``tokens (B, 1)`` land at position
    ``cache["length"]``. Rows with length 0 are inactive and frozen: no
    cache write, no length advance. Returns (logits (B, 1, V), cache) — the
    new cache dict shares the k/v tensors (or pools) and the SSM state,
    which were updated in place.

    A paged cache (``"pages_k"`` in it) is read through its page table;
    ``max_pages`` caps the pages any row references this step (the serve
    engine passes a power-of-two rounding of its host-side longest length)
    and bounds the plain path's gather. The new position's factor row
    ``[1, pos]`` is written to the slab once, outside the layer loop. A
    ring cache takes the new row at ``(len-1) % window``.

    Under a mesh (``repro_torch.dist``) the call runs this rank's shards:
    its slots' rows where ``batch`` is split (the paged pool, the page
    table and the factor slab stay whole, and take every slot's writes) and
    its heads, FFN columns, experts and vocab rows where ``model`` is."""
    _check_supported(cfg)
    active = cache["length"] > 0
    lengths = cache["length"] + active.to(torch.int32)
    dt = compute_dtype(cfg)
    x = _embed_in(params, tokens, None, cfg)
    # every layer's float32 slopes (and, paged in phi mode, phi_q) at once:
    # one copy per step, not one per layer
    slopes = phi_q = paged = None
    if cfg.family in _ATTN and cfg.bias_kind == "alibi":
        slopes = local_part(params["layers"]["attn"]["slopes"].to(dt).float(),
                            1, "heads")                              # (L, H)
    if "pages_k" in cache:
        n_pages, ps = cache["pages_k"].shape[2], cache["pages_k"].shape[3]
        table = cache["page_table"]
        phi = cache.get("pages_phi")
        paged = {"table": table, "phi": phi, "max_pages": max_pages}
        lens_all, act_all = lengths, active
        if axis_size("batch") > 1:       # this rank's slots of a whole pool
            lens_all = gather_from(lengths, 0, "batch")
            act_all = lens_all > 0
            paged["table"] = table[local_range(table.shape[0], "batch")]
            paged["all_rows"] = (lens_all, table)
        if phi is not None:
            page, off, src, keep = paged_write_plan(
                table, torch.arange(lens_all.shape[0], device=table.device),
                torch.where(act_all, lens_all - 1, 0), act_all, n_pages, ps)
            pos = (lens_all - 1).float()
            one = torch.ones_like(pos)
            row = torch.stack([one, pos], -1)[src]
            phi[page, off] = torch.where(keep[:, None], row, phi[page, off])
            if lens_all is not lengths:  # phi_q of this rank's slots
                pos = (lengths - 1).float()
                one = torch.ones_like(pos)
            if slopes is not None:                 # (L, B, 1, H, 2)
                phi_q = (torch.stack([-pos, one], -1)[None, :, None, None]
                         * slopes[:, None, None, :, None])
        k_all, v_all = cache["pages_k"], cache["pages_v"]
    else:
        k_all, v_all = cache.get("k"), cache.get("v")
    for i in range(cfg.n_layers):
        lp = _layer(params, i, dt)
        h = rmsnorm(x, lp["ln1"])
        y = ys = None
        if cfg.family in _ATTN:
            y = _attention_decode(
                lp["attn"], h, k_all[i], v_all[i], lengths, cfg,
                slopes=None if slopes is None else slopes[i],
                phi_q=None if phi_q is None else phi_q[i], paged=paged)
        if cfg.family in _SSM:
            ys = _ssm_decode_layer(lp["ssm"], h, cache, i, active, cfg)
        x = _mix(lp, x, y, ys, cfg)
        if cfg.family in _ATTN:
            x = x + _ffn(lp, x, cfg)
    return _logits(params, x, cfg), {**cache, "length": lengths}


def _chunk_plan(cache: dict, offsets: np.ndarray, chunk_lens: np.ndarray,
                c: int, dev, ring: int = 0) -> dict:
    """Where a chunk's valid positions land, planned once per call from the
    host arrays: ``offsets`` / ``chunk_lens`` on the device, and for
    contiguous caches the ``(rows, cols, pos)`` of every valid entry (None
    when no row writes); a ring of ``ring`` rows takes position ``p`` at
    slot ``p % ring``. Paged, ``paged_write_plan`` finds the pages in the
    device table (an entry whose table entry lies outside the pool repeats
    another's write, ``keep`` False), and ``src_rows`` / ``src_cols`` say
    which chunk row each write carries."""
    rows, cols = np.nonzero(np.arange(c)[None, :] < chunk_lens[:, None])
    pos = offsets[rows] + cols
    plan = {"offsets": torch.as_tensor(offsets, device=dev),
            "chunk_lens": torch.as_tensor(chunk_lens, device=dev),
            "rows": None, "cols": None, "pos": None, "page": None}
    if not rows.size or not ("k" in cache or "pages_k" in cache):
        return plan                     # nothing writes, or SSM state only
    rows_t, cols_t = (torch.as_tensor(a, device=dev) for a in (rows, cols))
    if "pages_k" not in cache:
        s_len = cache["k"].shape[3]
        if ring:
            if c > ring:
                raise ValueError(f"a chunk of {c} exceeds the {ring}-row "
                                 f"ring: its positions would share slots")
            pos = pos % ring
        elif pos.max() >= s_len:
            raise ValueError(f"chunk reaches position {pos.max()} of a "
                             f"{s_len}-position cache")
        plan.update(rows=rows_t, cols=cols_t,
                    pos=torch.as_tensor(pos, device=dev))
        return plan
    n_pages, ps = cache["pages_k"].shape[2], cache["pages_k"].shape[3]
    table = cache["page_table"]
    if pos.max() // ps >= table.shape[1]:
        raise ValueError(f"chunk reaches block {pos.max() // ps} of a "
                         f"{table.shape[1]}-page table row")
    pos_t = torch.as_tensor(pos, device=dev)
    page, off, src, keep = paged_write_plan(
        table, rows_t, pos_t, torch.ones_like(rows_t, dtype=torch.bool),
        n_pages, ps)
    plan.update(page=page, off=off, keep=keep[None, :, None],
                src_rows=rows_t[src], src_cols=cols_t[src])
    if "pages_phi" in cache:
        pos_f = pos_t[src].float()
        plan["phi_row"] = torch.stack([torch.ones_like(pos_f), pos_f], -1)
    return plan


def _layer_chunk(lp: dict, i: int, cache: dict, x: torch.Tensor,
                 cfg: ArchConfig, *, chunk: dict,
                 slopes: Optional[torch.Tensor],
                 paged: Optional[dict]) -> torch.Tensor:
    """Layer ``i`` of chunked prefill: the chunk appended to the layer's
    cache in place, as ``decode_step`` updates it. Rows with ``chunk_lens
    0`` keep their cache bit-identical. SSM rows starting a prompt (offset
    0) start from zero state, since the slot may hold a prior occupant's;
    continuation chunks carry the cached state and conv tails."""
    h = rmsnorm(x, lp["ln1"])
    y = ys = None
    if cfg.family in _ATTN:
        kk, vv = ("pages_k", "pages_v") if paged is not None else ("k", "v")
        y = _attention_chunk(lp["attn"], h, cache[kk][i], cache[vv][i], cfg,
                             slopes=slopes, chunk=chunk, paged=paged)
    if cfg.family in _SSM:
        first, part = chunk["offsets"] == 0, chunk["chunk_lens"] > 0
        st, tx = cache["ssm_h"][i], cache["conv_x"][i]
        tbc = cache["conv_bc"][i]
        zero = torch.zeros((), dtype=st.dtype, device=st.device)
        f4, p4 = first[:, None, None, None], part[:, None, None, None]
        ys, h_fin, tx_new, tbc_new = _ssm_forward(
            lp["ssm"], h, cfg, h0=torch.where(f4, zero, st),
            tail_x=torch.where(f4, zero.to(tx.dtype), tx),
            tail_bc=torch.where(first[:, None, None], zero.to(tbc.dtype), tbc),
            lengths=chunk["chunk_lens"])
        st.copy_(torch.where(p4, h_fin, st))
        tx.copy_(torch.where(p4, tx_new, tx))
        tbc.copy_(torch.where(part[:, None, None], tbc_new, tbc))
    x = _mix(lp, x, y, ys, cfg)
    if cfg.family in _ATTN:
        x = x + _ffn(lp, x, cfg, chunk.get("valid"))
    return x


def prefill_chunk(params: dict, cache: dict, tokens: torch.Tensor,
                  cfg: ArchConfig, *, offsets, chunk_lens, final_lens,
                  max_pages: Optional[int] = None):
    """One chunked-prefill step: a C-token chunk appended per slot row.
    Returns ``(logits (B, 1, V), cache)``; the cache's tensors are UPDATED
    IN PLACE (the returned dict holds a new ``length``).

    The contract the serve backend's planner drives (the reference's):

    - ``tokens`` (B, C) on the device, one right-padded chunk per row: row
      ``b``'s valid tokens ``tokens[b, :chunk_lens[b]]`` land at positions
      ``offsets[b] .. offsets[b]+chunk_lens[b]-1``. ``chunk_lens[b] == 0``
      is a frozen lane (a decoding or an empty slot): its cache stays
      bit-identical.
    - ``offsets[b] == 0`` starts a prompt: the SSM state and conv tails
      restart from zero; KV needs no reset, as the offset causal mask never
      reads past the written prefix (a ring's slots count as unwritten at
      offset 0). A ring takes chunks of at most ``window`` tokens.
    - ``final_lens`` (B,) is the row's new ``length`` where ``>= 0`` and
      "keep" where negative. Mid-prompt chunks pass -1, so the length stays
      0 and interleaved ``decode_step`` calls keep the lane frozen; the
      last chunk passes the prompt length.
    - The logits are gathered at each row's last valid chunk position:
      meaningful for a final chunk (the first sampled token) only.

    ``offsets``, ``chunk_lens`` and ``final_lens`` are host arrays (numpy,
    or CPU tensors): the writes are planned on the host, and nothing is
    read back from the card. Paged, the chunk's factor rows ``[1, pos]``
    are written to ``pages_phi`` once, outside the layer loop, and
    ``max_pages`` caps the attention's page view (default: the pages of
    the longest ``offsets + chunk_lens``). The ALiBi slopes are cast once
    per call, not per layer.

    Under a mesh that splits the slots over ``batch``, the arguments are
    the whole slot batch's (host-planned, the same on every rank) and the
    call computes this rank's rows, returning their logits; a paged pool,
    replicated over those ranks, takes every slot's chunk rows (gathered
    over ``batch``)."""
    _check_supported(cfg)
    b, c = tokens.shape
    dev, dt = tokens.device, compute_dtype(cfg)
    offs, clens, flens = (_host_ids(x)
                          for x in (offsets, chunk_lens, final_lens))
    ring = cfg.window if "k" in cache and _is_ring(cfg, cache["k"][0]) else 0
    every_slot = axis_size("batch") > 1 and "pages_k" in cache
    if axis_size("batch") > 1:
        rows = local_range(b, "batch")
        tokens, b = tokens[rows], rows.stop - rows.start
        mine = offs[rows], clens[rows]
        flens = flens[rows]
        if not every_slot:
            offs, clens = mine
    chunk = _chunk_plan(cache, offs, clens, c, dev, ring=ring)
    if every_slot:                   # attention and SSM: this rank's rows
        offs, clens = mine
        chunk.update(all_rows=True, offsets=torch.as_tensor(offs, device=dev),
                     chunk_lens=torch.as_tensor(clens, device=dev))
    if cfg.family == "moe":         # MoE capacity ignores the padding
        chunk["valid"] = (torch.arange(c, device=dev)[None, :]
                          < chunk["chunk_lens"][:, None])
    slopes = paged = None
    if cfg.family in _ATTN and cfg.bias_kind == "alibi":
        slopes = local_part(params["layers"]["attn"]["slopes"].to(dt).float(),
                            1, "heads")                              # (L, H)
    if "pages_k" in cache:
        ps = cache["pages_k"].shape[3]
        if max_pages is None:
            max_pages = max(1, -(-int((offs + clens).max()) // ps))
        table = cache["page_table"]
        paged = {"table": table[local_range(table.shape[0], "batch")],
                 "max_pages": max_pages}
        phi = cache.get("pages_phi")
        if phi is not None and chunk["page"] is not None:
            page, off = chunk["page"], chunk["off"]
            phi[page, off] = torch.where(chunk["keep"][0], chunk["phi_row"],
                                         phi[page, off])
    x = _embed_in(params, tokens, None, cfg)
    for i in range(cfg.n_layers):
        x = _layer_chunk(_layer(params, i, dt), i, cache, x, cfg, chunk=chunk,
                         slopes=None if slopes is None else slopes[i],
                         paged=paged)
    last = torch.as_tensor(np.maximum(clens - 1, 0), device=dev)
    x = x[torch.arange(b, device=dev), last][:, None]
    final = torch.as_tensor(flens, dtype=torch.int32, device=dev)
    lengths = torch.where(final >= 0, final, cache["length"])
    return _logits(params, x, cfg), {**cache, "length": lengths}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda",
               length: int = 0) -> dict:
    """Zeroed cache: kernel-layout k/v ``(L, B, KVH, S, hd)`` with ``S =
    max_len``, or ``S = window`` (a ring) where the window is shorter; for
    the SSM and hybrid families the constant-size ``ssm_h (L, B, Hs, P,
    N)`` float32 state and the conv tails ``conv_x (L, B, W-1, Hs, P)`` and
    ``conv_bc (L, B, W-1, 2N)``. The head dim is stored unpadded."""
    _check_supported(cfg)
    cache = {"length": torch.full((batch,), length, dtype=torch.int32,
                                  device=device)}
    l, dt = cfg.n_layers, compute_dtype(cfg)
    if cfg.family in _ATTN:
        ring = bool(cfg.window) and cfg.window < max_len
        shape = (l, batch, cfg.kv_heads_padded,
                 cfg.window if ring else max_len, cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["v"] = torch.zeros(shape, dtype=dt, device=device)
    if cfg.family in _SSM:
        cache.update(_ssm_cache(cfg, batch, device))
    return cache


def _ssm_cache(cfg: ArchConfig, batch: int, device) -> dict:
    """Zeroed per-slot SSM leaves: ``ssm_h (L, B, Hs, P, N)`` float32 and
    the conv tails ``conv_x (L, B, W-1, Hs, P)`` and ``conv_bc (L, B, W-1,
    2N)`` in the compute dtype."""
    l, dt = cfg.n_layers, compute_dtype(cfg)
    hs, p, n = cfg.ssm_heads_padded, cfg.ssm_head_dim, cfg.ssm_state
    w = cfg.conv_width
    return {
        "ssm_h": torch.zeros((l, batch, hs, p, n), dtype=torch.float32,
                             device=device),
        "conv_x": torch.zeros((l, batch, w - 1, hs, p), dtype=dt,
                              device=device),
        "conv_bc": torch.zeros((l, batch, w - 1, 2 * n), dtype=dt,
                               device=device),
    }


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
    - hybrid: the per-slot SSM leaves ``ssm_h (L, B, Hs, P, N)`` float32,
      ``conv_x (L, B, W-1, Hs, P)`` and ``conv_bc (L, B, W-1, 2N)``, as in
      ``init_cache`` (constant-size, so not paged).

    The port stores ``hd`` and the slab's rank unpadded: the reference's
    128-lane pads are Pallas TPU tile constraints, and the Hopper kernel
    reads rows of any width."""
    _check_supported(cfg)
    if cfg.family not in _ATTN:
        raise ValueError(f"{cfg.family} caches are constant-size: no pages")
    shape = (cfg.n_layers, cfg.kv_heads_padded, n_pages, page_size,
             cfg.resolved_head_dim)
    dt = compute_dtype(cfg)
    cache = {
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
        "pages_k": torch.zeros(shape, dtype=dt, device=device),
        "pages_v": torch.zeros(shape, dtype=dt, device=device),
        "page_table": torch.zeros((batch, pages_per_slot or n_pages),
                                  dtype=torch.int32, device=device),
    }
    if cfg.bias_kind == "alibi":
        cache["pages_phi"] = torch.zeros((n_pages, page_size, 2),
                                         dtype=torch.float32, device=device)
    if cfg.family in _SSM:
        cache.update(_ssm_cache(cfg, batch, device))
    return cache


def _host_ids(x) -> np.ndarray:
    """Host-planned indices (slots, page tables, chunk offsets) as an int64
    array. A tensor on the card is refused rather than read back, which
    would stall the device on every call."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"host-planned indices must lie on the host, "
                             f"not {x.device}")
        x = x.numpy()
    return np.asarray(x, np.int64)


def insert_paged_cache_at_slots(dst: dict, src: dict, slots, tables,
                                slot_rows=None) -> dict:
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
    table, ``length`` and (hybrid) the SSM leaves land at ``slots``. Where
    ``length`` and the SSM leaves hold only some slots' rows (a mesh
    splitting the slots over ``batch``), ``slot_rows`` gives each wave
    row's row in them, out of range where another rank holds it."""
    slots, tables = _host_ids(slots), _host_ids(tables)
    slot_rows = slots if slot_rows is None else _host_ids(slot_rows)
    n_pages, ps = dst["pages_k"].shape[2], dst["pages_k"].shape[3]
    n_slots = dst["page_table"].shape[0]
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
        dst["page_table"][torch.as_tensor(slots[keep], device=dev)] = \
            torch.as_tensor(tables[keep], dtype=torch.int32, device=dev)
    keep = np.nonzero((slot_rows >= 0)
                      & (slot_rows < dst["length"].shape[0]))[0]
    if keep.size:
        k_t = torch.as_tensor(keep, device=dev)
        s_t = torch.as_tensor(slot_rows[keep], device=dev)
        dst["length"][s_t] = src["length"][k_t.to(src["length"].device)]
        for key in _SSM_LEAVES:
            if key in dst:
                dst[key][:, s_t] = src[key][:, k_t]
    return dst


def grow_page_tables_at_slots(dst: dict, slots, tables) -> dict:
    """Rewrite the page-table rows of slots that grew a page mid-flight, in
    place. Only the int32 table rows move: the pages already holding K/V
    and factor rows stay. ``tables`` (W, pages_per_slot) carries each
    growing slot's full new row; rows whose ``slots`` entry is out of range
    (``>= n_slots``) are skipped, on the host."""
    slots, tables = _host_ids(slots), _host_ids(tables)
    n_slots = dst["page_table"].shape[0]
    keep = np.nonzero((slots >= 0) & (slots < n_slots))[0]
    if keep.size:
        dev = dst["page_table"].device
        dst["page_table"][torch.as_tensor(slots[keep], device=dev)] = \
            torch.as_tensor(tables[keep], dtype=torch.int32, device=dev)
    return dst


def copy_paged_pages(dst: dict, src_ids, dst_ids) -> dict:
    """Copy whole pages ``src_ids[i] -> dst_ids[i]`` across every paged
    leaf (K, V and the ``pages_phi`` factor slab), in place: prefix
    caching's copy-on-write, run before a request writes into a page other
    holders share. ``src_ids`` / ``dst_ids`` are host arrays; entries whose
    dst lies outside the pool are dropped on the host, and every copy reads
    the pool as it was before the call, so one batch may reuse a page one
    of its own entries copies from."""
    src_ids, dst_ids = _host_ids(src_ids), _host_ids(dst_ids)
    n_pages = dst["pages_k"].shape[2]
    keep = (dst_ids >= 0) & (dst_ids < n_pages)
    if not keep.any():
        return dst
    dev = dst["pages_k"].device
    src = torch.as_tensor(np.clip(src_ids[keep], 0, n_pages - 1), device=dev)
    to = torch.as_tensor(dst_ids[keep], device=dev)
    for key in ("pages_k", "pages_v"):
        dst[key][:, :, to] = dst[key][:, :, src]
    if "pages_phi" in dst:
        dst["pages_phi"][to] = dst["pages_phi"][src]
    return dst

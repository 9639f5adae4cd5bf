"""Uniform Model interface consumed by the server (port of
``repro.models.api``: the dense, MoE, SSM and hybrid LM families, the
Pairformer, and the paper's vision (SwinV2) and PDE models).

``get_model(cfg)`` returns a ``Model`` with:

- ``template()``                           — PDef tree (shapes + init laws),
- ``loss(params, batch)``                  — the training loss (LM
  families: next-token cross-entropy of ``batch["tokens"]`` against
  ``batch["labels"]``, frontend rows in ``batch["frontend"]``; swin: mean
  cross-entropy of ``batch["patches"]`` against ``batch["labels"]``; pde:
  mean squared error of ``batch["coords"]`` against ``batch["targets"]``;
  pairformer: ``denoise_loss``, the mean squared error of the coordinates
  predicted from ``batch["feats"]`` against ``batch["coords"]``, without
  factor MLPs),
- ``prefill(params, batch, max_len, lengths)`` — prompts -> (logits, cache),
- ``decode(params, cache, tokens, max_pages)`` — one token -> (logits,
  cache), against a contiguous or a paged cache,
- ``init_cache(batch, max_len, device)``   — zeroed kernel-layout cache,
- ``insert_cache(dst, src, slots)``        — copy prefilled wave rows into
  serve slots (out-of-range slot ids are dropped),
- ``init_paged_cache(batch, n_pages, page_size, pages_per_slot, device)``
  — zeroed page pools, factor slab and page tables,
- ``insert_paged(dst, src, slots, tables)`` — scatter a prefilled wave's
  pages into the pool and its table rows into the slots,
- ``grow_page_table(dst, slots, tables)``  — rewrite the table rows of
  slots that grew a page,
- ``prefill_chunk(params, cache, tokens, offsets, chunk_lens, final_lens,
  max_pages)`` — one chunked-prefill step (cache updated in place),
- ``copy_pages(dst, src_ids, dst_ids)``     — copy whole pages (prefix
  caching's copy-on-write),
- ``input_specs(shape, device)``            — the inputs of one dry-run
  cell (``configs.SHAPES``) as zero tensors: the batch of a train or
  prefill cell, the cache (``init_cache`` at ``seq_len`` with every row
  one short of full) and the tokens of a decode cell. Call it under
  ``FakeTensorMode`` at full size: command-r's 32k cache is terabytes.

The paged entries belong to the families with attention (dense, MoE,
hybrid); the SSM family's ``Model`` leaves them None (constant-size
state). A hybrid
pages only where its window covers ``max_len`` (else its attention keeps a
ring and the backend does not page). ``copy_pages`` is the dense and MoE
families', the two whose slot state lives entirely in pages, so the only
ones that may share prefix pages. The Pairformer's ``Model`` leaves every
optional entry None, ``prefill_chunk`` too. The
Pairformer's ``prefill`` is the admission trunk pass (with the factor MLPs
as ``factors=``), its ``decode`` one refinement iteration over the slot
batch, and its ``init_cache`` takes ``factors=`` to size the factor cache.
The swin and pde models are not served: they have a template and a loss,
and their inference entry points are ``swin.forward`` and ``pde.forward``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import lm, pairformer, pde, swin

__all__ = ["Model", "get_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    template: Callable[[], dict]
    loss: Optional[Callable] = None
    prefill: Optional[Callable] = None
    decode: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    insert_cache: Optional[Callable] = None
    init_paged_cache: Optional[Callable] = None
    insert_paged: Optional[Callable] = None
    grow_page_table: Optional[Callable] = None
    prefill_chunk: Optional[Callable] = None
    copy_pages: Optional[Callable] = None
    input_specs: Optional[Callable] = None


def _lm_input_specs(cfg: ArchConfig, shape: ShapeSpec,
                    device="cuda") -> dict:
    """One LM cell's inputs (the reference's ``input_specs``): tokens and
    labels ``(B, S - F)`` with the frontend rows ``(B, F, D)`` in the
    compute dtype for train, tokens (and rows) for prefill, and for decode
    a cache of ``seq_len`` positions whose rows hold ``seq_len - 1`` with
    one token ``(B, 1)`` each."""
    b, s = shape.global_batch, shape.seq_len
    front = cfg.frontend_len
    tok = lambda n: torch.zeros((b, n), dtype=torch.long, device=device)
    specs: dict = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = tok(s - front)
        if shape.kind == "train":
            specs["labels"] = tok(s - front)
        if front:
            specs["frontend"] = torch.zeros(
                (b, front, cfg.d_model), dtype=getattr(torch, cfg.dtype),
                device=device)
    elif shape.kind == "decode":
        specs["cache"] = lm.init_cache(cfg, b, s, device=device,
                                       length=s - 1)
        specs["tokens"] = tok(1)
    else:
        raise ValueError(f"shape kind {shape.kind!r}")
    return specs


def _float_specs(**shapes):
    """``input_specs`` of a paper model: float32 zeros of ``shapes[name]
    (shape)`` (int64 for ``labels``)."""
    def specs(shape: ShapeSpec, device="cuda") -> dict:
        b, n = shape.global_batch, shape.seq_len
        return {k: torch.zeros(f(b, n), device=device,
                               dtype=torch.long if k == "labels"
                               else torch.float32)
                for k, f in shapes.items()}
    return specs


def _pairformer_model(cfg: ArchConfig) -> Model:
    return Model(
        cfg=cfg,
        template=lambda: pairformer.pairformer_template(cfg),
        loss=lambda p, batch: pairformer.denoise_loss(p, batch, cfg),
        prefill=lambda p, batch, max_len=None, lengths=None, factors=None:
            pairformer.serve_prefill(p, batch, cfg, factors,
                                     max_len=max_len, lengths=lengths),
        decode=lambda p, cache, tokens=None, max_pages=None:
            pairformer.serve_step(p, cache, cfg),
        init_cache=lambda b, max_len, device="cuda", length=0, factors=None:
            pairformer.init_serve_cache(cfg, b, max_len, factors,
                                        device=device),
        insert_cache=pairformer.insert_serve_cache_at_slots,
        input_specs=_float_specs(feats=lambda b, n: (b, n, 64),
                                 coords=lambda b, n: (b, n, 3)),
    )


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family == "pairformer":
        return _pairformer_model(cfg)
    if cfg.family == "swin":
        return Model(cfg=cfg, template=lambda: swin.swin_template(cfg),
                     loss=lambda p, batch: swin.classify_loss(p, batch, cfg),
                     input_specs=_float_specs(
                         patches=lambda b, n: (b, 4, cfg.window, 48),
                         labels=lambda b, n: (b,)))
    if cfg.family == "pde":
        return Model(cfg=cfg, template=lambda: pde.pde_template(cfg),
                     loss=lambda p, batch: pde.regression_loss(p, batch,
                                                               cfg),
                     input_specs=_float_specs(
                         coords=lambda b, n: (b, n, cfg.coord_dim),
                         targets=lambda b, n: (b, n, 4)))
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.family} family is not ported yet (ROADMAP.md Queue A "
            f"item 8)")
    paged = cfg.family in ("dense", "moe", "hybrid")
    shares_pages = cfg.family in ("dense", "moe")
    return Model(
        cfg=cfg,
        template=lambda: lm.lm_template(cfg),
        loss=lambda p, batch: lm.loss_fn(p, batch, cfg),
        prefill=lambda p, batch, max_len=None, lengths=None: lm.prefill(
            p, batch, cfg, max_len=max_len, lengths=lengths),
        decode=lambda p, cache, tokens, max_pages=None: lm.decode_step(
            p, cache, tokens, cfg, max_pages=max_pages),
        init_cache=lambda b, max_len, device="cuda", length=0: lm.init_cache(
            cfg, b, max_len, device=device, length=length),
        insert_cache=lm.insert_cache_at_slots,
        init_paged_cache=(functools.partial(lm.init_paged_cache, cfg)
                          if paged else None),
        insert_paged=lm.insert_paged_cache_at_slots if paged else None,
        grow_page_table=lm.grow_page_tables_at_slots if paged else None,
        prefill_chunk=lambda p, cache, tokens, offsets, chunk_lens,
        final_lens, max_pages=None: lm.prefill_chunk(
            p, cache, tokens, cfg, offsets=offsets, chunk_lens=chunk_lens,
            final_lens=final_lens, max_pages=max_pages),
        copy_pages=lm.copy_paged_pages if shares_pages else None,
        input_specs=functools.partial(_lm_input_specs, cfg),
    )

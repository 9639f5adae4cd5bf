"""Uniform Model interface consumed by the server (port of
``repro.models.api``: the dense and SSM LM families and the Pairformer).

``get_model(cfg)`` returns a ``Model`` with:

- ``template()``                           — PDef tree (shapes + init laws),
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
  slots that grew a page.

The three paged entries are the dense LM family's; the SSM family's
``Model`` (constant-size caches) and the Pairformer's leave them None. The
Pairformer's ``prefill`` is the admission trunk pass (with the factor MLPs
as ``factors=``), its ``decode`` one refinement iteration over the slot
batch, and its ``init_cache`` takes ``factors=`` to size the factor cache.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm, pairformer

__all__ = ["Model", "get_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    template: Callable[[], dict]
    prefill: Callable
    decode: Callable
    init_cache: Callable
    insert_cache: Callable
    init_paged_cache: Optional[Callable] = None
    insert_paged: Optional[Callable] = None
    grow_page_table: Optional[Callable] = None


def _pairformer_model(cfg: ArchConfig) -> Model:
    return Model(
        cfg=cfg,
        template=lambda: pairformer.pairformer_template(cfg),
        prefill=lambda p, batch, max_len=None, lengths=None, factors=None:
            pairformer.serve_prefill(p, batch, cfg, factors,
                                     max_len=max_len, lengths=lengths),
        decode=lambda p, cache, tokens=None, max_pages=None:
            pairformer.serve_step(p, cache, cfg),
        init_cache=lambda b, max_len, device="cuda", length=0, factors=None:
            pairformer.init_serve_cache(cfg, b, max_len, factors,
                                        device=device),
        insert_cache=pairformer.insert_serve_cache_at_slots,
    )


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family == "pairformer":
        return _pairformer_model(cfg)
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.family} family is not ported yet (ROADMAP.md Queue A "
            f"items 7-8)")
    paged = cfg.family == "dense"
    return Model(
        cfg=cfg,
        template=lambda: lm.lm_template(cfg),
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
    )

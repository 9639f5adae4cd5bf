"""Uniform Model interface consumed by the server (port of
``repro.models.api``, dense LM family).

``get_model(cfg)`` returns a ``Model`` with:

- ``template()``                           — PDef tree (shapes + init laws),
- ``prefill(params, batch, max_len, lengths)`` — prompts -> (logits, cache),
- ``decode(params, cache, tokens)``        — one token -> (logits, cache),
- ``init_cache(batch, max_len, device)``   — zeroed kernel-layout cache,
- ``insert_cache(dst, src, slots)``        — copy prefilled wave rows into
  serve slots (out-of-range slot ids are dropped).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm

__all__ = ["Model", "get_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    template: Callable[[], dict]
    prefill: Callable
    decode: Callable
    init_cache: Callable
    insert_cache: Callable


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.family} family is not ported yet (ROADMAP.md Queue A "
            f"items 7-8)")
    return Model(
        cfg=cfg,
        template=lambda: lm.lm_template(cfg),
        prefill=lambda p, batch, max_len=None, lengths=None: lm.prefill(
            p, batch, cfg, max_len=max_len, lengths=lengths),
        decode=lambda p, cache, tokens: lm.decode_step(p, cache, tokens, cfg),
        init_cache=lambda b, max_len, device="cuda", length=0: lm.init_cache(
            cfg, b, max_len, device=device, length=length),
        insert_cache=lm.insert_cache_at_slots,
    )

"""Serve backends: what a workload owns (device state, the admit/step
programs, per-slot state, retire and preemption snapshots) versus what the
engine core owns (requests, scheduling, slots, lifecycle).

Port of ``repro.serve.backend``: the ``Backend`` protocol with the
reference's defaults, and two backends.

``PairBatchBackend`` serves batched Pairformer inference (the paper's
Sec. 4.4 workload): a request is one complex, admission runs the trunk once
and caches its per-layer pair-bias factors (or the dense bias, for the A/B
baselines), and every step is one refinement iteration of single-rep
attention over the padded slot batch, masked per slot at its own ``n_res``.

``TokenDecodeBackend`` is the autoregressive LM path, in two KV modes:

- contiguous: each slot owns a ``max_len`` segment of a kernel-layout
  cache ``(L, n_slots, KVH, max_len, hd)``;
- paged (``page_size``): every slot draws pages from one shared pool
  (``serve/pages.py`` on the host, ``lm.init_paged_cache`` on the device).
  Admission reserves a prompt's pages (``"lazy"``, the default) or its
  whole footprint (``"whole"``); the engine grows a slot by a page as its
  length crosses a page boundary and preempts when the pool is dry. The
  ``max_len`` bound on prompt + budget does not apply: the page table and
  the pool bound a request instead.

The SSM family's cache is constant-size per slot: it accepts prompts of
any length, and ``page_size`` is a no-op for it (the backend does not
page), as in the reference.

Chunked prefill, prefix caching and mesh sharding wait for later slices.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import pairformer
from repro_torch.models.api import Model
from repro_torch.models.common import tree_map
from repro_torch.models.lm import cast_layers
from repro_torch.serve.lifecycle import AdmissionRejected, PoolError
from repro_torch.serve.pages import PagePool
from repro_torch.serve.sampling import sample_tokens, sample_tokens_guarded
from repro_torch.serve.scheduler import Request

__all__ = ["Backend", "TokenDecodeBackend", "PairBatchBackend"]


class Backend:
    """Protocol between the engine core and a workload backend.

    ``admit``/``step`` return ``(emissions, mask)``: ``mask[slot]`` marks
    slots that advanced one budget unit this call; ``emissions`` is a
    per-slot int array of emitted token ids, or None for backends that
    emit nothing incrementally (the engine then collects the result via
    ``fetch_result`` when the budget drains). Slot registration, budget
    accounting and retirement stay in the engine core."""

    paged: bool = False        # admission gated on page accounting
    lazy: bool = False         # pages grow mid-flight (may force preemption)
    guards: bool = True        # host-side non-finite guards

    def ensure_state(self) -> None:
        """Allocate device state on first use (idempotent)."""
        raise NotImplementedError

    def validate(self, req: Request) -> None:
        """Submit-time bounds check (raises on an inadmissible request)."""
        raise NotImplementedError

    def admit(self, wave: List[Request], slots: List[int]):
        """Prefill ``wave`` into ``slots``; returns (emissions, mask)."""
        raise NotImplementedError

    def step(self, live):
        """Advance every live slot one budget unit."""
        raise NotImplementedError

    def fetch_result(self, slot: int, st) -> Optional[np.ndarray]:
        """Final non-incremental result for a finishing slot (or None)."""
        return None

    def stream_result(self, slot: int, st) -> Optional[np.ndarray]:
        """Per-step streaming payload for non-emitting backends (the engine
        passes it to a request's ``on_token`` sink when ``emissions`` is
        None). Token backends stream the emitted id instead."""
        return None

    def release(self, slot: int) -> None:
        """Retire a finished slot: freeze its cache row, free resources."""
        raise NotImplementedError

    def snapshot(self, slot: int, st, emitted) -> Request:
        """Preempt: freeze + free the slot, return the resumable Request."""
        raise NotImplementedError

    def snapshot_request(self, slot: int, st, emitted) -> Request:
        """The resumable Request ``snapshot`` would return, without freezing
        or freeing anything."""
        raise NotImplementedError

    def take_guard_faults(self) -> Dict[int, str]:
        """Drain {slot: detail} for slots whose last admit/step tripped a
        non-finite guard. The engine drains after every backend call that
        can emit and quarantines the listed slots."""
        bad = getattr(self, "_guard_bad", None)
        if not bad:
            return {}
        self._guard_bad = {}
        return bad

    def admission_units(self, req: Request) -> int:
        """Resource units (pages) reserved when ``req`` is admitted."""
        return 0

    def units_free(self) -> int:
        return 0

    def growth_pending(self, live) -> List[int]:
        """Slots whose next step needs a resource grown first."""
        return []

    def grow_slots(self, growing: List[int]) -> None:
        raise NotImplementedError

    def page_cap(self, live) -> Optional[int]:
        """Static page bound for this step (None for unpaged backends)."""
        return None

    def page_stats(self) -> dict:
        """Pool accounting (empty for unpaged backends)."""
        return {}

    def stats(self) -> dict:
        return {}


class TokenDecodeBackend(Backend):
    """Autoregressive LM decode over a contiguous slot cache or a shared
    page pool (``page_size``; see the module docstring).

    Admission waves are right-padded to ``max(prefill_len, longest)``
    columns and batch-padded to ``n_slots`` rows (padding rows are dropped
    at insert), so one prefill shape serves every wave when
    ``prefill_len`` is pinned; one decode step advances the full slot batch.
    Per-slot sampling state lives on the host: temperature, top-k and the
    sampling stream ``(seed, count)``, whose count advances only for slots
    that commit a token.

    ``admit``/``step`` return ``(emissions, mask)``: ``mask[slot]`` marks
    slots that advanced one budget unit; ``emissions`` holds the emitted
    token ids per slot. Parameters are cast to the compute dtype once, here.
    """

    def __init__(self, model: Model, params: dict, max_len: int,
                 n_slots: int, prefill_len: Optional[int] = None,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 pages_per_slot: Optional[int] = None,
                 page_reservation: str = "lazy",
                 device="cuda"):
        if page_reservation not in ("lazy", "whole"):
            raise ValueError(f"page_reservation must be 'lazy' or "
                             f"'whole', got {page_reservation!r}")
        self.model = model
        self.device = torch.device(device)
        self.params = cast_layers(
            tree_map(lambda x: x.to(self.device), params), model.cfg)
        self.max_len, self.n_slots = max_len, n_slots
        self.prefill_len = prefill_len
        self._vocab = model.cfg.vocab
        self._guard_bad: Dict[int, str] = {}
        # full-KV caches must fit prompt + budget inside the slot segment
        # (contiguous) or the page pool (paged); SSM state is constant-size
        self._bounded_cache = model.cfg.family == "dense"
        self.paged = page_size is not None and self._bounded_cache
        self.lazy = self.paged and page_reservation == "lazy"
        if self.paged:
            self.page_size = page_size
            self.n_pages = n_pages or n_slots * (-(-max_len // page_size))
            self.pages_per_slot = min(pages_per_slot or self.n_pages,
                                      self.n_pages)
            self._pool = PagePool(self.n_pages, page_size)
            self._slot_pages: Dict[int, List[int]] = {}
        self._cache = None                        # allocated on first use
        self.n_waves = 0                          # prefill waves run
        self.n_steps = 0                          # decode steps run

    # -- lifecycle ------------------------------------------------------

    def ensure_state(self) -> None:
        if self._cache is not None:
            return
        ns = self.n_slots
        if self.paged:
            self._cache = self.model.init_paged_cache(
                ns, self.n_pages, self.page_size, self.pages_per_slot,
                device=self.device)
        else:
            self._cache = self.model.init_cache(ns, self.max_len,
                                                device=self.device)
        self._temps = np.zeros((ns,), np.float32)
        self._topks = np.zeros((ns,), np.int64)
        self._seeds = np.zeros((ns,), np.int64)
        self._counts = np.zeros((ns,), np.int64)
        self._last_tok = torch.zeros((ns, 1), dtype=torch.int64,
                                     device=self.device)

    def validate(self, req: Request) -> None:
        if not np.issubdtype(req.tokens.dtype, np.integer):
            raise AdmissionRejected("token backend takes int token prompts")
        if req.frontend is not None:
            raise AdmissionRejected("frontend embeddings are not ported yet")
        if (self.prefill_len is not None
                and req.tokens.size > self.prefill_len):
            raise AdmissionRejected(
                f"prompt of {req.tokens.size} tokens exceeds the pinned "
                f"prefill_len={self.prefill_len}")
        if self.paged:
            # the page-table row and the pool bound the request: a
            # footprint the pool can never cover would preempt everything
            # and still deadlock
            needed = self._pages_needed(req)
            cap = min(self.pages_per_slot, self.n_pages)
            if needed > cap:
                raise AdmissionRejected(
                    f"paged mode: request footprint {needed} pages "
                    f"(ceil((prompt {req.prompt_len} + budget "
                    f"{req.max_new_tokens} - 1) / page_size "
                    f"{self.page_size})) exceeds {cap} (page-table row "
                    f"width {self.pages_per_slot}, pool {self.n_pages} "
                    f"pages)")
        elif (self._bounded_cache
              and req.prompt_len + req.max_new_tokens > self.max_len):
            raise AdmissionRejected(
                f"contiguous mode: prompt {req.prompt_len} + budget "
                f"{req.max_new_tokens} exceeds the per-slot segment "
                f"max_len={self.max_len} (paged mode lifts this bound: "
                f"pass page_size)")

    # -- paged accounting -----------------------------------------------

    def _pages_needed(self, req: Request) -> int:
        """Pages a request can ever touch: its final cache length is
        ``prompt + budget - 1`` (the last sampled token is never fed
        back)."""
        return self._pool.pages_needed(req.prompt_len + req.max_new_tokens
                                       - 1)

    def admission_units(self, req: Request) -> int:
        """Pages reserved at admission: the prompt's under lazy growth, the
        whole footprint under ``"whole"``."""
        return (self._pool.pages_needed(req.prompt_len) if self.lazy
                else self._pages_needed(req))

    def units_free(self) -> int:
        """Pages admission and growth can draw on."""
        return self._pool.n_free

    def page_cap(self, live) -> Optional[int]:
        """Page bound for this decode step: the pages of the longest live
        length (+1 for the position being written), rounded up to a power
        of two, from the host mirror. None for unpaged engines."""
        if not self.paged:
            return None
        longest = max((st.length for st in live.values()), default=0)
        need = max(1, -(-(longest + 1) // self.page_size))
        cap = 1
        while cap < need:
            cap *= 2
        return min(cap, self.pages_per_slot)

    def growth_pending(self, live) -> List[int]:
        """Live slots whose next write position lies past their pages."""
        ps = self.page_size
        return [s for s, st in live.items()
                if st.length // ps >= len(self._slot_pages[s])]

    def grow_slots(self, growing: List[int]) -> None:
        """Give every growing slot its next page and write the new table
        rows. Atomic: every check and the allocation happen before any
        table changes, so a ``PoolExhausted`` leaves ``_slot_pages`` and
        the device tables as they were."""
        for slot in growing:
            if len(self._slot_pages[slot]) + 1 > self.pages_per_slot:
                raise PoolError(
                    f"slot {slot} page table full "
                    f"({self.pages_per_slot} rows) — admission validation "
                    f"should have rejected this footprint")
        grown = self._pool.grow(len(growing))   # all-or-nothing
        tables = np.full((len(growing), self.pages_per_slot), self.n_pages,
                         np.int64)
        for i, (slot, page) in enumerate(zip(growing, grown)):
            pages = self._slot_pages[slot]
            pages.append(page)
            tables[i, :len(pages)] = pages
        self._cache = self.model.grow_page_table(self._cache, growing,
                                                 tables)

    # -- admit / step ----------------------------------------------------

    def admit(self, wave: List[Request], slots: List[int]):
        """Prefill the wave into freed slots and sample each admitted
        request's first token from its prefill logits."""
        ns, w = self.n_slots, len(wave)
        padded = max(r.tokens.size for r in wave)
        if self.prefill_len is not None:
            padded = max(self.prefill_len, padded)
        toks = np.zeros((ns, padded), np.int64)
        lengths = np.ones((ns,), np.int32)
        for i, r in enumerate(wave):
            toks[i, :r.tokens.size] = r.tokens
            lengths[i] = r.prompt_len
        # paged: the wave cache holds the padded prompt, page-aligned, not
        # a max_len segment; its pages scatter into the pool
        pf_len = (-(-padded // self.page_size) * self.page_size
                  if self.paged else None)
        with torch.no_grad():
            logits, wave_cache = self.model.prefill(
                self.params, {"tokens": torch.as_tensor(toks,
                                                        device=self.device)},
                max_len=pf_len,
                lengths=torch.as_tensor(lengths, device=self.device))
            slot_ids = np.full((ns,), ns, np.int64)   # padding rows dropped
            slot_ids[:w] = slots
            if self.paged:
                tables = np.full((ns, self.pages_per_slot), self.n_pages,
                                 np.int64)
                for i, (slot, r) in enumerate(zip(slots, wave)):
                    pages = self._pool.alloc(self.admission_units(r))
                    self._slot_pages[slot] = pages
                    tables[i, :len(pages)] = pages
                self._cache = self.model.insert_paged(
                    self._cache, wave_cache, slot_ids, tables)
            else:
                self._cache = self.model.insert_cache(self._cache,
                                                      wave_cache, slot_ids)
            del wave_cache
            # first token: scatter wave-row logits into slot rows, sample
            lg = torch.zeros((ns, logits.shape[-1]), dtype=logits.dtype,
                             device=self.device)
            lg[torch.as_tensor(slots, device=self.device)] = logits[:w, 0]
        self.n_waves += 1
        # per-slot sampling state; a preempted request resumes its stream
        for slot, r in zip(slots, wave):
            self._temps[slot] = r.sampling.temperature
            self._topks[slot] = r.sampling.top_k
            if r.key_override is None:
                self._seeds[slot], self._counts[slot] = r.sampling.seed, 0
            else:
                self._seeds[slot], self._counts[slot] = r.key_override
        mask = np.zeros((ns,), bool)
        mask[slots] = True
        return self._sample(lg, mask), mask

    def step(self, live):
        """One decode step over the full slot batch."""
        with torch.no_grad():
            logits, self._cache = self.model.decode(
                self.params, self._cache, self._last_tok,
                max_pages=self.page_cap(live))
        self.n_steps += 1
        mask = np.zeros((self.n_slots,), bool)
        for s, st in live.items():
            st.length += 1
            mask[s] = True
        return self._sample(logits[:, 0], mask), mask

    def _sample(self, logits2d: torch.Tensor, mask: np.ndarray) -> np.ndarray:
        """Sample all slots; commit stream/token state for ``mask`` slots
        only. Guarded: an emitting slot whose raw logits are non-finite
        (NaN, +inf, or an all(-inf) row: the row max says which) has its
        commit withheld and is recorded for the engine to quarantine; its
        stream state stays aligned with its committed token count, so the
        retry resumes bit-identically."""
        args = (self._temps, self._topks, self._seeds, self._counts,
                self._vocab)
        commit = mask
        with torch.no_grad():
            if self.guards:
                toks, peak = sample_tokens_guarded(logits2d, *args)
                peak_h = peak.cpu().numpy()
                trip = ~np.isfinite(peak_h) & mask
                if trip.any():
                    commit = mask & ~trip
                    for s in np.nonzero(trip)[0]:
                        self._guard_bad[int(s)] = (
                            f"non-finite logits (row max {peak_h[s]!r}) at "
                            f"slot {int(s)} — emission withheld")
            else:
                toks = sample_tokens(logits2d, *args)
            toks_h = toks.cpu().numpy()
            self._counts[commit] += 1
            keep = torch.as_tensor(commit, device=self.device)[:, None]
            self._last_tok = torch.where(keep, toks[:, None], self._last_tok)
        return toks_h

    # -- retire / preempt ------------------------------------------------

    def release(self, slot: int) -> None:
        """Free a finished slot: zero its cache length so the decode step's
        active mask freezes the lane, and return its pages."""
        self._cache["length"][slot] = 0
        if self.paged:
            self._pool.free(self._slot_pages.pop(slot))

    def snapshot_request(self, slot: int, st, emitted) -> Request:
        """The resumable request, without freezing anything: generated-so-
        far folds into the prompt (the budget shrinks by as much) and the
        sampling stream state is kept in ``key_override``. Re-prefill of
        prompt + generated rebuilds the cache the preempted decode had."""
        req = st.req
        gen = emitted[-st.generated:] if st.generated else []
        return Request(
            req.rid, np.concatenate([req.tokens, np.asarray(gen, np.int32)]),
            req.max_new_tokens - st.generated, req.sampling, req.frontend,
            key_override=np.array([self._seeds[slot], self._counts[slot]],
                                  np.int64),
            priority=req.priority, on_token=req.on_token)

    def snapshot(self, slot: int, st, emitted) -> Request:
        """Preemption: the resume request, then freeze the slot."""
        resumed = self.snapshot_request(slot, st, emitted)
        self.release(slot)
        return resumed

    def page_stats(self) -> dict:
        """Pool accounting (empty for unpaged backends)."""
        if not self.paged:
            return {}
        return {"n_pages": self.n_pages, "n_free": self._pool.n_free,
                "watermark": self._pool.watermark,
                "grown": self._pool.n_grown}

    def stats(self) -> dict:
        return {"prefill_waves": self.n_waves, "decode_steps": self.n_steps,
                **self.page_stats()}



class PairBatchBackend(Backend):
    """Batched Pairformer inference (FlashBias Sec. 4.4).

    A request is ONE COMPLEX: its payload is a float ``(n_res, F)`` residue
    feature array, its budget ``max_new_tokens`` the number of refinement
    iterations, and its result the final single representation ``(n_res,
    d_model)``. Admission runs the full trunk once and caches each layer's
    pair-bias state per slot: factor-MLP ``phi_q``/``phi_k`` when
    ``factors`` is given (Eq. 5), truncated-SVD factors of the projected
    bias when not (Sec. 4.3), or the dense bias / the pair rep under
    ``cfg.bias_mode="dense"`` / ``"dense_recompute"`` (the A/B baselines).
    Steps then run attention + transition over the single rep only.

    Every wave pads to ``max_len`` residues and attention masks each slot
    at its own ``n_res`` (factor-MLP biases are nonzero at padded residues,
    so the mask is load-bearing). Preemption restarts a complex from
    scratch: nothing is emitted incrementally, so the snapshot carries no
    device state. Parameters are cast to the compute dtype once, here."""

    def __init__(self, model: Model, params: dict, max_len: int,
                 n_slots: int, factors: Optional[dict] = None,
                 device="cuda"):
        self.model = model
        self.device = torch.device(device)
        self.params = pairformer.cast_params(
            tree_map(lambda x: x.to(self.device), params), model.cfg)
        self.factors = (None if factors is None else
                        tree_map(lambda x: x.to(self.device), factors))
        self.max_len, self.n_slots = max_len, n_slots
        self._guard_bad: Dict[int, str] = {}
        self._cache = None                        # allocated on first use
        self.n_waves = 0                          # admission waves run
        self.n_steps = 0                          # refinement steps run

    def ensure_state(self) -> None:
        if self._cache is None:
            self._cache = self.model.init_cache(
                self.n_slots, self.max_len, device=self.device,
                factors=self.factors)

    def validate(self, req: Request) -> None:
        if req.tokens.dtype != np.float32 or req.tokens.ndim != 2:
            raise AdmissionRejected(
                "pair request payload must be a float (n_res, F) feature "
                "array")
        if req.tokens.shape[0] > self.max_len:
            raise AdmissionRejected(
                f"complex has {req.tokens.shape[0]} residues; slot batch "
                f"is padded to max_len={self.max_len}")
        if req.frontend is not None:
            raise AdmissionRejected("pair requests carry no frontend")

    def admit(self, wave: List[Request], slots: List[int]):
        """Trunk pass over the padded wave; copy the per-layer bias state
        into the slot cache. Emits nothing (mask all-False): the budget
        counts refinement STEPS, and admission is step 0."""
        ns, w = self.n_slots, len(wave)
        f = wave[0].tokens.shape[1]
        feats = np.zeros((ns, self.max_len, f), np.float32)
        lengths = np.zeros((ns,), np.int32)
        for i, r in enumerate(wave):
            feats[i, :r.tokens.shape[0]] = r.tokens
            lengths[i] = r.tokens.shape[0]
        with torch.no_grad():
            _, wave_cache = self.model.prefill(
                self.params, {"feats": torch.as_tensor(feats,
                                                       device=self.device)},
                max_len=self.max_len,
                lengths=torch.as_tensor(lengths, device=self.device),
                factors=self.factors)
            if self.guards:
                # the admission-time guard of the reference, checking the
                # same leaves: floating leaves whose LEADING axis is the
                # slot batch. A NaN/Inf in the frozen state poisons every
                # step of the request, so it is caught now, per wave row.
                flags = [torch.isfinite(leaf).flatten(1).all(dim=1)
                         for leaf in wave_cache.values()
                         if leaf.is_floating_point() and leaf.dim() >= 1
                         and leaf.shape[0] == ns]
                if flags:
                    ok = functools.reduce(torch.logical_and,
                                          flags).cpu().numpy()
                    for i in range(w):
                        if not ok[i]:
                            self._guard_bad[slots[i]] = (
                                f"non-finite factor cache at admission of "
                                f"slot {slots[i]} (trunk produced NaN/Inf "
                                f"from the complex features)")
            slot_ids = np.full((ns,), ns, np.int64)  # padding rows dropped
            slot_ids[:w] = slots
            self._cache = self.model.insert_cache(self._cache, wave_cache,
                                                  slot_ids)
        self.n_waves += 1
        return None, np.zeros((ns,), bool)

    def step(self, live):
        """One refinement iteration over every slot (retired slots are
        frozen by their zero length)."""
        with torch.no_grad():
            self._cache = self.model.decode(self.params, self._cache)
        self.n_steps += 1
        mask = np.zeros((self.n_slots,), bool)
        mask[list(live)] = True
        return None, mask

    def fetch_result(self, slot: int, st) -> np.ndarray:
        """A float32 host copy of the slot's single rep (a copy even on the
        CPU, where the cache is later written in place)."""
        n = st.req.tokens.shape[0]
        return self._cache["s"][slot, :n].to("cpu", torch.float32,
                                             copy=True).numpy()

    def stream_result(self, slot: int, st) -> np.ndarray:
        """Per-iteration single rep for streaming sinks: the pair backend
        emits no tokens, so ``on_token`` subscribers get the current
        ``(n_res, d_model)`` state after every refinement step."""
        return self.fetch_result(slot, st)

    def release(self, slot: int) -> None:
        self._cache["length"][slot] = 0

    def snapshot_request(self, slot: int, st, emitted) -> Request:
        """Preemption = restart: the resume request is the ORIGINAL with its
        full budget (no incremental output was emitted, so the re-run is
        deterministic by construction)."""
        req = st.req
        return Request(req.rid, req.tokens, req.max_new_tokens,
                       req.sampling, req.frontend, priority=req.priority,
                       on_token=req.on_token)

    def snapshot(self, slot: int, st, emitted) -> Request:
        resumed = self.snapshot_request(slot, st, emitted)
        self.release(slot)
        return resumed

    def stats(self) -> dict:
        return {"prefill_waves": self.n_waves, "decode_steps": self.n_steps}

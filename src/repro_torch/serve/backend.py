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

The SSM family's cache is constant-size per slot, and a sliding-window
model whose window is shorter than ``max_len`` keeps a ring of the last
``window`` keys (the hybrid family also carries the SSM state): both accept
prompts of any length, and ``page_size`` is a no-op for them (the backend
does not page), as in the reference. A ring model's prefill chunk is
clamped to the window, and it refuses ``prefix_cache``. A hybrid whose
window covers ``max_len`` pages its attention cache as the dense family
does, its SSM state riding per slot; it refuses ``prefix_cache`` too.

``prefill_chunk`` makes admission a planner: it reserves a prompt's pages,
arms its sampling state and queues a ``ChunkPlan``; the engine then runs
one ``prefill_step`` per engine step, one fixed-shape ``(n_slots, chunk)``
call that appends a chunk for every pending slot, between decode steps.
``prefix_cache`` (paged, chunked, dense or MoE family) indexes every landed
prompt's full pages by content (``serve/prefix.py``): a request whose
prompt starts with indexed pages shares them through its page table and
prefills only the rest, copying on write any shared page it must write.

A ``serve.faults.FaultPlan`` set as ``faults`` injects faults: ``alloc``
fails a lazy page growth before it touches the pool, ``nan`` overwrites a
slot's logits with NaN on the device before the guard and the sampler.

``mesh`` / ``rules`` (a torch ``DeviceMesh`` and ``dist.Rules``) shard the
token backend: the parameters and the persistent state are placed as
DTensors by their logical axes (``_state_axes``: K/V caches and pools on
``kv_heads``, slot rows on ``batch``, page tables and the factor slab
replicated), and every model call runs this rank's local shards under
``use_mesh_rules``, with the collectives ``dist.collectives`` writes. The
page allocator, the scheduler and the prefix index stay on the host and
run the same on every rank: each rank reads back the whole slot batch's
tokens and guard values, so all take the same decisions.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.dist.collectives import gather_from, local_range
from repro_torch.dist.sharding import (Rules, even_rules, shard_put,
                                       use_mesh_rules)
from repro_torch.models import pairformer
from repro_torch.models.api import Model
from repro_torch.models.common import (TP_AXES, PDef, shard_params,
                                       train_template, tree_leaves,
                                       tree_map)
from repro_torch.models.lm import cast_layers
from repro_torch.serve.lifecycle import (AdmissionRejected, PoolError,
                                         PoolExhausted)
from repro_torch.serve.pages import PagePool
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.sampling import sample_tokens, sample_tokens_guarded
from repro_torch.serve.scheduler import ChunkPlan, Request

__all__ = ["Backend", "TokenDecodeBackend", "PairBatchBackend",
           "serve_rules"]


def _serve_template(tmpl: dict) -> dict:
    """The template with the axes of the weights' serve layout: the
    training layout's (``train_template``: the SSM branch whole on every
    ``model`` rank) with only its tensor-parallel axes kept, every other
    one (``fsdp``, ``layers``) replicated."""
    return tree_map(lambda p: PDef(p.shape, tuple(
        a if a in TP_AXES else None for a in p.axes), p.init),
        train_template(tmpl))


def serve_rules(tmpl: dict, mesh, rules: Rules, n_slots: int) -> Rules:
    """``rules`` with every logical axis that some leaf of ``tmpl`` (or the
    ``n_slots`` slot batch, for ``batch``) cannot split evenly over its
    mesh axes replicated for all of them, and ``heads`` / ``kv_heads``
    replicated together (``dist.even_rules``)."""
    return even_rules(((p.shape, p.axes) for p in tree_leaves(tmpl)), mesh,
                      rules, batch=n_slots)


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
    faults = None              # serve.faults.FaultPlan injection hook

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

    def prefill_pending(self) -> bool:
        """True while admitted prompts still have chunks to land: the
        engine then runs one ``prefill_step`` in every engine step."""
        return False

    def prefill_step(self):
        """Append one chunk for every pending prompt; (emissions, mask) as
        ``step``, where only the slots whose final chunk landed emit."""
        raise NotImplementedError

    def pending_slots(self):
        """Slots mid-chunked-prefill: live (they hold pages and can be
        preempted) but not decoding yet."""
        return ()

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

    def quarantine(self, slot: int) -> None:
        """Called for a faulting slot before it is released: discard what
        other requests could read from it (the token backend invalidates
        the prefix-index entries of pages the slot wrote)."""

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

    Chunked (``prefill_chunk``): a slot mid-prompt holds device length 0,
    so decode steps freeze its lane; its final chunk sets the length to the
    prompt's and samples the first token, so sampling streams and decode
    match the whole-prompt path's.

    Sharded (``mesh``): ``params`` / ``_cache`` hold this rank's local
    shards, ``dparams`` / ``state_dtensors()`` the same storage as
    DTensors. The weights are placed in their serve layout
    (``_serve_template``): their tensor-parallel axes (heads, kv heads, FFN
    hidden, vocab, experts) split over the mesh, ``fsdp`` gathered once at
    load (ZeRO-3's per-step gather buys nothing in a decode loop) and the
    SSM branch whole on every ``model`` rank (its state is split on
    ``batch`` only, as in the reference's table). A tensor-parallel axis
    that some weight cannot split evenly is replicated for every weight
    (``serve_rules``), so the local head groups always match. Each rank
    decodes its own slots where ``batch`` splits ``n_slots``; a wave's
    prefill runs whole on every rank (each inserts its own slots), and a
    paged pool, replicated over ``batch``, takes every slot's writes.
    """

    def __init__(self, model: Model, params: dict, max_len: int,
                 n_slots: int, prefill_len: Optional[int] = None,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 pages_per_slot: Optional[int] = None,
                 page_reservation: str = "lazy",
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False,
                 mesh=None, rules: Optional[Rules] = None,
                 device="cuda"):
        if page_reservation not in ("lazy", "whole"):
            raise ValueError(f"page_reservation must be 'lazy' or "
                             f"'whole', got {page_reservation!r}")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, "
                                 f"got {prefill_chunk}")
            if model.prefill_chunk is None:
                raise ValueError(
                    f"{model.cfg.family} model has no chunked-prefill path")
        cfg = model.cfg
        # a ring cache keeps the last `window` keys: a chunk's positions
        # must land on distinct ring slots, so the chunk never exceeds it
        self.ring = bool(cfg.window) and cfg.window < max_len
        if prefill_chunk is not None and self.ring:
            prefill_chunk = min(prefill_chunk, cfg.window)
        self.chunk_size = prefill_chunk
        self._pending: Dict[int, ChunkPlan] = {}
        self._slot_kept: Dict[int, int] = {}   # shared (unwritten) pages
        self.model = model
        self.device = torch.device(device)
        self.max_len, self.n_slots = max_len, n_slots
        self.prefill_len = prefill_len
        self._vocab = model.cfg.vocab
        self._guard_bad: Dict[int, str] = {}
        # full-KV caches must fit prompt + budget inside the slot segment
        # (contiguous) or the page pool (paged); SSM state and ring caches
        # are constant-size
        self._bounded_cache = (cfg.family in ("dense", "moe", "hybrid")
                               and not self.ring)
        self.paged = (page_size is not None and self._bounded_cache
                      and model.init_paged_cache is not None)
        self.lazy = self.paged and page_reservation == "lazy"
        if self.paged:
            self.page_size = page_size
            self.n_pages = n_pages or n_slots * (-(-max_len // page_size))
            self.pages_per_slot = min(pages_per_slot or self.n_pages,
                                      self.n_pages)
            self._pool = PagePool(self.n_pages, page_size)
            self._slot_pages: Dict[int, List[int]] = {}
        # prefix caching shares pages through the page table, lands the
        # novel tail through a mid-prompt ChunkPlan, and needs slot state
        # that lives entirely in pages (no recurrent state)
        self._prefix: Optional[PrefixCache] = None
        if prefix_cache:
            if not (self.paged and self.chunk_size):
                raise ValueError(
                    "prefix_cache needs paged KV (page_size) + chunked "
                    "prefill (prefill_chunk): shared pages map through the "
                    "page table and novel tails land via mid-prompt "
                    "ChunkPlans")
            if cfg.family not in ("dense", "moe"):
                raise ValueError(
                    f"prefix_cache shares KV pages only: family "
                    f"'{model.cfg.family}' carries per-slot recurrent state "
                    f"a mid-prompt prefill start cannot rebuild")
            if model.copy_pages is None:
                raise ValueError(
                    "prefix_cache needs the model's copy_pages program")
            self._prefix = PrefixCache(page_size)
            self._n_cow = 0                # copy-on-write page copies
            self._tok_matched = 0          # prompt tokens served from cache
            self._tok_matchable = 0        # full-block prompt tokens admitted
        self.params = cast_layers(
            tree_map(lambda x: x.to(self.device), params), model.cfg)
        self.mesh = mesh
        self.rules = (rules or Rules()) if mesh is not None else rules
        self.dparams = None               # the DTensor view (mesh only)
        self._rows = slice(0, n_slots)    # the slot rows this rank holds
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a torch DeviceMesh, got "
                                f"{type(mesh).__name__}")
            tmpl = _serve_template(model.template())
            self._serve_rules = serve_rules(tmpl, mesh, self.rules, n_slots)
            self.dparams = shard_params(self.params, tmpl, mesh,
                                        self._serve_rules)
            self.params = tree_map(lambda t: t.to_local(), self.dparams)
            with self._sharded():
                self._rows = local_range(n_slots, "batch")
        self._cache = None                        # allocated on first use
        self.n_waves = 0                          # whole-prompt waves run
        self.n_chunk_steps = 0                    # prefill chunk steps run
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
        self._shard_state()

    def _state_axes(self) -> Dict[str, tuple]:
        """Logical axes of every persistent cache leaf, one per dim (the
        reference's table): K/V content on ``kv_heads`` and slot rows on
        ``batch``; the host-planned page table and the factor slab
        replicated, so the allocator never needs a collective to rewrite a
        row. SSM state is split on ``batch`` only. The legacy layout's
        entries are the reference's; the port keeps the kernel layout."""
        kernel = self.model.cfg.cache_layout == "kernel"
        axes: Dict[str, tuple] = {
            "length": ("batch",),
            "ssm_h": ("layers", "batch", None, None, None),
            "conv_x": ("layers", "batch", None, None, None),
            "conv_bc": ("layers", "batch", None, None),
        }
        if self.paged:
            pool = (("layers", "kv_heads", None, None, None) if kernel
                    else ("layers", None, None, "kv_heads", None))
            axes.update(pages_k=pool, pages_v=pool,
                        page_table=(None, None),
                        pages_phi=(None, None, None))
        else:
            kv = (("layers", "batch", "kv_heads", None, None) if kernel
                  else ("layers", "batch", None, "kv_heads", None))
            axes.update(k=kv, v=kv)
        return axes

    def _shard_state(self) -> None:
        """Place the persistent state by ``_state_axes`` (``shard_put``: an
        odd slot count replicates the ``batch`` rows) and keep its local
        shards; ``_last_tok`` rides on ``batch``. No-op without a mesh."""
        if self.mesh is None:
            return
        self._placements = {}
        axes = dict(self._state_axes(), last_tok=("batch", None))
        for key, a in axes.items():
            full = (self._last_tok if key == "last_tok"
                    else self._cache.get(key))
            if full is None:
                continue
            d = shard_put(full, self.mesh, self._serve_rules, a)
            self._placements[key] = d.placements
            if key == "last_tok":
                self._last_tok = d.to_local()
            else:
                self._cache[key] = d.to_local()

    def state_dtensors(self) -> Dict[str, object]:
        """The persistent state as DTensors over its local shards (no
        copy): what ``_shard_state`` placed, with the current ``length``."""
        from torch.distributed.tensor import DTensor
        live = dict(self._cache, last_tok=self._last_tok)
        return {k: DTensor.from_local(live[k], self.mesh, p, run_check=False)
                for k, p in self._placements.items()}

    def _sharded(self):
        """The ambient (mesh, serve rules) of a sharded backend's model
        calls; a null context without a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return use_mesh_rules(self.mesh, self._serve_rules)

    def _local_row(self, slot: int) -> int:
        """``slot``'s row in the batch-split state, or ``n_slots`` (out of
        range) where another rank holds it."""
        lo, hi = self._rows.start, self._rows.stop
        return slot - lo if lo <= slot < hi else self.n_slots

    def validate(self, req: Request) -> None:
        if not np.issubdtype(req.tokens.dtype, np.integer):
            raise AdmissionRejected("token backend takes int token prompts")
        if self.chunk_size and req.frontend is not None:
            raise AdmissionRejected(
                "chunked prefill takes token prompts only (frontend "
                "embeddings ride the whole-prompt wave path)")
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
                # shared pages still take page-table entries and pool
                # pages: a hit does not lift the bound, but the message
                # says what admission would reserve
                shared = ""
                if self._prefix is not None:
                    hit = len(self._prefix.match(req.tokens)[0])
                    shared = (f", of which {hit} currently shared via the "
                              f"prefix cache — admission would reserve "
                              f"{needed - hit} fresh pages but the table "
                              f"row still references all {needed}")
                raise AdmissionRejected(
                    f"paged mode: request footprint {needed} pages "
                    f"(ceil((prompt {req.prompt_len} + budget "
                    f"{req.max_new_tokens} - 1) / page_size "
                    f"{self.page_size})){shared} exceeds {cap} (page-table "
                    f"row width {self.pages_per_slot}, pool {self.n_pages} "
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
        whole footprint under ``"whole"``. With prefix caching, matched
        pages that a live request already holds (refcount >= 2) cost
        nothing; index-only matches (refcount 1) still count, as
        ``units_free`` counts them among the evictable pages."""
        units = (self._pool.pages_needed(req.prompt_len) if self.lazy
                 else self._pages_needed(req))
        if self._prefix is not None:
            kept = self._prefix_plan(req)[0]
            units -= sum(1 for p in kept if self._pool.refcount(p) >= 2)
        return units

    def units_free(self) -> int:
        """Pages admission and growth can draw on: the free list, plus the
        pages the prefix index alone holds (evictable on demand)."""
        free = self._pool.n_free
        if self._prefix is not None:
            free += self._prefix.n_evictable(self._pool)
        return free

    def _reclaim(self, n: int) -> None:
        """Put ``n`` pages on the free list, evicting index-held pages (LRU,
        leaf first) if it is short. Callers are gated on ``units_free``, so
        the eviction suffices."""
        if self._prefix is not None and self._pool.n_free < n:
            self._prefix.evict(self._pool, n - self._pool.n_free)

    def _prefix_plan(self, req: Request):
        """``req`` against the prefix index: ``(kept, cow_src, done,
        matched_tokens)``.

        ``kept`` pages are shared as they are. ``done``, where the ChunkPlan
        starts, is ``matched`` floored to a chunk multiple and kept below
        the prompt length: chunk boundaries then fall where the unshared
        engine's do, which makes the shared streams bit-equal, and a final
        chunk always runs to give the first token. Matched pages in the
        re-run span ``[done, matched)`` would be written by the sharer, so
        they come back as ``cow_src``, to be copied on write."""
        pages, matched = self._prefix.match(req.tokens)
        if not pages:
            return [], [], 0, 0
        done = (min(matched, req.prompt_len - 1)
                // self.chunk_size) * self.chunk_size
        k = len(pages) if done >= matched else done // self.page_size
        return pages[:k], pages[k:], done, matched

    def page_cap(self, live) -> Optional[int]:
        """Page bound for this decode step: the pages of the longest
        decoding length (+1 for the position being written), rounded up to
        a power of two, from the host mirror. None for unpaged engines."""
        if not self.paged:
            return None
        longest = max((st.length for s, st in live.items()
                       if s not in self._pending), default=0)
        need = max(1, -(-(longest + 1) // self.page_size))
        cap = 1
        while cap < need:
            cap *= 2
        return min(cap, self.pages_per_slot)

    def growth_pending(self, live) -> List[int]:
        """Decoding slots whose next write position lies past their pages
        (a slot mid-chunked-prefill holds its prompt's pages already)."""
        ps = self.page_size
        return [s for s, st in live.items()
                if s not in self._pending
                and st.length // ps >= len(self._slot_pages[s])]

    def grow_slots(self, growing: List[int]) -> None:
        """Give every growing slot its next page and write the new table
        rows. Atomic: every check and the allocation happen before any
        table changes, so a ``PoolExhausted`` (real, or a fault plan's
        ``alloc``) leaves ``_slot_pages`` and the device tables as they
        were."""
        if self.faults is not None and self.faults.alloc_fails():
            raise PoolExhausted("injected page-alloc failure (fault plan)")
        for slot in growing:
            if len(self._slot_pages[slot]) + 1 > self.pages_per_slot:
                raise PoolError(
                    f"slot {slot} page table full "
                    f"({self.pages_per_slot} rows) — admission validation "
                    f"should have rejected this footprint")
        self._reclaim(len(growing))
        grown = self._pool.grow(len(growing))   # all-or-nothing
        tables = np.full((len(growing), self.pages_per_slot), self.n_pages,
                         np.int64)
        for i, (slot, page) in enumerate(zip(growing, grown)):
            pages = self._slot_pages[slot]
            pages.append(page)
            tables[i, :len(pages)] = pages
        with self._sharded():
            self._cache = self.model.grow_page_table(self._cache, growing,
                                                     tables)

    # -- admit / step ----------------------------------------------------

    def admit(self, wave: List[Request], slots: List[int]):
        """Prefill the wave into freed slots and sample each admitted
        request's first token from its prefill logits. Chunked, plan the
        wave instead (``_plan_chunked``): nothing emits until a final
        chunk lands."""
        if self.chunk_size:
            return self._plan_chunked(wave, slots)
        ns, w = self.n_slots, len(wave)
        padded = max(r.tokens.size for r in wave)
        if self.prefill_len is not None:
            padded = max(self.prefill_len, padded)
        toks = np.zeros((ns, padded), np.int64)
        lengths = np.ones((ns,), np.int32)
        for i, r in enumerate(wave):
            toks[i, :r.tokens.size] = r.tokens
            lengths[i] = r.prompt_len
        batch = {"tokens": torch.as_tensor(toks, device=self.device)}
        # frontend rows (F, D) ride in front of the tokens, a float32
        # (n_slots, F, D) block; the reference asserts a wave never mixes
        # requests with and without them
        has_front = [r.frontend is not None for r in wave]
        front_len = 0
        if any(has_front):
            if not all(has_front):       # the reference's assertion
                raise AssertionError(
                    "wave mixes frontend/frontend-less requests")
            cfg = self.model.cfg
            front = np.zeros((ns, cfg.frontend_len, cfg.d_model), np.float32)
            for i, r in enumerate(wave):
                front[i] = r.frontend
            batch["frontend"] = torch.as_tensor(front, device=self.device)
            front_len = cfg.frontend_len
        # paged: the wave cache holds the padded prompt (frontend rows
        # included), page-aligned, not a max_len segment; its pages scatter
        # into the pool. A windowed model's prefill needs the slot length to
        # tell a ring cache from a full one
        pf_len = None
        if self.paged:
            pf_len = -(-(padded + front_len) // self.page_size) \
                * self.page_size
        elif self.model.cfg.window:
            pf_len = max(self.max_len, padded + front_len)
        with torch.no_grad(), self._sharded():
            logits, wave_cache = self.model.prefill(
                self.params, batch, max_len=pf_len,
                lengths=torch.as_tensor(lengths, device=self.device))
            slot_ids = np.full((ns,), ns, np.int64)   # padding rows dropped
            slot_ids[:w] = slots
            rows = np.array([self._local_row(int(s)) for s in slot_ids])
            if self.paged:
                tables = np.full((ns, self.pages_per_slot), self.n_pages,
                                 np.int64)
                for i, (slot, r) in enumerate(zip(slots, wave)):
                    pages = self._pool.alloc(self.admission_units(r))
                    self._slot_pages[slot] = pages
                    tables[i, :len(pages)] = pages
                self._cache = self.model.insert_paged(
                    self._cache, wave_cache, slot_ids, tables,
                    slot_rows=rows)
            else:
                self._cache = self.model.insert_cache(self._cache,
                                                      wave_cache, rows)
            del wave_cache
            # first token: scatter wave-row logits into slot rows, sample
            lg = torch.zeros((ns, logits.shape[-1]), dtype=logits.dtype,
                             device=self.device)
            lg[torch.as_tensor(slots, device=self.device)] = logits[:w, 0]
        self.n_waves += 1
        self._arm(wave, slots)
        mask = np.zeros((ns,), bool)
        mask[slots] = True
        return self._sample(lg, mask), mask

    def _arm(self, wave: List[Request], slots: List[int]) -> None:
        """Per-slot sampling state; a preempted request resumes its
        stream."""
        for slot, r in zip(slots, wave):
            self._temps[slot] = r.sampling.temperature
            self._topks[slot] = r.sampling.top_k
            if r.key_override is None:
                self._seeds[slot], self._counts[slot] = r.sampling.seed, 0
            else:
                self._seeds[slot], self._counts[slot] = r.key_override

    def _plan_chunked(self, wave: List[Request], slots: List[int]):
        """Chunked admission: reserve each request's pages (sharing its
        prefix-cache hits) and write its page-table row, copy on write the
        shared pages its re-run span will write, arm its sampling state
        (so a preemption mid-prompt snapshots a valid stream) and queue its
        ``ChunkPlan``. The chunk call writes the page content and factor
        rows itself. Emits nothing."""
        starts: Dict[int, int] = {}
        if self.paged:
            ps = self.page_size
            tables = np.full((len(wave), self.pages_per_slot), self.n_pages,
                             np.int64)
            cow: List[tuple] = []                 # (src, dst) page copies
            for i, (slot, r) in enumerate(zip(slots, wave)):
                kept, cow_src = [], []
                if self._prefix is not None:
                    kept, cow_src, starts[slot], matched = \
                        self._prefix_plan(r)
                    self._tok_matched += matched
                    self._tok_matchable += (r.prompt_len // ps) * ps
                    # pin the shared pages before an eviction this wave
                    # triggers can reach them
                    self._pool.incref(kept + cow_src)
                total = (self._pool.pages_needed(r.prompt_len) if self.lazy
                         else self._pages_needed(r))
                self._reclaim(total - len(kept))
                fresh = self._pool.alloc(total - len(kept))
                # the first len(cow_src) fresh pages become private copies
                # of the shared pages the span [done, matched) writes
                cow += list(zip(cow_src, fresh))
                pages = kept + fresh
                self._slot_pages[slot] = pages
                # pages after the kept prefix are written by this slot:
                # quarantine invalidates exactly those
                self._slot_kept[slot] = len(kept)
                tables[i, :len(pages)] = pages
            with self._sharded():
                self._cache = self.model.grow_page_table(self._cache, slots,
                                                         tables)
            if cow:
                # before any chunk or decode writes; the copies read the
                # pool as it was, so a page evicted and reused in this
                # wave cannot misorder them
                src, dst = (np.array(a, np.int64) for a in zip(*cow))
                with self._sharded():
                    self._cache = self.model.copy_pages(self._cache, src,
                                                        dst)
                self._n_cow += len(cow)
                # the sharer now owns private copies: drop the pins
                self._pool.free(src.tolist())
        self._arm(wave, slots)
        for slot, r in zip(slots, wave):
            # a prefix hit starts mid-prompt: positions [0, done) are in
            # the shared pages already
            self._pending[slot] = ChunkPlan(r, done=starts.get(slot, 0))
        return None, np.zeros((self.n_slots,), bool)

    def prefill_pending(self) -> bool:
        return bool(self._pending)

    def pending_slots(self):
        return self._pending.keys()

    def _chunk_page_cap(self) -> Optional[int]:
        """Page view of a paged chunk call: the page table's full width.
        The reference caps it at a power-of-two rounding of the longest
        pending prefix, which depends on which other prompts are mid-chunk
        in the same call; the attention's contractions would then run over
        views of other lengths in a shared and an unshared run, and may sum
        in another order. A fixed width keeps each row's arithmetic a
        function of its own inputs, which the prefix cache's bit-equal
        streams rest on."""
        return self.pages_per_slot if self.paged else None

    def prefill_step(self):
        """Append one chunk for every pending slot in one fixed-shape
        ``(n_slots, chunk)`` call. Mid-prompt chunks keep the device length
        at 0 (``final_lens`` -1), so decode steps freeze the lane; a final
        chunk sets the prompt length, and its logits sample the request's
        first token: the mask marks exactly the finalized slots, so every
        sampling stream stays aligned with its committed tokens."""
        ns, c = self.n_slots, self.chunk_size
        toks = np.zeros((ns, c), np.int64)
        offs = np.zeros((ns,), np.int64)
        clens = np.zeros((ns,), np.int64)
        flens = np.full((ns,), -1, np.int64)
        finalized: List[int] = []
        for slot, plan in self._pending.items():
            off, chunk_toks, final = plan.next_chunk(c)
            toks[slot, :chunk_toks.size] = chunk_toks
            offs[slot], clens[slot] = off, chunk_toks.size
            if final:
                flens[slot] = plan.req.prompt_len
                finalized.append(slot)
        with torch.no_grad(), self._sharded():
            logits, self._cache = self.model.prefill_chunk(
                self.params, self._cache,
                torch.as_tensor(toks, device=self.device), offs, clens,
                flens, max_pages=self._chunk_page_cap())
            logits = gather_from(logits[:, 0], 0, "batch")
        self.n_chunk_steps += 1
        for slot in finalized:
            plan = self._pending.pop(slot)
            if self._prefix is not None:
                # the prompt has landed: its full pages never change again
                # (decode writes at positions >= prompt_len, partial last
                # pages are never indexed)
                self._prefix.insert(plan.req.tokens, self._slot_pages[slot],
                                    self._pool)
        mask = np.zeros((ns,), bool)
        mask[finalized] = True
        return self._sample(logits, mask), mask

    def step(self, live):
        """One decode step over the full slot batch. Slots mid-chunked-
        prefill ride it frozen (device length 0) and stay out of the mask:
        committing their sampling state here would spend a draw the
        whole-prompt path never spends."""
        with torch.no_grad(), self._sharded():
            logits, self._cache = self.model.decode(
                self.params, self._cache, self._last_tok,
                max_pages=self.page_cap(live))
            logits = gather_from(logits[:, 0], 0, "batch")
        self.n_steps += 1
        mask = np.zeros((self.n_slots,), bool)
        for s, st in live.items():
            if s not in self._pending:
                st.length += 1
                mask[s] = True
        return self._sample(logits, mask), mask

    def _sample(self, logits2d: torch.Tensor, mask: np.ndarray) -> np.ndarray:
        """Sample all slots; commit stream/token state for ``mask`` slots
        only. Guarded: an emitting slot whose raw logits are non-finite
        (NaN, +inf, or an all(-inf) row: the row max says which) has its
        commit withheld and is recorded for the engine to quarantine; its
        stream state stays aligned with its committed token count, so the
        retry resumes bit-identically. A fault plan's ``nan`` slots have
        their logits overwritten with NaN on the device first, so a drill
        flows through the same guard as a real fault. ``logits2d`` holds
        every slot's row on every rank (a sharded backend gathers them
        first), so every rank samples, guards and commits alike."""
        if self.faults is not None:
            bad = self.faults.nan_slots()
            if bad:
                rows = (torch.arange(self.n_slots, device=self.device)
                        if -1 in bad else
                        torch.as_tensor(bad, device=self.device))
                logits2d = logits2d.index_fill(0, rows, float("nan"))
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
            keep = torch.as_tensor(commit[self._rows],
                                   device=self.device)[:, None]
            self._last_tok = torch.where(keep, toks[self._rows, None],
                                         self._last_tok)
        return toks_h

    # -- retire / preempt ------------------------------------------------

    def release(self, slot: int) -> None:
        """Free a finished slot: zero its cache length so the decode step's
        active mask freezes the lane, drop its chunk plan, and return its
        pages (a decref: pages the prefix index or a sharer also holds
        stay allocated)."""
        row = self._local_row(slot)
        if row < self._cache["length"].shape[0]:
            self._cache["length"][row] = 0
        self._pending.pop(slot, None)
        self._slot_kept.pop(slot, None)
        if self.paged:
            self._pool.free(self._slot_pages.pop(slot))

    def quarantine(self, slot: int) -> None:
        """Invalidate the prefix-index entries of every page this slot
        WROTE (all after the shared prefix kept at admission): its prompt
        pages were indexed when its prefill landed, so other requests could
        match content a faulting slot produced. Pages it only shared stay:
        copy-on-write means a sharer never writes them."""
        if self._prefix is None or slot not in self._slot_pages:
            return
        written = self._slot_pages[slot][self._slot_kept.get(slot, 0):]
        if written:
            self._prefix.invalidate(written, self._pool)

    def snapshot_request(self, slot: int, st, emitted) -> Request:
        """The resumable request, without freezing anything: generated-so-
        far folds into the prompt (the budget shrinks by as much) and the
        sampling stream state is kept in ``key_override``. Re-prefill of
        prompt + generated rebuilds the cache the preempted decode had. A
        slot caught mid-chunked-prefill has emitted nothing: its original
        request re-queues whole."""
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
        """Pool accounting (empty for unpaged backends), with the prefix
        index's under ``"prefix"`` when it is on."""
        if not self.paged:
            return {}
        out = {"n_pages": self.n_pages, "n_free": self._pool.n_free,
               "watermark": self._pool.watermark,
               "grown": self._pool.n_grown}
        if self._prefix is not None:
            matched, matchable = self._tok_matched, self._tok_matchable
            out["prefix"] = {
                "entries": len(self._prefix),
                "cached_pages": self._prefix.n_cached(self._pool),
                "tokens_matched": matched,
                "tokens_matchable": matchable,
                "hit_rate": matched / matchable if matchable else 0.0,
                "cow_copies": self._n_cow,
                "evictions": self._prefix.n_evicted,
                "collisions_rejected": self._prefix.n_rejected,
                "invalidated": self._prefix.n_invalidated,
            }
        return out

    def stats(self) -> dict:
        return {"prefill_waves": self.n_waves,
                "chunk_steps": self.n_chunk_steps,
                "decode_steps": self.n_steps, **self.page_stats()}



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

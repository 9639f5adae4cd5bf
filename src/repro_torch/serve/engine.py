"""Continuous-batching serve engine core (port of ``repro.serve.engine``).

The engine owns ``n_slots`` lanes and everything REQUEST-shaped: request
ids, the scheduler and admission waves, the slot free-list and live map,
result/done bookkeeping, budget accounting, the preemption victim policy
and the request lifecycle. Everything DEVICE-shaped — the caches, the
sampling state, the prefill/decode programs — lives in a backend, chosen
by the model's family:

- ``TokenDecodeBackend`` (the dense and SSM LM families): autoregressive
  decode over a contiguous or paged KV cache, or a constant-size SSM state
  (which accepts prompts longer than ``max_len`` and ignores
  ``page_size``); a request's result is its token ids;
- ``PairBatchBackend`` (``cfg.family == "pairformer"``): batched Pairformer
  inference, where a request is one complex, admission caches its
  per-layer pair-bias factors, every step is one refinement iteration, and
  the result is the final float ``(n_res, d_model)`` single rep.

A FIFO scheduler (with priority classes — higher admits first, preempts
last) fills freed slots; each admission wave is padded to ``n_slots`` and
prefilled in one call, and every engine step advances the full slot batch
in one decode step — per-request raggedness rides in the ``lengths``
vector.

Determinism contract: every per-slot computation is batch-row independent
and sampling streams are per-request, so a request's output is identical
whether it runs alone or packed with strangers — provided the padded
prompt length is pinned (``prefill_len``; the pair backend pins its
padding at ``max_len``) and the slot count is the same: across slot
counts the batch shapes differ and results agree at float tolerance.

Fault tolerance: every request carries a lifecycle record (``QUEUED ->
RUNNING -> OK / FAILED / TIMED_OUT / CANCELLED / REJECTED``); ``result``
returns a ``RequestRecord``. The host-side non-finite guard QUARANTINES a
faulting slot through the preemption-snapshot machinery: its emission is
withheld and the request retries bit-identically up to ``max_retries``
before terminating FAILED.

Paged KV (``page_size``): slots draw pages from one shared pool. Admission
waits while the pool cannot cover the head request's reservation (no
head-of-line bypass); before each decode step every slot whose length
crossed a page boundary grows by a page, and while the pool is dry the
lowest-priority live request (lowest class, then latest arrival) is
preempted — its snapshot re-enters at the head of the queue and resumes
bit-identically.

Chunked prefill (``prefill_chunk``): admission only plans, and every engine
step runs one chunk call for all admitted prompts, then one decode step, so
a long arrival costs the decoding requests one chunk per step instead of a
whole-prompt stall. Streams equal the whole-prompt engine's. Prefix caching
(``prefix_cache``, on top of paged + chunked): a prompt starting with pages
an earlier prompt completed shares them and prefills only the rest, with
streams bit-equal to the unshared chunked engine's; a quarantined slot's
written pages leave the index.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device, constructing the engine with no
``device`` raises.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.serve.backend import PairBatchBackend, TokenDecodeBackend
from repro_torch.serve.lifecycle import (
    CANCELLED, FAILED, OK, QUEUED, REJECTED, RUNNING, TERMINAL_STATUSES,
    TIMED_OUT, AdmissionRejected, EngineStalled, PoolExhausted,
    RequestNotLive, RequestRecord)
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import FIFOScheduler, Request

__all__ = ["ServeEngine", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    CUDA device — and an error when there is none (never a quiet CPU
    fallback)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU by "
                           "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def _deferred(arg: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{arg} is not ported yet (ROADMAP.md Queue A item {item})")


@dataclasses.dataclass
class _Slot:
    """Host-side state of one occupied lane. ``length`` mirrors the device
    cache length: the position the NEXT decode step writes."""
    req: Request
    generated: int = 0
    length: int = 0


@dataclasses.dataclass
class _ReqMeta:
    """Lifecycle record of one request (host bookkeeping)."""
    status: str = QUEUED
    error: Optional[dict] = None
    retries: int = 0                  # quarantine retries consumed
    max_retries: int = 1
    deadline: Optional[int] = None    # absolute engine step, None = never


class ServeEngine:
    """Slot-based continuous-batching engine (admit/step/commit core).

    Args:
        model: a serve-capable ``Model`` (prefill/decode/init_cache/
            insert_cache). ``cfg.family == "pairformer"`` gets the batched
            pair-inference backend, every other family the token backend.
        params: parameter tree (cast to the compute dtype and moved to
            ``device`` once, at construction).
        max_len: per-slot cache segment length. For the pair backend this
            is the pinned residue padding (the largest admissible n_res).
        eos_id: generation stops when this id is sampled (kept in the
            output). -1 never matches.
        n_slots: fixed batch — the number of concurrent requests.
        prefill_len: pinned padded prompt length. None pads each wave to
            its own longest prompt; pinning makes outputs independent of
            wave composition.
        scheduler_policy: ``"fifo"`` or ``"spf"`` (shortest prompt first).
        guards: host-side non-finite emission guards (default on).
        stall_limit: ``run()`` raises ``EngineStalled`` after this many
            consecutive steps with work outstanding but no progress.
        page_size / n_pages / pages_per_slot / page_reservation: paged
            KV, forwarded to the token backend: page size in tokens, pool
            size (default: ``n_slots`` max_len segments), page-table row
            width, and ``"lazy"`` (prompt pages at admission, growth on
            demand, preemption when the pool is dry) or ``"whole"`` (the
            full footprint at admission; decode never allocates). Ignored
            by the pair backend and by SSM models (``page_stats()`` is
            then empty).
        factors: fitted pair-bias factor MLP params (pair backend only;
            None serves truncated-SVD factors).
        device: where the engine runs; None means the CUDA device.
        prefill_chunk: chunked prefill (token backend): prompts land this
            many tokens per engine step, between decode steps. None keeps
            whole-prompt admission waves.
        prefix_cache: content-hashed prefix caching (needs ``page_size``,
            ``prefill_chunk`` and the dense family): completed prompt pages
            are shared by later prompts that start with them.
        mesh, faults: later slices of the port; passing either raises
            ``NotImplementedError``.
    """

    def __init__(self, model: Model, params: dict, max_len: int = 1024,
                 eos_id: int = -1, n_slots: int = 4,
                 prefill_len: Optional[int] = None,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 pages_per_slot: Optional[int] = None,
                 page_reservation: str = "lazy",
                 scheduler_policy: str = "fifo",
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False,
                 mesh=None,
                 guards: bool = True,
                 faults=None,
                 stall_limit: int = 64,
                 factors: Optional[dict] = None,
                 device=None):
        if faults is not None:
            raise _deferred("faults (fault injection)", 4)
        if mesh is not None:
            raise _deferred("mesh (sharded serving)", 10)
        if stall_limit < 1:
            raise ValueError(f"stall_limit must be >= 1, got {stall_limit}")
        if model.prefill is None:
            raise ValueError(f"the {model.cfg.family} family is not served: "
                             f"it has no prefill / decode entries")
        self.device = resolve_device(device)
        self.model = model
        self.max_len, self.eos_id = max_len, eos_id
        self.n_slots, self.prefill_len = n_slots, prefill_len
        if model.cfg.family == "pairformer":
            if prefill_chunk is not None or prefix_cache:
                raise ValueError("chunked prefill / prefix cache are "
                                 "token-backend paths")
            self.backend = PairBatchBackend(
                model, params, max_len=max_len, n_slots=n_slots,
                factors=factors, device=self.device)
        else:
            self.backend = TokenDecodeBackend(
                model, params, max_len=max_len, n_slots=n_slots,
                prefill_len=prefill_len, page_size=page_size,
                n_pages=n_pages, pages_per_slot=pages_per_slot,
                page_reservation=page_reservation,
                prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
                device=self.device)
        if self.backend.paged:
            self.page_size = self.backend.page_size
            self.n_pages = self.backend.n_pages
            self.pages_per_slot = self.backend.pages_per_slot
        self.guards = guards
        self.backend.guards = guards
        self.stall_limit = stall_limit
        self.step_idx = 0               # engine steps taken
        self.n_preemptions = 0
        self.n_quarantines = 0          # guard trips contained
        self.n_faults_contained = 0     # pool exhaustions at growth
        self.scheduler = FIFOScheduler(policy=scheduler_policy)
        self._next_rid = 0
        self._results: Dict[int, object] = {}   # rid -> [ids] | ndarray
        self._done: Dict[int, bool] = {}
        self._meta: Dict[int, _ReqMeta] = {}    # rid -> lifecycle record
        self._live: Dict[int, _Slot] = {}       # slot -> _Slot
        self._free: List[int] = list(range(n_slots))
        self._advanced = 0              # committed budget units (stall sig)

    # ------------------------------------------------------------------
    # Request lifecycle
    # ------------------------------------------------------------------

    def submit(self, tokens, max_new_tokens: int,
               sampling: Optional[SamplingParams] = None,
               priority: int = 0, on_token=None,
               deadline_steps: Optional[int] = None,
               max_retries: int = 1, strict: bool = True) -> int:
        """Queue one request; returns its request id.

        ``priority``: higher admits first and preempts last. ``on_token``
        is called once per budget unit the request advances, with the
        emitted token id (token backend) or the backend's per-step
        ``stream_result`` (pair backend: the current single rep); it rides
        the request, so it survives preemption. ``deadline_steps``: the
        request ends ``TIMED_OUT`` (keeping its partial result) if still
        incomplete after this many further engine steps. ``max_retries``:
        quarantine retries before a guard-tripping request ends ``FAILED``.
        ``strict=False`` turns a failed admission validation into a
        terminal ``REJECTED`` record instead of raising."""
        if deadline_steps is not None and deadline_steps < 1:
            raise ValueError(
                f"deadline_steps must be >= 1, got {deadline_steps}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        rid = self._next_rid
        self._next_rid += 1
        deadline = (None if deadline_steps is None
                    else self.step_idx + deadline_steps)
        self._results[rid] = []
        self._done[rid] = False
        self._meta[rid] = _ReqMeta(max_retries=max_retries,
                                   deadline=deadline)
        try:
            req = Request(rid, np.asarray(tokens), max_new_tokens,
                          sampling or SamplingParams(), None,
                          priority=priority, on_token=on_token)
            self.backend.validate(req)
        except AdmissionRejected as e:
            if strict:
                del self._results[rid], self._done[rid], self._meta[rid]
                raise
            self._finish(rid, REJECTED,
                         error={"kind": "admission", "detail": str(e)})
            return rid
        self.scheduler.add(req)
        return rid

    def result(self, rid: int) -> RequestRecord:
        """The ``(status, result, error)`` record for ``rid``: the generated
        int32 ids so far for the token backend, the final float ``(n_res,
        d_model)`` single rep for the pair backend (complete iff
        ``is_done``)."""
        if rid not in self._results:
            raise RequestNotLive(f"unknown request id {rid}")
        res = self._results[rid]
        meta = self._meta[rid]
        if not isinstance(res, np.ndarray):
            res = np.asarray(res, np.int32)
        return RequestRecord(res, status=meta.status, error=meta.error)

    def status(self, rid: int) -> str:
        if rid not in self._meta:
            raise RequestNotLive(f"unknown request id {rid}")
        return self._meta[rid].status

    def status_counts(self) -> Dict[str, int]:
        """{status: count} over every submitted request."""
        counts: Dict[str, int] = {}
        for meta in self._meta.values():
            counts[meta.status] = counts.get(meta.status, 0) + 1
        return counts

    def cancel(self, rid: int) -> bool:
        """Terminate ``rid`` as ``CANCELLED``, releasing its slot. Returns
        False if it already reached a terminal status. The partial result
        stays readable via ``result``."""
        meta = self._meta.get(rid)
        if meta is None:
            raise RequestNotLive(f"unknown request id {rid}")
        if meta.status in TERMINAL_STATUSES:
            return False
        if self.scheduler.remove(rid) is None:
            slots = [s for s, st in self._live.items()
                     if st.req.rid == rid]
            if not slots:
                raise RequestNotLive(
                    f"request {rid} is neither queued nor in flight")
            self._retire_slot(slots[0])
        self._finish(rid, CANCELLED)
        return True

    def is_done(self, rid: int) -> bool:
        if rid not in self._done:
            raise RequestNotLive(f"unknown request id {rid}")
        return self._done[rid]

    def _finish(self, rid: int, status: str,
                error: Optional[dict] = None) -> None:
        meta = self._meta[rid]
        meta.status = status
        if error is not None:
            meta.error = error
        self._done[rid] = True

    def _retire_slot(self, slot: int) -> None:
        """Pop a live slot and free its backend resources (no requeue)."""
        del self._live[slot]
        bisect.insort(self._free, slot)
        self.backend.release(slot)

    @property
    def occupancy(self) -> int:
        return len(self._live)

    def stats(self) -> dict:
        return {**self.backend.stats(), "preemptions": self.n_preemptions,
                "quarantines": self.n_quarantines}

    def page_stats(self) -> dict:
        """Pool accounting snapshot (empty for unpaged engines)."""
        stats = self.backend.page_stats()
        if stats:
            stats.update(preemptions=self.n_preemptions,
                         quarantines=self.n_quarantines,
                         faults_contained=self.n_faults_contained)
        return stats

    # ------------------------------------------------------------------
    # Engine steps
    # ------------------------------------------------------------------

    def step(self) -> List[int]:
        """Admit queued requests into free slots, land one chunk of every
        pending prompt (chunked prefill), then advance every decoding slot
        one token. Returns rids that reached a terminal status."""
        self.backend.ensure_state()
        finished = self._expire_deadlines()
        if self._free and len(self.scheduler):
            finished += self.admit()
        if self.backend.prefill_pending():
            emissions, mask = self.backend.prefill_step()
            finished += self._commit_guarded(emissions, mask)
        if self._live:
            finished += self.decode()
        self.step_idx += 1
        return finished

    def run(self) -> None:
        """Step until the queue and all slots drain; raise
        ``EngineStalled`` after ``stall_limit`` steps without progress."""
        self.backend.ensure_state()
        idle = 0
        while self._live or len(self.scheduler):
            before = self._progress_sig()
            self.step()
            if self._progress_sig() == before:
                idle += 1
                if idle >= self.stall_limit:
                    raise EngineStalled(
                        f"no progress for {idle} consecutive steps: "
                        f"{len(self.scheduler)} queued, "
                        f"{len(self._live)} live "
                        f"(slots {sorted(self._live)}), "
                        f"free slots {self._free}, "
                        f"page stats {self.page_stats() or None}, "
                        f"statuses {self.status_counts()}")
            else:
                idle = 0

    def _progress_sig(self) -> tuple:
        """What changes when the engine makes progress, a landed chunk
        included (a long prompt lands over many steps that emit nothing)."""
        pending = getattr(self.backend, "_pending", None) or {}
        return (len(self.scheduler), len(self._live), self._advanced,
                self.n_preemptions, self.n_quarantines,
                sum(self._done.values()),
                tuple(sorted((s, p.done) for s, p in pending.items())))

    def _expire_deadlines(self) -> List[int]:
        """Terminate every queued/live request whose deadline elapsed
        (TIMED_OUT, partial result retained)."""
        expired: List[int] = []
        for req in self.scheduler.queued():
            meta = self._meta[req.rid]
            if meta.deadline is not None and self.step_idx >= meta.deadline:
                self.scheduler.remove(req.rid)
                expired.append(req.rid)
        for slot in sorted(self._live):
            meta = self._meta[self._live[slot].req.rid]
            if meta.deadline is not None and self.step_idx >= meta.deadline:
                expired.append(self._live[slot].req.rid)
                self._retire_slot(slot)
        for rid in expired:
            self._finish(rid, TIMED_OUT, error={
                "kind": "deadline", "step": self.step_idx,
                "detail": f"deadline (step {self._meta[rid].deadline}) "
                          f"elapsed before completion"})
        return expired

    def _take_wave(self) -> List[Request]:
        """Pop the next admission wave: one request per free slot, gated in
        paged mode on the pool — admit while the head request's reservation
        fits, with no head-of-line bypass. A resumed request whose prompt
        outgrew a pinned ``prefill_len`` rides a SOLO wave, so co-admitted
        requests keep their pinned padded length."""
        wave: List[Request] = []
        reserved = 0
        while len(wave) < len(self._free):
            r = self.scheduler.peek()
            if r is None:
                break
            over = (self.prefill_len is not None
                    and r.tokens.size > self.prefill_len)
            if over and wave:
                break                    # over-length request: next wave
            if self.backend.paged:
                needed = self.backend.admission_units(r)
                if needed > self.backend.units_free() - reserved:
                    break                # backpressure: wait for frees
                reserved += needed
            wave.append(self.scheduler.take(1)[0])
            if over:
                break                    # solo wave for the resumed prompt
        return wave

    def admit(self) -> List[int]:
        """Prefill the next admission wave into freed slots; each admitted
        request samples its first token from its prefill logits."""
        self.backend.ensure_state()
        wave = self._take_wave()
        if not wave:
            return []
        slots = [self._free.pop(0) for _ in wave]
        emissions, mask = self.backend.admit(wave, slots)
        for slot, r in zip(slots, wave):
            self._live[slot] = _Slot(r, length=r.prompt_len)
            self._meta[r.rid].status = RUNNING
        return self._commit_guarded(emissions, mask)

    def decode(self) -> List[int]:
        """Advance every live slot one token in one backend step. Lazy paged
        mode first grows every slot whose write position crossed a page
        boundary, preempting the lowest-priority live request while the
        pool is dry, so the step itself never allocates. Skipped while
        every live slot is still mid-chunked-prefill."""
        self.backend.ensure_state()
        pending = self.backend.pending_slots()
        if pending and all(s in pending for s in self._live):
            return []               # nothing decoding yet: chunks only
        if self.backend.lazy:
            # (priority, arrival) is a total order, so the highest-priority
            # earliest request always progresses: no preemption livelock
            growing = self.backend.growth_pending(self._live)
            while growing and self.backend.units_free() < len(growing):
                victim = self._victim_slot()
                self._preempt_slot(victim)
                growing = [s for s in growing if s != victim]
            if growing:
                try:
                    self.backend.grow_slots(growing)
                except PoolExhausted:
                    # reached only through an accounting bug: growth is
                    # atomic, so preempting the growing slots is safe
                    self.n_faults_contained += 1
                    for slot in growing:
                        if slot in self._live:
                            self._preempt_slot(slot)
        if not self._live:
            return []
        emissions, mask = self.backend.step(self._live)
        return self._commit_guarded(emissions, mask)

    def generate(self, prompts, max_new_tokens: int,
                 sampling: Optional[SamplingParams] = None) -> np.ndarray:
        """Batch convenience wrapper: prompts is a (B, T) array or a list of
        1-D ragged prompts. Returns (B, max_new_tokens) generated ids; rows
        that stop early at ``eos_id`` pad with ``eos_id``. Token backends
        only: pair requests go through ``submit``/``result``."""
        if not isinstance(self.backend, TokenDecodeBackend):
            raise TypeError(
                "generate() is a token-emitting API; submit()/result() "
                "serve pair requests")
        rows = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        rids = [self.submit(row, max_new_tokens, sampling=sampling)
                for row in rows]
        self.run()
        out = np.full((len(rows), max_new_tokens), self.eos_id, np.int32)
        for i, rid in enumerate(rids):
            got = self.result(rid)
            out[i, :got.size] = got
        return out

    # ------------------------------------------------------------------
    # Preemption
    # ------------------------------------------------------------------

    def _victim_slot(self) -> int:
        """Lowest priority class first, then latest arrival."""
        return min(self._live,
                   key=lambda s: (self._live[s].req.priority,
                                  -self._live[s].req.rid))

    def preempt(self, rid: Optional[int] = None) -> Optional[int]:
        """Preempt one in-flight request and re-queue it at the head.

        Default victim is the lowest-priority live request (lowest class,
        latest arrival). Returns the preempted rid, or None when nothing is
        live. The resumed request re-prefills prompt + generated and
        continues its sampling stream, so its output is bit-identical to
        the never-preempted run."""
        self.backend.ensure_state()
        if not self._live:
            return None
        if rid is None:
            slot = self._victim_slot()
        else:
            matches = [s for s, st in self._live.items()
                       if st.req.rid == rid]
            if not matches:
                raise RequestNotLive(f"request {rid} is not in flight")
            slot = matches[0]
        return self._preempt_slot(slot)

    def _preempt_slot(self, slot: int) -> int:
        """Snapshot + free + re-queue one slot."""
        st = self._live.pop(slot)
        bisect.insort(self._free, slot)
        resumed = self.backend.snapshot(slot, st, self._results[st.req.rid])
        self.scheduler.add_front(resumed)
        self._meta[st.req.rid].status = QUEUED
        self.n_preemptions += 1
        return st.req.rid

    # ------------------------------------------------------------------
    # Fault containment
    # ------------------------------------------------------------------

    def _quarantine(self, slot: int, detail: str) -> List[int]:
        """Contain a guard trip on ``slot``: drop what other requests could
        read from it (its written prefix pages), then RETRY through the
        preemption snapshot (bit-identical resume), or, when
        ``max_retries`` is spent, terminate the request FAILED with a
        structured error."""
        st = self._live[slot]
        rid = st.req.rid
        meta = self._meta[rid]
        self.backend.quarantine(slot)
        self.n_quarantines += 1
        if meta.retries < meta.max_retries:
            meta.retries += 1
            self._preempt_slot(slot)
            return []
        error = {"kind": "guard", "slot": slot, "step": self.step_idx,
                 "retries": meta.retries, "detail": detail}
        self._retire_slot(slot)
        self._finish(rid, FAILED, error)
        return [rid]

    def _commit_guarded(self, emissions: Optional[np.ndarray],
                        mask: np.ndarray) -> List[int]:
        """Drain the backend's guard verdicts BEFORE committing: a slot that
        tripped the guard has its emission withheld and is quarantined."""
        finished: List[int] = []
        if self.guards:
            for slot, detail in sorted(
                    self.backend.take_guard_faults().items()):
                if slot in self._live:
                    mask[slot] = False
                    finished += self._quarantine(slot, detail)
        return finished + self._commit(emissions, mask)

    # ------------------------------------------------------------------
    # Checkpoint (later slice)
    # ------------------------------------------------------------------

    def snapshot_engine(self) -> dict:
        raise _deferred("snapshot_engine (crash-safe checkpoint)", 5)

    def restore_engine(self, state: dict) -> None:
        raise _deferred("restore_engine (crash-safe checkpoint)", 5)

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------

    def _commit(self, emissions: Optional[np.ndarray],
                mask: np.ndarray) -> List[int]:
        """Record this step's emissions and retire finished requests.

        ``mask`` marks slots that advanced one budget unit; ``emissions``
        is per-slot token ids (token backend) or None (pair backend:
        nothing is emitted incrementally; the result is fetched from the
        backend when the budget drains)."""
        finished = []
        for slot in [s for s in self._live if mask[s]]:
            st = self._live[slot]
            t = None if emissions is None else int(emissions[slot])
            if t is not None:
                self._results[st.req.rid].append(t)
            st.generated += 1
            self._advanced += 1
            if st.req.on_token is not None:
                st.req.on_token(t if t is not None
                                else self.backend.stream_result(slot, st))
            if ((t is not None and t == self.eos_id)
                    or st.generated >= st.req.max_new_tokens):
                res = self.backend.fetch_result(slot, st)
                if res is not None:
                    self._results[st.req.rid] = res
                self._finish(st.req.rid, OK)
                finished.append(st.req.rid)
                del self._live[slot]
                bisect.insort(self._free, slot)
                self.backend.release(slot)
        return finished

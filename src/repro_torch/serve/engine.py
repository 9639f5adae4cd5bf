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

Fault injection (``faults``, a ``serve.faults.FaultPlan``): the engine
ticks the plan once per step; a ``delay`` skips admission, a ``step`` fault
replaces the decode dispatch with an ``InjectedFault`` that the engine
contains (nothing advanced, so the next step retries), an ``alloc`` fault
fails a lazy page growth (the growing slots are preempted and resume
bit-identically), and a ``nan`` fault poisons a slot's logits on the device
so the real guard quarantines it. ``snapshot_engine`` serializes the whole
host state to a JSON-compatible dict and ``restore_engine`` resumes it on a
fresh engine of the same config, bit-identically, by re-prefill (no device
state is captured).

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
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.lifecycle import (
    CANCELLED, FAILED, OK, QUEUED, REJECTED, RUNNING, TERMINAL_STATUSES,
    TIMED_OUT, AdmissionRejected, EngineStalled, InjectedFault,
    PoolExhausted, RequestNotLive, RequestRecord)
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import FIFOScheduler, Request

__all__ = ["ServeEngine", "resolve_device", "SNAPSHOT_FORMAT"]

# The snapshot's own format: its sampling-stream state is the port's
# (seed, count) pair, not the reference's threefry key, so a snapshot of
# one package cannot resume in the other
SNAPSHOT_FORMAT = "repro_torch.serve"
_SNAPSHOT_VERSION = 1


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


def _ser_arr(x) -> dict:
    """JSON-compatible encoding of a payload: a token-id list (mid-flight
    results) or an ndarray (prompts, stream keys, pair results)."""
    if isinstance(x, np.ndarray):
        return {"kind": "array", "dtype": str(x.dtype),
                "shape": list(x.shape), "data": x.ravel().tolist()}
    return {"kind": "ids", "data": [int(t) for t in x]}


def _de_arr(d: dict):
    if d["kind"] == "array":
        return np.asarray(d["data"], dtype=np.dtype(d["dtype"])).reshape(
            d["shape"])
    return list(d["data"])


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
            ``prefill_chunk`` and the dense or MoE family): completed
            prompt pages are shared by later prompts that start with them.
        faults: a ``serve.faults.FaultPlan`` for deterministic fault
            injection (drills); None injects nothing.
        mesh / rules: a torch ``DeviceMesh`` with ``data`` / ``model``
            axes and the logical-axis ``dist.Rules`` (default ``Rules()``):
            the token backend places its weights and state on the mesh and
            runs each rank's shards (``serve/backend.py``). Every rank runs
            this engine with the same requests and takes the same host
            decisions. The pair backend refuses a mesh, as the
            reference's does.
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
                 mesh=None, rules=None,
                 guards: bool = True,
                 faults: Optional[FaultPlan] = None,
                 stall_limit: int = 64,
                 factors: Optional[dict] = None,
                 device=None):
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
            if prefill_chunk is not None or mesh is not None or prefix_cache:
                raise ValueError(
                    "chunked prefill / prefix cache / mesh sharding are "
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
                mesh=mesh, rules=rules, device=self.device)
        if self.backend.paged:
            self.page_size = self.backend.page_size
            self.n_pages = self.backend.n_pages
            self.pages_per_slot = self.backend.pages_per_slot
        self.guards = guards
        self.backend.guards = guards
        self.faults = faults
        self.backend.faults = faults
        self.stall_limit = stall_limit
        self.step_idx = 0               # engine steps taken (fault clock)
        self.n_preemptions = 0
        self.n_quarantines = 0          # guard trips contained
        self.n_faults_contained = 0     # step / alloc faults contained
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
               frontend: Optional[np.ndarray] = None,
               priority: int = 0, on_token=None,
               deadline_steps: Optional[int] = None,
               max_retries: int = 1, strict: bool = True) -> int:
        """Queue one request; returns its request id.

        ``frontend`` (F, D) float: precomputed frontend embeddings (the
        audio / vision configs' ``frontend_len`` rows) that open the
        prompt; the prompt's length counts them. ``priority``: higher admits first and preempts last. ``on_token``
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
                          sampling or SamplingParams(), frontend,
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
        if self.faults is not None:
            self.faults.tick(self.step_idx)
        finished = self._expire_deadlines()
        delayed = (self.faults is not None
                   and self.faults.admission_delayed())
        if self._free and len(self.scheduler) and not delayed:
            finished += self.admit()
        if self.backend.prefill_pending():
            emissions, mask = self.backend.prefill_step()
            finished += self._commit_guarded(emissions, mask)
        if self._live:
            try:
                finished += self.decode()
            except InjectedFault:
                # the failed step dispatched nothing and advanced no state:
                # containment is retrying next step
                self.n_faults_contained += 1
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
        every live slot is still mid-chunked-prefill.

        A fault plan's ``step`` fault raises ``InjectedFault`` before
        anything is dispatched; a ``PoolExhausted`` out of growth
        (injected, or an accounting bug) preempts the growing slots, whose
        snapshots resume bit-identically."""
        self.backend.ensure_state()
        pending = self.backend.pending_slots()
        if pending and all(s in pending for s in self._live):
            return []               # nothing decoding yet: chunks only
        if self.faults is not None and self.faults.step_fails():
            raise InjectedFault("injected decode-step failure (fault plan)")
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
                    # growth is atomic (no partial table state), so
                    # preempting the growing slots is safe
                    self.n_faults_contained += 1
                    for slot in growing:
                        if slot in self._live:
                            self._preempt_slot(slot)
        if not self._live:
            return []
        emissions, mask = self.backend.step(self._live)
        return self._commit_guarded(emissions, mask)

    def generate(self, prompts, max_new_tokens: int, frontend=None,
                 sampling: Optional[SamplingParams] = None) -> np.ndarray:
        """Batch convenience wrapper: prompts is a (B, T) array or a list of
        1-D ragged prompts (``frontend``, where given, one (F, D) block per
        prompt). Returns (B, max_new_tokens) generated ids; rows that stop
        early at ``eos_id`` pad with ``eos_id``. Token backends only: pair
        requests go through ``submit``/``result``."""
        if not isinstance(self.backend, TokenDecodeBackend):
            raise TypeError(
                "generate() is a token-emitting API; submit()/result() "
                "serve pair requests")
        rows = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        rids = [self.submit(row, max_new_tokens, sampling=sampling,
                            frontend=None if frontend is None
                            else np.asarray(frontend[i]))
                for i, row in enumerate(rows)]
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
    # Crash-safe checkpoint / restore
    # ------------------------------------------------------------------

    def _ser_req(self, req: Request) -> dict:
        """Serialize one request descriptor. ``on_token`` callbacks are host
        closures that cannot cross a process boundary: they are dropped."""
        return {
            "rid": req.rid,
            "tokens": _ser_arr(np.asarray(req.tokens)),
            "max_new_tokens": req.max_new_tokens,
            "sampling": {"temperature": req.sampling.temperature,
                         "top_k": req.sampling.top_k,
                         "seed": req.sampling.seed},
            "frontend": (None if req.frontend is None
                         else _ser_arr(np.asarray(req.frontend))),
            "key_override": (None if req.key_override is None
                             else _ser_arr(np.asarray(req.key_override))),
            "priority": req.priority,
        }

    def _de_req(self, d: dict) -> Request:
        return Request(
            d["rid"], _de_arr(d["tokens"]), d["max_new_tokens"],
            SamplingParams(d["sampling"]["temperature"],
                           d["sampling"]["top_k"], d["sampling"]["seed"]),
            None if d["frontend"] is None else _de_arr(d["frontend"]),
            key_override=(None if d["key_override"] is None
                          else np.asarray(_de_arr(d["key_override"]),
                                          np.int64)),
            priority=d["priority"])

    def _config_sig(self) -> dict:
        """The config facts a restore target must agree on."""
        backend = self.backend
        return {"family": self.model.cfg.family, "arch": self.model.cfg.name,
                "n_slots": self.n_slots, "max_len": self.max_len,
                "prefill_len": self.prefill_len,
                "paged": backend.paged, "lazy": backend.lazy,
                "page_size": getattr(backend, "page_size", None),
                "n_pages": getattr(backend, "n_pages", None),
                "chunk_size": getattr(backend, "chunk_size", None),
                "prefix_cache": getattr(backend, "_prefix", None)
                is not None}

    def snapshot_engine(self) -> dict:
        """Serialize all host state to a JSON-compatible dict, without
        perturbing the running engine: lifecycle records, results so far,
        the scheduler's queues, and every live slot as its preemption
        resume request (generated tokens folded into the prompt, the
        sampling stream's ``(seed, count)`` in ``key_override``; a slot
        mid-``ChunkPlan`` serializes as its whole original request, having
        emitted nothing).

        Device state is not captured: caches, pages and the prefix index
        are rebuilt by re-prefill on the restored engine, which the
        preemption contract makes bit-identical. The prefix index's chain
        digests ride along for audit only."""
        front, arrivals = self.scheduler.snapshot()
        live = [self._ser_req(self.backend.snapshot_request(
                    slot, st, self._results[st.req.rid]))
                for slot, st in sorted(self._live.items())]
        prefix = getattr(self.backend, "_prefix", None)
        return {
            "format": SNAPSHOT_FORMAT,
            "version": _SNAPSHOT_VERSION,
            "config": self._config_sig(),
            "step_idx": self.step_idx,
            "next_rid": self._next_rid,
            "counters": {"preemptions": self.n_preemptions,
                         "quarantines": self.n_quarantines,
                         "faults_contained": self.n_faults_contained,
                         "advanced": self._advanced},
            "meta": {str(rid): {"status": m.status, "error": m.error,
                                "retries": m.retries,
                                "max_retries": m.max_retries,
                                "deadline": m.deadline}
                     for rid, m in self._meta.items()},
            "results": {str(rid): _ser_arr(res)
                        for rid, res in self._results.items()},
            "done": {str(rid): bool(v) for rid, v in self._done.items()},
            "queue": {"front": [self._ser_req(r) for r in front],
                      "arrivals": [self._ser_req(r) for r in arrivals]},
            "live": live,
            "prefix_digests": ([k.hex() for k in prefix._entries]
                               if prefix is not None else []),
        }

    def restore_engine(self, state: dict) -> None:
        """Rebuild a snapshot's host state on this engine (freshly
        constructed, same config, nothing submitted). Live requests
        re-enter at the head of the queue as preempted requests do; the
        next ``step`` / ``run`` re-admits them and resumes them
        bit-identically. Refuses (``ValueError``) a snapshot of another
        format (the JAX engine's among them), of another version, of
        another config (naming the keys that differ), and an engine that
        is not fresh."""
        if state.get("format") != SNAPSHOT_FORMAT:
            raise ValueError(
                f"engine snapshot format {state.get('format')!r} != "
                f"{SNAPSHOT_FORMAT!r} — refusing to restore (a snapshot "
                f"of another engine carries another sampling-stream state)")
        if state.get("version") != _SNAPSHOT_VERSION:
            raise ValueError(
                f"engine snapshot version {state.get('version')!r} != "
                f"{_SNAPSHOT_VERSION} — refusing to restore")
        if self._live or len(self.scheduler) or self._results:
            raise ValueError("restore_engine needs a fresh engine: this "
                             "one already has requests")
        mine, theirs = self._config_sig(), state["config"]
        if mine != theirs:
            diff = {k: (theirs.get(k), mine.get(k))
                    for k in set(mine) | set(theirs)
                    if theirs.get(k) != mine.get(k)}
            raise ValueError(f"engine config mismatch (snapshot vs this "
                             f"engine): {diff}")
        self.step_idx = state["step_idx"]
        self._next_rid = state["next_rid"]
        counters = state["counters"]
        self.n_preemptions = counters["preemptions"]
        self.n_quarantines = counters["quarantines"]
        self.n_faults_contained = counters["faults_contained"]
        self._advanced = counters["advanced"]
        self._meta = {int(rid): _ReqMeta(status=m["status"],
                                         error=m["error"],
                                         retries=m["retries"],
                                         max_retries=m["max_retries"],
                                         deadline=m["deadline"])
                      for rid, m in state["meta"].items()}
        self._results = {int(rid): _de_arr(res)
                         for rid, res in state["results"].items()}
        self._done = {int(rid): v for rid, v in state["done"].items()}
        live = [self._de_req(d) for d in state["live"]]
        front = [self._de_req(d) for d in state["queue"]["front"]]
        arrivals = [self._de_req(d) for d in state["queue"]["arrivals"]]
        for req in live:
            # a live slot resumes as a preempted request does: at the
            # queue head, QUEUED until re-admission
            self._meta[req.rid].status = QUEUED
        self.scheduler.restore(
            sorted(live + front, key=lambda r: r._order), arrivals)

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

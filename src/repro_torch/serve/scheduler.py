"""Request scheduler for the continuous-batching engine (a copy of
``repro.serve.scheduler``, logic unchanged; chunk plans wait for chunked
prefill).

Host-side and deliberately simple: requests join a queue; whenever the
engine has freed slots it asks for the next admission wave. The default
``policy="fifo"`` never reorders within a priority class (no head-of-line
bypass, no length bucketing), so a request's admission step is a pure
function of the arrival order — which keeps the engine's per-request
reproducibility contract easy to reason about. ``policy="spf"``
(shortest-prompt-first) is an opt-in toggle that admits the queued request
with the smallest prompt first (stable: ties break on arrival order) — it
trades the arrival-order guarantee for lower head-of-line blocking when
prompts are wildly mixed.

Priority classes: ``Request.priority`` (higher = more urgent,
default 0) is the OUTER sort key under either policy — the scheduler
drains class by class, FIFO/SPF *within* a class. When every request
carries the default priority the order is bit-identical to the pre-class
scheduler, so the determinism contract's arrival-order reasoning is
unchanged for existing callers. The engine's preemption victim hook is the
mirror image: it evicts the LOWEST class first (latest arrival within the
class), so (priority, arrival) stays a total order and the earliest
request of the highest class always makes progress — no livelock.

Preempted requests re-enter through ``add_front`` and always resume BEFORE
any queued arrival of any class: a preempted request already spent pool
pages and prefill FLOPs once, so letting arrivals overtake it would both
starve it and re-inflate the very memory pressure that forced the
preemption. Within the front queue, higher classes stay ahead and lower
request ids (earlier arrivals) break ties — resume order mirrors
preemption order. Smarter policies (prefill/decode interleaving budgets)
can swap in behind the same surface.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

from repro_torch.serve.lifecycle import AdmissionRejected
from repro_torch.serve.sampling import SamplingParams

__all__ = ["Request", "FIFOScheduler"]


@dataclasses.dataclass
class Request:
    """One generation request (host-side descriptor).

    ``tokens`` is the request payload: an integer array is a (T,) token
    prompt (LM backends); a FLOAT array is kept float32 as-is — e.g. a
    Pairformer complex's (n_res, F) residue features — and ``prompt_len``
    reads its leading axis.

    ``key_override`` carries a preempted request's sampling-stream state
    ``[seed, committed-token count]``: the sampler's random numbers are a
    function of that pair, so resuming from the snapshot keeps the sample
    stream bit-identical to the run that was never preempted.

    ``priority``: higher admits first and preempts last; 0 is the default
    class, negative classes are valid (scavenger traffic).

    ``on_token``: optional streaming callback, invoked by the engine once
    per budget unit the request advances — with the emitted token id for
    token backends, or the backend's ``stream_result`` (e.g. the current
    single representation) for non-emitting backends. It rides the request
    descriptor so preemption/resume keeps the stream attached.
    """
    rid: int
    tokens: np.ndarray                        # (T,) int32 prompt | float feats
    max_new_tokens: int
    sampling: SamplingParams = SamplingParams()
    frontend: Optional[np.ndarray] = None     # (F, D) precomputed embeddings
    key_override: Optional[np.ndarray] = None  # (2,) int64 [seed, count]
    priority: int = 0
    on_token: Optional[Callable] = None       # streaming sink (per step)

    def __post_init__(self):
        arr = np.asarray(self.tokens)
        if np.issubdtype(arr.dtype, np.floating):
            self.tokens = np.asarray(arr, np.float32)
            if self.tokens.ndim < 1 or self.tokens.shape[0] < 1:
                raise AdmissionRejected("empty feature payload")
        else:
            self.tokens = np.asarray(arr, np.int32).reshape(-1)
            if self.tokens.size < 1:
                raise AdmissionRejected("empty prompt")
        if self.max_new_tokens < 1:
            raise AdmissionRejected(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")

    @property
    def prompt_len(self) -> int:
        """Valid prefix length (frontend embeddings included)."""
        front = 0 if self.frontend is None else self.frontend.shape[0]
        return front + int(self.tokens.shape[0])

    @property
    def _order(self):
        """Queue sort key: higher class first, earlier arrival within it."""
        return (-self.priority, self.rid)


class FIFOScheduler:
    """Admission into freed slots: priority classes, FIFO (or SPF) within."""

    def __init__(self, policy: str = "fifo"):
        if policy not in ("fifo", "spf"):
            raise ValueError(f"scheduler policy must be 'fifo' or 'spf', "
                             f"got {policy!r}")
        self.policy = policy
        self._front: Deque[Request] = deque()   # preempted, resume first
        self._queue: Deque[Request] = deque()   # arrivals

    def __len__(self) -> int:
        return len(self._front) + len(self._queue)

    def add(self, req: Request) -> None:
        self._queue.append(req)

    def add_front(self, req: Request) -> None:
        """Re-queue a preempted request ahead of every arrival. Higher
        classes stay ahead within the front queue; earlier arrivals (lower
        rid) break ties — matching the engine's preemption order."""
        i = 0
        while i < len(self._front) and self._front[i]._order < req._order:
            i += 1
        self._front.insert(i, req)

    def _pick(self) -> int:
        """Index into ``_queue`` of the next request under ``policy``
        (-1 when empty). Callers drain ``_front`` first. The class is the
        outer key; with all-default priorities this reduces exactly to the
        classless pick (index 0 / shortest prompt)."""
        if not self._queue:
            return -1
        if self.policy == "spf":
            return min(range(len(self._queue)),
                       key=lambda i: (-self._queue[i].priority,
                                      self._queue[i].prompt_len, i))
        return min(range(len(self._queue)),
                   key=lambda i: (-self._queue[i].priority, i))

    def peek(self) -> Optional[Request]:
        """Next request without popping (None when empty) — lets the
        engine gate admission on resources (free pages) without losing
        its place in the queue."""
        if self._front:
            return self._front[0]
        i = self._pick()
        return None if i == -1 else self._queue[i]

    def remove(self, rid: int) -> Optional[Request]:
        """Drop the queued request with id ``rid`` (front or arrival
        queue). Returns the removed request, or None when ``rid`` is not
        queued — cancellation and deadline expiry of requests that never
        reached a slot."""
        for q in (self._front, self._queue):
            for i, r in enumerate(q):
                if r.rid == rid:
                    del q[i]
                    return r
        return None

    def queued(self) -> List[Request]:
        """Every queued request, front queue first (inspection only —
        deadline sweeps and engine checkpoints walk this without
        popping)."""
        return list(self._front) + list(self._queue)

    def snapshot(self) -> Tuple[List[Request], List[Request]]:
        """(front, arrivals) in queue order — the engine checkpoint
        serializes these; ``restore`` rebuilds the exact state."""
        return list(self._front), list(self._queue)

    def restore(self, front: List[Request],
                arrivals: List[Request]) -> None:
        """Replace the queue state with a ``snapshot``'s content."""
        self._front = deque(front)
        self._queue = deque(arrivals)

    def take(self, n: int) -> List[Request]:
        """Pop up to ``n`` requests in policy order (front queue first)."""
        wave: List[Request] = []
        while len(wave) < n:
            if self._front:
                wave.append(self._front.popleft())
                continue
            i = self._pick()
            if i == -1:
                break
            self._queue.rotate(-i)
            wave.append(self._queue.popleft())
            self._queue.rotate(i)
        return wave

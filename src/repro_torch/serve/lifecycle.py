"""Request lifecycle: terminal statuses, result records, typed errors.

A copy of ``repro.serve.lifecycle`` (logic unchanged), the vocabulary of
the fault-tolerance layer:

- **Statuses** — a request moves ``QUEUED -> RUNNING -> {OK, FAILED,
  TIMED_OUT, CANCELLED}``; ``REJECTED`` is the terminal state of a
  request that never passed admission validation (``submit(...,
  strict=False)``). Terminal states are final: no transition leaves
  ``TERMINAL_STATUSES``.
- **RequestRecord** — what ``ServeEngine.result`` returns. It IS the
  result array (an ``np.ndarray`` subclass, so every pre-existing caller
  that treated results as arrays still works verbatim) carrying
  ``status`` and ``error`` alongside: ``(status, tokens, error)`` as one
  value.
- **Typed exceptions** — ``PoolExhausted`` subclasses ``MemoryError``
  (existing ``pytest.raises(MemoryError)`` pins and callers survive);
  ``PoolError`` / ``RequestNotLive`` / ``AdmissionRejected`` are the
  typed failures of the page pool, the engine and the backends;
  ``EngineStalled`` is the run-loop's no-progress diagnostic;
  ``InjectedFault`` marks a ``serve.faults`` injection so containment
  code can tell a drill from a real fault.

Host-only: pure Python/NumPy, no bare asserts.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "QUEUED", "RUNNING", "OK", "FAILED", "TIMED_OUT", "CANCELLED",
    "REJECTED", "TERMINAL_STATUSES", "RequestRecord", "ServeError",
    "PoolExhausted", "PoolError", "RequestNotLive", "AdmissionRejected",
    "EngineStalled", "InjectedFault",
]

# -- request statuses -------------------------------------------------------
QUEUED = "QUEUED"          # submitted, waiting for a slot
RUNNING = "RUNNING"        # admitted into a slot (or mid-chunked-prefill)
OK = "OK"                  # ran out its budget / hit eos — result complete
FAILED = "FAILED"          # quarantined and retried past max_retries
TIMED_OUT = "TIMED_OUT"    # deadline_steps elapsed before completion
CANCELLED = "CANCELLED"    # cancel(rid) before completion
REJECTED = "REJECTED"      # failed admission validation (strict=False)

TERMINAL_STATUSES = frozenset(
    {OK, FAILED, TIMED_OUT, CANCELLED, REJECTED})


class RequestRecord(np.ndarray):
    """A result array that knows how its request ended.

    ``ServeEngine.result(rid)`` returns one of these: the generated ids
    (token backends) or the final single representation (pair backend),
    as a plain-looking ndarray, plus:

    - ``status`` — one of the lifecycle statuses above. Non-terminal
      statuses mean the record is a partial result-so-far.
    - ``error`` — ``None`` unless ``status == FAILED`` / ``REJECTED``
      / ``TIMED_OUT``-with-diagnosis; then a dict with at least
      ``kind`` and ``detail`` keys (``slot`` / ``step`` / ``retries``
      when the failure happened in flight).
    - ``tokens`` — the payload as a plain ``np.ndarray`` view (for
      callers that want to shed the subclass).

    Array semantics are untouched: equality asserts, ``.size``,
    concatenation and serialization all behave exactly as before the
    lifecycle existed — which keeps every caller that treats results as
    arrays working unchanged.
    """

    def __new__(cls, tokens, status: str = OK,
                error: Optional[dict] = None):
        obj = np.asarray(tokens).view(cls)
        obj.status = status
        obj.error = error
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.status = getattr(obj, "status", OK)
        self.error = getattr(obj, "error", None)

    @property
    def tokens(self) -> np.ndarray:
        """The result payload as a plain ndarray (no lifecycle fields)."""
        return np.asarray(self)

    def __repr__(self):
        return (f"RequestRecord(status={self.status!r}, "
                f"tokens={np.asarray(self)!r}, error={self.error!r})")


# -- typed exceptions -------------------------------------------------------

class ServeError(RuntimeError):
    """Base of every typed serve-stack error (survives ``python -O``)."""


class PoolExhausted(MemoryError):
    """The page pool cannot cover an allocation.

    Subclasses ``MemoryError`` so pre-lifecycle callers (and tests) that
    catch ``MemoryError`` keep working; new code catches the typed name.
    The engine contains it: admission backpressure holds the request in
    the queue, and a mid-flight growth failure preempts the growing
    slots (their snapshots resume bit-identically) instead of crashing.
    """


class PoolError(ServeError):
    """Page-accounting invariant broken: double free, incref of a free
    page, double allocation, or a page id outside the pool. Always a
    caller bug — the pool state is still consistent (the offending
    operation did not apply)."""


class RequestNotLive(ServeError):
    """The rid does not name a live (queued or in-flight) request —
    preempt/cancel of an unknown, finished, or never-submitted id."""


class AdmissionRejected(ValueError):
    """Submit-time validation failed: the request can never be admitted
    (footprint exceeds the page table/pool, prompt exceeds a pinned
    ``prefill_len``, wrong payload type for the backend...). Subclasses
    ``ValueError``: rejection is an input error, not an engine fault.
    ``submit(..., strict=False)`` converts it into a ``REJECTED``
    terminal record instead of raising."""


class EngineStalled(ServeError):
    """``run()`` made no progress for ``stall_limit`` consecutive steps
    while work was still queued — a scheduling/accounting deadlock that
    would otherwise spin forever. The message carries queue/pool/slot
    stats for diagnosis."""


class InjectedFault(ServeError):
    """A ``serve.faults.FaultPlan`` injection (never raised outside a
    drill). Containment paths treat it exactly like the real fault it
    simulates; tests assert on the type to prove the recovery path ran."""

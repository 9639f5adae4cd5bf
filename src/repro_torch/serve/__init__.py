"""Serving: the continuous-batching engine over a contiguous slot KV cache,
a shared page pool or a sliding-window ring (the LM families), or over a
slot batch of Pairformer complexes; deterministic fault injection
(``FaultPlan``) and crash-safe engine snapshots."""
from repro_torch.serve.backend import (
    Backend,
    PairBatchBackend,
    TokenDecodeBackend,
)
from repro_torch.serve.engine import ServeEngine, resolve_device
from repro_torch.serve.faults import FAULT_KINDS, FaultPlan, FaultSpec
from repro_torch.serve.lifecycle import (
    CANCELLED, FAILED, OK, QUEUED, REJECTED, RUNNING, TERMINAL_STATUSES,
    TIMED_OUT, AdmissionRejected, EngineStalled, InjectedFault, PoolError,
    PoolExhausted, RequestNotLive, RequestRecord, ServeError)
from repro_torch.serve.pages import PagePool
from repro_torch.serve.sampling import SamplingParams, sample_tokens
from repro_torch.serve.scheduler import FIFOScheduler, Request

__all__ = ["ServeEngine", "Backend", "TokenDecodeBackend",
           "PairBatchBackend", "resolve_device",
           "SamplingParams", "sample_tokens", "FIFOScheduler", "Request",
           "QUEUED", "RUNNING", "OK", "FAILED", "TIMED_OUT", "CANCELLED",
           "REJECTED", "TERMINAL_STATUSES", "RequestRecord", "ServeError",
           "AdmissionRejected", "EngineStalled", "RequestNotLive",
           "PagePool", "PoolError", "PoolExhausted", "InjectedFault",
           "FAULT_KINDS", "FaultPlan", "FaultSpec"]

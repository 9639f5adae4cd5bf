"""Serving: the continuous-batching engine over a contiguous slot KV cache
or a shared page pool (the LM family), or over a slot batch of Pairformer
complexes."""
from repro_torch.serve.backend import (
    Backend,
    PairBatchBackend,
    TokenDecodeBackend,
)
from repro_torch.serve.engine import ServeEngine, resolve_device
from repro_torch.serve.lifecycle import (
    CANCELLED, FAILED, OK, QUEUED, REJECTED, RUNNING, TERMINAL_STATUSES,
    TIMED_OUT, AdmissionRejected, EngineStalled, PoolError, PoolExhausted,
    RequestNotLive, RequestRecord, ServeError)
from repro_torch.serve.pages import PagePool
from repro_torch.serve.sampling import SamplingParams, sample_tokens
from repro_torch.serve.scheduler import FIFOScheduler, Request

__all__ = ["ServeEngine", "Backend", "TokenDecodeBackend",
           "PairBatchBackend", "resolve_device",
           "SamplingParams", "sample_tokens", "FIFOScheduler", "Request",
           "QUEUED", "RUNNING", "OK", "FAILED", "TIMED_OUT", "CANCELLED",
           "REJECTED", "TERMINAL_STATUSES", "RequestRecord", "ServeError",
           "AdmissionRejected", "EngineStalled", "RequestNotLive",
           "PagePool", "PoolError", "PoolExhausted"]

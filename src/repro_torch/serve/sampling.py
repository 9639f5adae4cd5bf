"""Per-slot token sampling: greedy / temperature / top-k.

All slots are sampled in one call over the ``(B_slots, V)`` logits; each
slot carries its own temperature, top-k and sampling-stream state
``(seed, count)``, where ``count`` is the number of tokens the request has
committed. The random numbers are a counter-based hash of ``(seed, count,
vocab id)`` turned into Gumbel noise (Gumbel-max sampling), so a request's
sample stream is a pure function of its own seed and token count —
bit-identical whether it runs alone or packed into a busy batch, and
resumable from a ``[seed, count]`` snapshot. The engine advances ``count``
only for slots that actually emitted a token.

The port cannot reproduce the reference's threefry bits: sampled streams
are held to these in-port contracts only; greedy decoding matches the
reference token for token.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SamplingParams", "sample_tokens", "sample_tokens_guarded"]

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 selects greedy; top_k == 0 keeps the full vocab."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature {self.temperature} < 0")
        if self.top_k < 0:
            raise ValueError(f"top_k {self.top_k} < 0")


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash on int64 tensors holding values < 2^32 (the
    multipliers are below 2^31, so no product overflows int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _M32
    return x ^ (x >> 16)


def _gumbel(seeds: np.ndarray, counts: np.ndarray, vocab: int,
            device) -> torch.Tensor:
    """(B, V) Gumbel noise, a pure function of (seed, count, vocab id)."""
    s = torch.as_tensor(np.asarray(seeds, np.int64) & _M32, device=device)
    c = torch.as_tensor(np.asarray(counts, np.int64) & _M32, device=device)
    key = _mix32(_mix32(s) ^ ((c * 0x61C88647) & _M32))
    idx = torch.arange(vocab, device=device, dtype=torch.int64)
    h = _mix32(_mix32((key[:, None] + idx[None, :] * 0x2545F491) & _M32))
    u = ((h >> 8).float() + 0.5) / float(1 << 24)        # (0, 1), exact
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, temps: np.ndarray, top_ks: np.ndarray,
                  seeds: np.ndarray, counts: np.ndarray,
                  vocab: int) -> torch.Tensor:
    """Sample one token per slot.

    logits (B, V) on any device; temps (B,) f32, top_ks (B,) int, seeds and
    counts (B,) int are host arrays (the engine's host-side slot state).
    ``vocab`` masks TP-padded vocab rows so padding ids can never be
    emitted. Returns tokens (B,) int64 on the logits' device."""
    b, v = logits.shape
    dev = logits.device
    lg = logits.float()
    if vocab < v:
        lg = lg.masked_fill(torch.arange(v, device=dev) >= vocab, -torch.inf)
    greedy = lg.argmax(dim=-1)
    temps = np.asarray(temps, np.float32)
    if not (temps > 0).any():
        return greedy
    top_ks = np.asarray(top_ks, np.int64)
    if (top_ks > 0).any():
        # per-slot top-k via the k-th largest logit as threshold
        kth_idx = torch.as_tensor(np.clip(top_ks - 1, 0, v - 1), device=dev)
        sorted_desc = lg.sort(dim=-1, descending=True).values
        kth = sorted_desc.gather(1, kth_idx[:, None])
        trunc = lg.masked_fill(lg < kth, -torch.inf)
        lg = torch.where(torch.as_tensor(top_ks > 0, device=dev)[:, None],
                         trunc, lg)
    t = torch.as_tensor(np.maximum(temps, 1e-6), device=dev)
    sampled = (lg / t[:, None] + _gumbel(seeds, counts, v, dev)).argmax(dim=-1)
    return torch.where(torch.as_tensor(temps > 0, device=dev), sampled,
                       greedy)


def sample_tokens_guarded(logits: torch.Tensor, temps, top_ks, seeds, counts,
                          vocab: int):
    """``sample_tokens`` plus the per-slot RAW-logit row maximum: the
    non-finite guard's reduction (-inf entries are legitimate — masking,
    top-k — but the max is finite for any sane row and poisoned by any
    NaN). Returns (tokens, peak), both on the logits' device."""
    peak = logits.float().amax(dim=-1)
    return sample_tokens(logits, temps, top_ks, seeds, counts, vocab), peak

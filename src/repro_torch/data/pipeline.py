"""Synthetic, deterministic, shard-aware batch generators (the port's copy
of ``repro.data.pipeline``: numpy only, so batches are bit-equal to the
reference's).

Design rules:

- **Stateless**: ``batch(step)`` is a pure function of (seed, step, shard).
  The "data iterator state" in a checkpoint is just the integer step.
- **Shard-aware**: ``LMBatches(..., shard=(i, n))`` yields the i-th of n
  disjoint slices of the global batch, so each host materializes only its
  slice. Its rows are drawn with ``salt=i``, so they are not the rows of
  the ``shard=(0, 1)`` batch: sharded training (``launch.train --mesh``)
  builds the same global ``shard=(0, 1)`` batch on every rank, which is
  deterministic and cheap, and the train step keeps each rank's rows
  (frontend rows with their tokens), as jit's input sharding cuts the
  reference's global batch, so its losses are the unsharded run's.
- **Learnable**: token streams follow a noisy modular-increment process so
  examples can demonstrate a falling loss; PDE targets are smooth analytic
  fields of the coordinates.

Numpy's Philox gives counter-based determinism (seed x step) without
carrying RNG state across steps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["LMBatches", "PDEBatches", "PatchBatches"]


def _rng(seed: int, step: int, salt: int = 0) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=seed, counter=[step, salt, 0, 0]))


@dataclasses.dataclass(frozen=True)
class LMBatches:
    """Next-token LM batches: tokens[t+1] = (tokens[t] + stride) % vocab with
    p_noise random corruption. labels = next token."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    p_noise: float = 0.1
    frontend_len: int = 0
    d_model: int = 0
    shard: Tuple[int, int] = (0, 1)

    def _local_batch(self) -> int:
        i, n = self.shard
        assert self.global_batch % n == 0, (self.global_batch, n)
        return self.global_batch // n

    def batch(self, step: int) -> dict:
        b = self._local_batch()
        g = _rng(self.seed, step, salt=self.shard[0])
        start = g.integers(0, self.vocab, size=(b, 1))
        stride = g.integers(1, 8, size=(b, 1))
        t = np.arange(self.seq_len + 1)[None, :]
        seq = (start + stride * t) % self.vocab
        noise = g.random(seq.shape) < self.p_noise
        seq = np.where(noise, g.integers(0, self.vocab, size=seq.shape), seq)
        out = {"tokens": seq[:, :-1].astype(np.int32),
               "labels": seq[:, 1:].astype(np.int32)}
        if self.frontend_len:
            out["frontend"] = g.standard_normal(
                (b, self.frontend_len, self.d_model)).astype(np.float32)
        return out


@dataclasses.dataclass(frozen=True)
class PDEBatches:
    """Point clouds + analytic physics fields (pressure + 3 velocity)."""

    n_points: int
    global_batch: int
    seed: int = 0
    coord_dim: int = 3
    shard: Tuple[int, int] = (0, 1)

    def batch(self, step: int) -> dict:
        i, n = self.shard
        b = self.global_batch // n
        g = _rng(self.seed, step, salt=i)
        coords = g.standard_normal((b, self.n_points, self.coord_dim)).astype(np.float32)
        r2 = (coords ** 2).sum(-1, keepdims=True)
        pressure = np.exp(-r2) * np.sin(coords[..., :1] * 3.0)
        velocity = np.cos(coords * 2.0) * np.exp(-r2 / 2.0)
        targets = np.concatenate([pressure, velocity], axis=-1)[..., :4]
        return {"coords": coords, "targets": targets.astype(np.float32)}


@dataclasses.dataclass(frozen=True)
class PatchBatches:
    """Window-partitioned patch batches for the Swin stack."""

    n_windows: int
    window: int
    global_batch: int
    n_classes: int = 1000
    seed: int = 0
    shard: Tuple[int, int] = (0, 1)

    def batch(self, step: int) -> dict:
        i, n = self.shard
        b = self.global_batch // n
        g = _rng(self.seed, step, salt=i)
        labels = g.integers(0, self.n_classes, size=(b,)).astype(np.int32)
        patches = g.standard_normal(
            (b, self.n_windows, self.window, 48)).astype(np.float32)
        # class-dependent mean shift so the task is learnable
        patches += (labels[:, None, None, None] % 7 - 3) * 0.1
        return {"patches": patches, "labels": labels}

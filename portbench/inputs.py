"""Inputs made from the seed: seeds of the separate streams, mesh points
and targets, and the order of requests.

Every seed draws the same sizes (the traffic file fixes them), so two
seeds give the same work on other data.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def stream_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one stream (``parts`` name it) of run ``seed``."""
    text = ":".join(str(p) for p in (seed,) + parts)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(seed: int, device, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, *parts))


def mesh_points(seed: int, index: int, batch: int, points: int, dim: int,
                device) -> torch.Tensor:
    """Mesh points uniform in the unit cube, ``(batch, points, dim)``."""
    return torch.rand((batch, points, dim), device=device,
                      generator=generator(seed, device, "mesh", index))


def mesh_batch(seed: int, step: int, batch: int, points: int, dim: int,
               channels: int, device) -> dict:
    """A regression batch: mesh points and standard-normal targets."""
    targets = torch.randn((batch, points, channels), device=device,
                          generator=generator(seed, device, "targets", step))
    return {"coords": mesh_points(seed, step, batch, points, dim, device),
            "targets": targets}


def order(seed: int, n: int, *parts) -> np.ndarray:
    """A permutation of ``range(n)`` drawn from the seed."""
    return np.random.default_rng(stream_seed(seed, "order", *parts)) \
        .permutation(n)

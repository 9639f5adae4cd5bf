"""Deterministic synthetic data pipelines (stateless index -> batch).

Every pipeline is a pure function of (seed, step, shard), so a restart
resumes its data from the integer step alone.
"""
from repro_torch.data.pipeline import LMBatches, PatchBatches, PDEBatches

__all__ = ["LMBatches", "PDEBatches", "PatchBatches"]

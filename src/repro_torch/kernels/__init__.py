"""Attention and SSD-scan kernels: hand-written Hopper CUDA sources in
``csrc/``, each beside its plain PyTorch version, dispatched by ``ops``.
Importing this package builds nothing; a kernel compiles at its first
launch."""
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import flash_decode_fwd, flash_decode_torch
from repro_torch.kernels.flashbias_attn import (
    flashbias_attention_fwd,
    flashbias_attention_ragged_fwd,
    flashbias_attention_torch,
)
from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_torch

__all__ = ["ops", "flash_decode_fwd", "flash_decode_torch",
           "flashbias_attention_fwd", "flashbias_attention_ragged_fwd",
           "flashbias_attention_torch", "ssd_scan_fwd", "ssd_scan_torch"]

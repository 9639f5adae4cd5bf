"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``<name>.cu`` exposes a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``.
Libraries land in ``build/kernels/`` at the repository root, named by a
digest of the source, every ``csrc/*.cuh`` header and the flags, so an
edited source or header rebuilds and an unchanged one is reused. A library
links only the CUDA runtime: driver functions (``cuTensorMapEncodeTiled``)
are fetched through ``cudaGetDriverEntryPoint``, with no ``-lcuda``. Nothing is built at import time: the first launch
(or an explicit ``build``) compiles.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

__all__ = ["KERNELS", "build", "load", "library_path", "refuse_dtensors"]

KERNELS = ("flashbias_attn", "flashbias_attn_bwd", "flash_decode", "ssd_scan")

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def refuse_dtensors(name: str, *tensors) -> None:
    """A kernel wrapper takes plain local tensors (a sharded caller passes
    ``DTensor.to_local()`` shards): a DTensor raises here instead of
    reaching the plain path or a kernel pointer. A plain tensor costs one
    type check."""
    for t in tensors:
        if t is not None and type(t) is not torch.Tensor:
            from torch.distributed.tensor import DTensor
            if isinstance(t, DTensor):
                raise TypeError(f"{name}: got a DTensor; pass its local "
                                f"shard (DTensor.to_local())")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every missing library of ``names``, one ``nvcc`` per source,
    all started together. Returns ``{name: {"seconds", "ptxas"}}`` for the
    libraries compiled by this call (``ptxas`` holds the register and
    shared-memory report). Raises with the compiler output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.monotonic())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.monotonic() - t0, "ptxas": text}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib

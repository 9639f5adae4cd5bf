"""Roofline terms of a dry-run cell on the H100 (port of
``repro.analysis.roofline``; no card needed).

Per (arch x shape x mesh) cell, three times-if-perfectly-overlapped:

    compute_s    = FLOPs_per_rank / peak bf16 FLOP/s
    memory_s     = bytes_per_rank / HBM bandwidth
    collective_s = sum over mesh axes of wire_bytes_per_rank / link rate

The dry run (``launch/dryrun.py``) runs the port's own step on fake
tensors and counts what it does: FLOPs with ``FlopCounterMode``, bytes as
the operand and result bytes of every aten op that touches storage, and
the collectives ``dist/collectives.py`` issues, each with its result
bytes, group size and mesh axes. The link rate of a collective depends on
where its group lies (``hw.ChipSpec.link_bandwidth``: NVLink on
``model``, the network on ``data`` / ``pod``). ``model_flops``
(6·N_active·tokens for training, 2·N_active·tokens for inference;
unpadded counts, attention excluded by the MFU convention) over the
counted FLOPs exposes padding, remat and redundant work.

The arithmetic functions compute exactly what the reference's do, on the
port's ``ArchConfig`` (the same fields).
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.hw import H100_SXM, ChipSpec

__all__ = ["collective_bytes", "roofline_report", "active_params",
           "model_flops", "attention_kv_reread_bytes",
           "attention_kernel_flops", "DTYPE_BYTES", "COLLECTIVES"]

DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.int16: 2, torch.float16: 2, torch.bfloat16: 2,
    torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _wire_bytes(op: str, result_bytes: int, g: int) -> float:
    """Ring-algorithm bytes on the wire per device.

    all-gather:   each device receives (g-1)/g of the full result.
    all-reduce:   reduce-scatter + all-gather -> 2 x (g-1)/g x result.
    reduce-scatter: operand is g x result; (g-1)/g of it crosses the wire.
    all-to-all:   (g-1)/g of the buffer changes device.
    collective-permute: the whole buffer moves.
    """
    if g <= 1:
        return 0.0
    f = (g - 1) / g
    if op == "all-gather":
        return f * result_bytes
    if op == "all-reduce":
        return 2.0 * f * result_bytes
    if op == "reduce-scatter":
        return f * result_bytes * g
    if op == "all-to-all":
        return f * result_bytes
    return float(result_bytes)          # collective-permute


def collective_bytes(records: Iterable) -> dict:
    """Per-rank collective wire bytes of the collectives a dry run
    recorded, each ``(op, result_bytes, group_size, mesh_axes)`` with
    ``op`` one of ``COLLECTIVES``: the ring model above on each. Returns
    ``{op: bytes, ..., "total": B, "counts": {op: n}, "by_axis": {"data" |
    "model" | "pod,data" ...: bytes}}`` (the reference's dict, parsed from
    HLO there, plus the split by mesh axes)."""
    out = {k: 0.0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    by_axis: dict = {}
    for op, rb, g, axes in records:
        w = _wire_bytes(op, rb, g)
        out[op] += w
        counts[op] += 1
        key = ",".join(axes or ())
        by_axis[key] = by_axis.get(key, 0.0) + w
    out["total"] = sum(out[k] for k in COLLECTIVES)
    out["counts"] = counts
    out["by_axis"] = by_axis
    return out


# ---------------------------------------------------------------------------
# MODEL_FLOPS (useful work) from the *unpadded* architecture figures
# ---------------------------------------------------------------------------

def active_params(cfg: ArchConfig) -> int:
    """Per-token-active matmul parameters, REAL (unpadded) figures."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, (cfg.n_kv_heads or cfg.n_heads)
    per_layer = 0
    if cfg.family in ("dense", "moe", "hybrid"):
        per_layer += d * hd * (2 * h + 2 * kv)              # wq, wo, wk, wv
    if cfg.family in ("ssm", "hybrid"):
        d_in = cfg.ssm_expand * d
        per_layer += d * (2 * d_in + 2 * cfg.ssm_state + cfg.ssm_heads)
        per_layer += d_in * d
    if cfg.family == "moe":
        per_layer += cfg.top_k * 3 * d * cfg.d_ff + d * cfg.n_experts
    elif cfg.d_ff:
        per_layer += 3 * d * cfg.d_ff
    unembed = d * cfg.vocab
    return cfg.n_layers * per_layer + unembed


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """6·N_active·tokens (train) or 2·N_active·tokens (prefill/decode)."""
    n = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch        # decode: one token per request


def attention_kv_reread_bytes(cfg: ArchConfig, shape: ShapeSpec,
                              n_data: int, *, block: int = 128) -> float:
    """Extra per-device HBM bytes of a flash kernel beyond read-once: each
    allowed (q-block, kv-block) tile pair re-reads the K/V tiles — the
    Theta(NM(C+R)^2/S) term of the paper's Cor. 3.7 for ``block``-row
    tiles (the reference's 128; the port's kernel 1 tiles by 64).

    Every device reads its batch shard's full KV. Causal masks allow ~1/2
    of the pairs, sliding windows ~(window + 2*block)/N; decode reads the
    cache once (no reread). Train charges fwd + backward (~2x fwd IO), the
    reference's multiplier.
    """
    if cfg.family not in ("dense", "moe", "hybrid") or shape.kind == "decode":
        return 0.0
    n = shape.seq_len
    b_loc = max(1, shape.global_batch // n_data)
    if cfg.window:
        frac = min(1.0, (cfg.window + 2 * block) / n)
    else:
        frac = 0.5
    rereads = frac * (n / block)
    kv_bytes = (n * cfg.kv_heads_padded * cfg.resolved_head_dim
                * 2 * 2)                     # k+v, bf16
    extra_per_layer = max(0.0, rereads - 1.0) * kv_bytes * b_loc
    mult = 3.0 if shape.kind == "train" else 1.0   # fwd + ~2x bwd
    if shape.kind == "train":
        mult *= 1.0                                # grad-accum already in b_loc
    return extra_per_layer * cfg.n_layers * mult


def attention_kernel_flops(cfg: ArchConfig, shape: ShapeSpec,
                           n_data: int, n_model: int,
                           *, block: int = 128) -> float:
    """Per-device FLOPs of a block-pruned flash kernel:
    ``mask_frac * (2*hd[qk] + 2*hd[pv] + 2*r[bias]) * B*H*N*M`` with r = 2
    for ALiBi, the mask fraction ~1/2 causal and ~(window + 2*block)/N for
    a sliding window. Train charges fwd + backward (3x fwd)."""
    if cfg.family not in ("dense", "moe", "hybrid") or shape.kind == "decode":
        return 0.0
    n = shape.seq_len
    b_loc = max(1, shape.global_batch // n_data)
    h_loc = max(1, cfg.heads_padded // n_model)
    if cfg.window:
        frac = min(1.0, (cfg.window + 2 * block) / n)
    else:
        frac = 0.5
    r = 2 if cfg.bias_kind == "alibi" else 0
    hd = cfg.resolved_head_dim
    per_pair = 2 * hd + 2 * hd + 2 * r
    fwd = frac * b_loc * h_loc * n * n * per_pair
    mult = 3.0 if shape.kind == "train" else 1.0
    return fwd * cfg.n_layers * mult


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------

def roofline_report(*, flops_per_device: float, bytes_per_device: float,
                    coll_bytes_per_device: float, cfg: ArchConfig,
                    shape: ShapeSpec, n_devices: int,
                    coll_detail: Optional[dict] = None,
                    adjusted_bytes_per_device: Optional[float] = None,
                    adjusted_flops_per_device: Optional[float] = None,
                    chip: ChipSpec = H100_SXM,
                    coll_bytes_by_axis: Optional[dict] = None) -> dict:
    """The reference's report on ``chip``. ``adjusted_*_per_device``: the
    deployment path — the kernels' own HBM footprint and FLOPs (the
    ``io_stub`` run) in place of the plain path's. Where present, the
    dominant term and the roofline fraction use them; the plain path's
    numbers are reported beside them (``*_xla``, the reference's names).

    ``coll_bytes_by_axis`` (``collective_bytes(...)["by_axis"]``) charges
    each mesh axis's wire bytes at its own link rate; without it every
    collective byte is charged at the slower, cross-node rate."""
    hw = chip
    compute_s_xla = flops_per_device / hw.peak_flops_bf16
    memory_s = bytes_per_device / hw.hbm_bandwidth
    if coll_bytes_by_axis is None:
        by_axis_s = {}
        collective_s = coll_bytes_per_device / hw.network_bandwidth
    else:
        by_axis_s = {k: b / hw.link_bandwidth(tuple(k.split(",")) if k
                                              else ())
                     for k, b in coll_bytes_by_axis.items()}
        collective_s = sum(by_axis_s.values())
    memory_s_adj = (adjusted_bytes_per_device / hw.hbm_bandwidth
                    if adjusted_bytes_per_device is not None else None)
    compute_s_adj = (adjusted_flops_per_device / hw.peak_flops_bf16
                     if adjusted_flops_per_device is not None else None)
    eff_memory = memory_s_adj if memory_s_adj is not None else memory_s
    eff_compute = compute_s_adj if compute_s_adj is not None else compute_s_xla
    terms = {"compute_s": eff_compute, "memory_s": eff_memory,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    mf_per_device = mf / n_devices
    total = max(terms.values())
    eff_flops = (adjusted_flops_per_device
                 if adjusted_flops_per_device is not None
                 else flops_per_device)
    return {
        "arch": cfg.name, "shape": shape.name, "devices": n_devices,
        "chip": hw.name,
        "compute_s": eff_compute, "compute_s_xla": compute_s_xla,
        "memory_s": eff_memory,
        "memory_s_xla": memory_s, "memory_s_adjusted": memory_s_adj,
        "collective_s": collective_s,
        "collective_s_by_axis": by_axis_s,
        "dominant": dominant,
        "hlo_flops_per_device": flops_per_device,
        "adjusted_flops_per_device": adjusted_flops_per_device,
        "hlo_bytes_per_device": bytes_per_device,
        "adjusted_bytes_per_device": adjusted_bytes_per_device,
        "collective_bytes_per_device": coll_bytes_per_device,
        "collective_detail": coll_detail or {},
        "model_flops_total": mf,
        "model_flops_per_device": mf_per_device,
        "useful_flops_ratio": (mf_per_device / eff_flops
                               if eff_flops else 0.0),
        # fraction of the compute roofline reached if the dominant term were
        # the exact step time
        "roofline_fraction": ((mf_per_device / hw.peak_flops_bf16) / total
                              if total else 0.0),
    }

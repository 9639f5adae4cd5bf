"""Config schema + arch registry (the port's own copy of ``repro.configs.base``).

Every architecture the port serves lives in its own ``configs/<id>.py``
defining ``CONFIG`` (exact published figures) and ``SMOKE`` (reduced
same-family variant for CPU tests). The dataclass and its padding
properties are kept field for field, so a config means the same model in
both packages; only ``attn_impl`` speaks the port's implementation names.
"""
from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ArchConfig", "ARCH_IDS", "REFERENCE_ARCH_IDS", "PAPER_IDS",
           "ShapeSpec", "SHAPES", "get_config", "smoke_config",
           "list_archs", "cells"]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture. Exact figures from the assignment; padding derived.

    ``tp`` is the tensor-parallel degree the padded dims target (16 on the
    production mesh, 1 for smoke configs so tests stay small).
    """

    name: str
    family: str                   # dense | moe | ssm | hybrid | swin | pde | pairformer
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 0
    head_dim: int = 0             # 0 -> d_model // n_heads

    # --- attention bias / positional (the paper's technique) ---
    bias_kind: str = "alibi"      # "alibi" | "none" | "pair"
    bias_mode: str = "flashbias"  # "flashbias" (factored) | "dense" |
                                  # "dense_recompute" (Pairformer baselines)
    rope: bool = False
    window: int = 0               # sliding-window size; 0 = full attention

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4

    # --- frontends (audio/vision stubs: precomputed embeddings) ---
    frontend: str = "none"        # "none" | "audio" | "vision"
    frontend_len: int = 0

    # --- paper-model extras ---
    coord_dim: int = 3            # pde: spatial dimension of mesh points
    d_pair: int = 0               # pairformer: pair-representation channels
    bias_rank: int = 0            # svd/neural decomposition rank R

    # --- parallelism / numerics ---
    pad_heads: int = 0            # explicit override of heads_padded
    pad_kv_heads: int = 0         # explicit override of kv_heads_padded
    tp: int = 16
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "dots"           # "none" | "dots" | "full"
    attn_chunk: int = 512         # kv chunk of the XLA flash path
    attn_impl: str = "auto"       # "auto" | "torch" | "cuda"
    cache_layout: str = "kernel"  # kv-head-major (B, KVH, S, hd) caches
    ssd_chunk: int = 256          # SSD intra-chunk quadratic block
    grad_accum: int = 1           # microbatches per train step
    grad_rs: bool = False         # pin grads to param shardings

    notes: str = ""

    # ---- derived (TP padding; zero-padded weights keep math exact) ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def kv_groups(self) -> int:
        """Padded q-heads per padded kv head."""
        if self.n_kv_heads == 0:
            return 1
        return self.heads_padded // self.kv_heads_padded

    @property
    def kv_heads_padded(self) -> int:
        if self.pad_kv_heads:
            return self.pad_kv_heads
        if self.n_kv_heads == 0:
            return 0
        if self.n_kv_heads == self.n_heads:     # MHA: pad kv with q
            return self.heads_padded
        return self.n_kv_heads                  # GQA kv stays (replicated)

    @property
    def heads_padded(self) -> int:
        if self.pad_heads:
            return self.pad_heads
        if self.n_heads == 0:
            return 0
        if self.n_kv_heads and self.n_kv_heads != self.n_heads:
            # keep the (kv, group) structure: pad groups so kv*g % tp == 0
            kv = self.pad_kv_heads or self.n_kv_heads
            g = _ceil_to(self.n_heads, kv) // kv
            while (kv * g) % self.tp:
                g += 1
            return kv * g
        return _ceil_to(self.n_heads, self.tp)

    @property
    def vocab_padded(self) -> int:
        return _ceil_to(self.vocab, self.tp) if self.vocab else 0

    @property
    def experts_padded(self) -> int:
        return _ceil_to(self.n_experts, self.tp) if self.n_experts else 0

    @property
    def ssm_heads(self) -> int:
        if not self.ssm_state:
            return 0
        d_inner = self.ssm_expand * self.d_model
        return d_inner // self.ssm_head_dim

    @property
    def ssm_heads_padded(self) -> int:
        return _ceil_to(self.ssm_heads, self.tp) if self.ssm_state else 0

    @property
    def d_inner_padded(self) -> int:
        return self.ssm_heads_padded * self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate *logical* (unpadded) parameter count, the
        reference's formula."""
        d, v, l = self.d_model, self.vocab, self.n_layers
        hd = self.resolved_head_dim
        n = v * d                                     # embedding (+ tied head)
        attn = (d * hd * (self.n_heads * 2)
                + d * hd * (self.n_kv_heads or self.n_heads) * 2)
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            d_in = self.ssm_expand * d
            ssm = (d * (2 * d_in + 2 * self.ssm_state + self.ssm_heads)
                   + d_in * d)
        if self.family == "moe":
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        elif self.family == "ssm":
            ffn, attn = 0, ssm
        else:
            ffn = 3 * d * self.d_ff
        if self.family == "hybrid":
            attn += ssm
        return n + l * (attn + ffn + 2 * d)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str      # "train" | "prefill" | "decode"


# the dry run's shape registry, the reference's field for field
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# The architectures the port runs: the dense (the two frontend configs
# among them), MoE, SSM and hybrid families and the Pairformer (served),
# and the paper's vision and PDE models (forward): all 14 of the
# reference's.
ARCH_IDS = ["gpt2_alibi_15b", "stablelm_12b", "codeqwen15_7b", "minicpm_2b",
            "command_r_plus_104b", "musicgen_medium", "phi3_vision_42b",
            "granite_moe_3b_a800m", "llama4_scout_17b_a16e", "mamba2_130m",
            "hymba_15b", "pairformer_lite", "swinv2_b", "pde_solver"]


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; the port has "
                         f"{ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).SMOKE



# The reference's catalogue of the dry run (its ``ARCH_IDS``, in its
# order) and the paper's four models. The port's own ``ARCH_IDS`` above
# names everything ``get_config`` loads.
REFERENCE_ARCH_IDS = [
    "musicgen_medium",
    "command_r_plus_104b",
    "minicpm_2b",
    "stablelm_12b",
    "codeqwen15_7b",
    "phi3_vision_42b",
    "llama4_scout_17b_a16e",
    "granite_moe_3b_a800m",
    "hymba_15b",
    "mamba2_130m",
]

PAPER_IDS = ["gpt2_alibi_15b", "swinv2_b", "pde_solver", "pairformer_lite"]


def list_archs(include_paper: bool = False):
    return list(REFERENCE_ARCH_IDS) + (list(PAPER_IDS) if include_paper
                                       else [])


def cells():
    """All (arch_id, shape_name) dry-run cells, with the reference's skips:
    ``long_500k`` needs sub-quadratic attention, so it runs only for the
    SSM (mamba2) and hybrid (hymba: sliding window + constant state)
    archs."""
    out = []
    for a in REFERENCE_ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            if s.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
                continue
            out.append((a, s.name))
    return out

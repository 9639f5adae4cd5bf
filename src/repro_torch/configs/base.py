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

__all__ = ["ArchConfig", "ARCH_IDS", "get_config", "smoke_config"]


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

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# The architectures the port serves: the dense family, the SSM family and
# the Pairformer.
ARCH_IDS = ["gpt2_alibi_15b", "stablelm_12b", "mamba2_130m",
            "pairformer_lite"]


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; the port has "
                         f"{ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).SMOKE


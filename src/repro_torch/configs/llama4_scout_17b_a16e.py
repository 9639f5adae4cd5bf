"""llama4-scout-17b-a16e [moe] — 16 experts, top-1 routing, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]. Expert dim 16 == TP=16.
Heads pad 40 -> 48 (groups 5 -> 6, head dim 128).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    top_k=1,
    bias_kind="alibi",
    remat="full",
    grad_accum=8,
    notes="16e top-1; EP maps one expert per model shard",
)

SMOKE = CONFIG.replace(
    grad_accum=1,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    n_experts=4, top_k=1, tp=1, remat="none", dtype="float32",
)

"""granite-moe-3b-a800m [moe] — 40 experts, top-8 routing.

32L d_model=1536 24H (GQA kv=8) d_ff=512(per-expert) vocab=49155,
MoE 40e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
Experts pad 40 -> 48 (router logits for pads = -1e30); heads pad 24 -> 32
(4 per kv head, head dim 64); vocab pads 49155 -> 49168.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    top_k=8,
    bias_kind="alibi",
    grad_accum=4,
    notes="40e top-8; experts padded to 48 with -inf router logits",
)

SMOKE = CONFIG.replace(
    grad_accum=1,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
    n_experts=5, top_k=2, tp=1, remat="none", dtype="float32",
)

"""GPT-2 1.5B + ALiBi — the paper's LLM experiment (Sec. 4.2, Table 3).

48 decoder layers, 1600 channels, 50 heads, FFN 6400, causal mask + ALiBi.
FlashBias uses the exact rank-2 decomposition (Example 3.4) — bit-equivalent
to dense ALiBi. Heads pad 50 -> 64 for TP=16; vocab 50257 -> 50272.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gpt2-alibi-1.5b",
    family="dense",
    n_layers=48,
    d_model=1600,
    n_heads=50,
    n_kv_heads=50,
    d_ff=6400,
    vocab=50257,
    head_dim=32,
    bias_kind="alibi",
    grad_accum=4,
    notes="paper Sec 4.2; exact R=2 ALiBi decomposition",
)

SMOKE = CONFIG.replace(
    grad_accum=1,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
    head_dim=16, tp=1, remat="none", dtype="float32",
)

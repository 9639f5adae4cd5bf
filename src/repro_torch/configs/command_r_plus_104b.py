"""command-r-plus-104b [dense] — GQA, no-bias(-terms in projections).

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01; unverified]. FlashBias-ALiBi (R=2).
Heads 96 / kv 8 divide TP=16 cleanly — no padding. 12 q heads per kv head:
the decode kernels take up to 16.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    bias_kind="alibi",
    grad_accum=16,
    remat="full",
    notes="GQA 12:1; largest assigned arch",
)

SMOKE = CONFIG.replace(
    grad_accum=1,
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=256,
    tp=1, remat="none", dtype="float32",
)

"""minicpm-2b [dense] — llama-like, trained with a WSD schedule.

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753 [arXiv:2404.06395; hf].
Heads pad 36 -> 48 (head dim 64); vocab pads 122753 -> 122768. The WSD
schedule belongs to training, which the port does not run yet.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    bias_kind="alibi",
    remat="full",
    grad_accum=4,
    notes="WSD schedule (optim); arch is llama-like MHA",
)

SMOKE = CONFIG.replace(
    grad_accum=1,
    n_layers=2, d_model=72, n_heads=6, n_kv_heads=6, d_ff=144, vocab=160,
    tp=1, remat="none", dtype="float32",
)

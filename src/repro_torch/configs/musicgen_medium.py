"""musicgen-medium [audio] — decoder-only over EnCodec tokens.

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048 [arXiv:2306.05284; hf].
The EnCodec/text-conditioning frontend is a stub: ``input_specs`` provides a
64-frame precomputed conditioning-embedding prefix. FlashBias-ALiBi bias
(exact decomposition, R=2). Heads pad 24 -> 32 for TP=16.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="dense",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    bias_kind="alibi",
    remat="full",  # dots remat stores >16GB temps at this batch (§Perf)
    grad_accum=4,
    frontend="audio",
    frontend_len=64,
    notes="decoder-only over EnCodec tokens; conditioning prefix stubbed",
)

SMOKE = CONFIG.replace(
    grad_accum=1,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
    frontend_len=8, tp=1, remat="none", dtype="float32",
)

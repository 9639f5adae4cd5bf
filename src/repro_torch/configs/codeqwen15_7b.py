"""codeqwen1.5-7b [dense] — qwen1.5 arch (MHA).

32L d_model=4096 32H (MHA kv=32) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B; hf]. FlashBias-ALiBi (R=2). No padding needed.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    bias_kind="alibi",
    grad_accum=4,
    remat="full",
    notes="qwen1.5-arch; MHA",
)

SMOKE = CONFIG.replace(
    grad_accum=1,
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=4, d_ff=192, vocab=160,
    tp=1, remat="none", dtype="float32",
)

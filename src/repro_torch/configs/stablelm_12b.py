"""stablelm-12b [dense] — GQA.

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352
[hf:stabilityai/stablelm-2-1_6b; hf]. head_dim = 160 (5120/32).
FlashBias-ALiBi (R=2). No padding needed (32 and 8 divide/replicate fine).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    bias_kind="alibi",
    grad_accum=8,   # accum 4 leaves >16GB activation temps (§Perf)
    remat="full",   # dots stores >16GB temps at this batch (EXPERIMENTS §Perf)
    notes="GQA 4:1, head_dim 160 (not a 128 multiple; kernels pad lanes)",
)

SMOKE = CONFIG.replace(
    grad_accum=1,
    n_layers=2, d_model=160, n_heads=4, n_kv_heads=2, d_ff=320, vocab=256,
    tp=1, remat="none", dtype="float32",
)

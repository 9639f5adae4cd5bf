"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stubbed).

32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct; hf]. The CLIP image tower is a
stub: ``input_specs`` provides 576 precomputed patch embeddings prepended to
the text tokens. FlashBias-ALiBi over the joint sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    bias_kind="alibi",
    remat="full",  # dots remat stores >16GB temps at this batch (§Perf)
    grad_accum=4,
    frontend="vision",
    frontend_len=576,
    notes="CLIP patch embeddings stubbed as precomputed frontend inputs",
)

SMOKE = CONFIG.replace(
    grad_accum=1,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
    frontend_len=16, tp=1, remat="none", dtype="float32",
)

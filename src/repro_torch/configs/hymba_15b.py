"""hymba-1.5b [hybrid] — parallel attention + Mamba2 heads in every layer.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16
[arXiv:2411.13676; hf]. As in the reference config: every layer runs
sliding-window attention (window 1024) beside a parallel SSM branch (the
published model keeps 3 full-attention layers and meta tokens; the hybrid
compute pattern is the same). Heads pad 25 -> 48 with kv 5 -> 6, vocab
32001 -> 32016.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    window=1024,
    pad_heads=48,
    pad_kv_heads=6,
    bias_kind="alibi",
    remat="full",
    grad_accum=8,
    notes="parallel attn+mamba heads; SWA everywhere (3 global-attn layers "
          "of the published model homogenized for the layer scan)",
)

SMOKE = CONFIG.replace(
    grad_accum=1,
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=128,
    window=32, pad_heads=0, pad_kv_heads=0, ssm_state=8,
    tp=1, remat="none", dtype="float32",
)

"""SwinV2-B window-attention stack — the paper's vision experiment (Sec. 4.3).

The FlashBias-relevant core of SwinV2-B at 384x384 / window 24: 24 layers of
WindowAttention over sequences of 576 tokens, each layer holding a learnable
relative-position bias table (heads x 576 x 576 worth of logical bias,
parameterized by relative offsets). FlashBias applies the SVD decomposition
to the trained tables (paper: last 8 layers, R=16..32 keeping >=99% energy).

The hierarchical patch-merging pyramid is orthogonal to the bias speedup and
is not modeled; ``window`` holds the per-window sequence length.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="swinv2-b",
    family="swin",
    n_layers=24,
    d_model=512,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2048,
    vocab=0,
    window=576,            # 24 x 24 window -> sequence length per window
    bias_kind="none",      # bias comes from the learnable table, not ALiBi
    bias_rank=16,
    tp=1,
    notes="paper Sec 4.3; SVD decomposition of learnable relpos tables",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, window=36,
    bias_rank=4, remat="none", dtype="float32",
)

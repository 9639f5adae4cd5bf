"""Transformer PDE solver with spatial-distance bias (Sec. 4.4, Table 5).

8 layers, 128 hidden channels, 8 heads, FFN 256; bias
f(x_i, x_j) = alpha_i * ||x_i - x_j||^2 with per-query learnable alpha
(the "adaptive mesh" weight). FlashBias uses the exact rank-9 decomposition
(Example 3.5) with alpha folded into phi_q — this is the configuration where
FlashBias is the ONLY method that trains at 32186 points (paper Table 5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pde-solver",
    family="pde",
    n_layers=8,
    d_model=128,
    n_heads=8,
    n_kv_heads=8,
    d_ff=256,
    vocab=0,
    coord_dim=3,
    bias_kind="sqdist",
    tp=1,
    notes="paper Sec 4.4; exact R=3d decomposition, learnable alpha",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
    remat="none", dtype="float32",
)

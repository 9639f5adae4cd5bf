"""Pairformer-lite — the paper's AlphaFold-3 experiment (Sec. 4.4, Table 6).

A faithful-in-structure reduction of AF3's Pairformer: single-representation
attention whose bias is PROJECTED FROM THE PAIR REPRESENTATION (the dynamic,
data-dependent bias that needs the paper's *neural decomposition*), plus
triangle-multiplication pair updates. 16 blocks, d_single=384, d_pair=128,
4 heads (AF3 pair-bias attention uses 4 heads; App. H Table 12: neural
factors R=96 per head, 3 linear layers with tanh).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pairformer-lite",
    family="pairformer",
    n_layers=16,
    d_model=384,
    n_heads=4,
    n_kv_heads=4,
    d_ff=1536,
    vocab=0,
    d_pair=128,
    bias_kind="pair",
    bias_rank=96,
    tp=1,
    notes="paper Sec 4.4; neural decomposition of pair-projected bias",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, d_pair=32,
    bias_rank=8, remat="none", dtype="float32",
)

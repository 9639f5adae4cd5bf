"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

24 layers, d_model 768, no FFN, vocab 50280, state 128
[arXiv:2405.21060]. d_inner = 2 * 768 = 1536 at head_dim 64 gives 24 SSM
heads, padded to 32 for TP=16; vocab pads 50280 -> 50288.

FlashBias does not apply here: there are no q k^T logits to bias. The SSD
decay mask is itself the structured low-rank attention surrogate. The
decode state is constant-size, so prompts are not bounded by ``max_len``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    bias_kind="none",
    grad_accum=4,
    notes="attention-free; FlashBias N/A (documented); SSD chunked scan",
)

SMOKE = CONFIG.replace(
    grad_accum=1,
    n_layers=2, d_model=64, vocab=128, ssm_state=16, ssm_head_dim=16,
    tp=1, remat="none", dtype="float32",
)

"""Models: the decoder LM (dense FlashBias-ALiBi and Mamba2 SSM families),
the Pairformer (training and serving), and the paper's SwinV2 window-attention stack and
PDE solver, behind the uniform ``Model`` interface."""
from repro_torch.models import (  # noqa: F401
    api, common, lm, pairformer, pde, ssd, swin)
from repro_torch.models.api import Model, get_model
from repro_torch.models.common import init_params

__all__ = ["api", "common", "lm", "pairformer", "pde", "ssd", "swin",
           "Model", "get_model", "init_params"]

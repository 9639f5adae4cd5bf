"""Models: the decoder LM (dense FlashBias-ALiBi and Mamba2 SSM families)
and the Pairformer serve path behind the uniform ``Model`` interface."""
from repro_torch.models import api, common, lm, pairformer, ssd  # noqa: F401
from repro_torch.models.api import Model, get_model
from repro_torch.models.common import init_params

__all__ = ["api", "common", "lm", "pairformer", "ssd", "Model", "get_model",
           "init_params"]

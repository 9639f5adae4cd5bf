"""Models: the dense decoder LM (FlashBias-ALiBi) and the Pairformer serve
path behind the uniform ``Model`` interface."""
from repro_torch.models import api, common, lm, pairformer  # noqa: F401
from repro_torch.models.api import Model, get_model
from repro_torch.models.common import init_params

__all__ = ["api", "common", "lm", "pairformer", "Model", "get_model",
           "init_params"]

"""Models: the dense decoder LM (FlashBias-ALiBi) behind the uniform
``Model`` interface."""
from repro_torch.models import api, common, lm  # noqa: F401
from repro_torch.models.api import Model, get_model
from repro_torch.models.common import init_params

__all__ = ["api", "common", "lm", "Model", "get_model", "init_params"]

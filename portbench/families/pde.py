"""The ``pde`` family (the paper's transformer PDE solver): how the
benchmark reaches it in the program, and the faults its cells can carry.

- ``WIDTHS``: each published width of a configuration file, and the
  program's config field that must equal it;
- ``matmul_params``: the yardstick's count of parameters that multiply an
  activation (for the model FLOPs);
- ``forward(cfg)``: the inference entry of a model that is not served;
- ``FAULTS``: ``state_unchanged`` (``faults.py``), ``half_batch`` (the
  loss sees half of each mesh's points and takes its mean over those) and
  ``answer_altered`` (the forward's answer for one point is moved by the
  answer's largest magnitude).
"""
from __future__ import annotations

from portbench import faults, yardstick

WIDTHS = {"n_layers": "n_layers", "d_model": "d_model",
          "n_heads": "n_heads", "n_kv_heads": "n_kv_heads",
          "head_dim": "resolved_head_dim",
          "d_ff": "d_ff", "coord_dim": "coord_dim",
          "compute_dtype": "dtype"}

matmul_params = yardstick.pde_matmul_params


def forward(cfg):
    """``f(params, coords) -> fields``: the program's ``pde.forward``,
    looked up at each call (so a planted fault is seen)."""
    from repro_torch.models import pde
    return lambda params, coords: pde.forward(params, coords, cfg)


def _half(batch: dict) -> dict:
    n = batch["coords"].shape[1] // 2
    return {k: v[:, :n] for k, v in batch.items()}


def _half_batch():
    from repro_torch.models import pde

    def make(inner):
        return lambda params, batch, cfg: inner(params, _half(batch), cfg)
    return faults.patched(pde, "regression_loss", make)


def _answer_altered():
    from repro_torch.models import pde

    def make(inner):
        def forward(params, coords, cfg):
            out = inner(params, coords, cfg).clone()
            out[:, 0] += out.abs().max()
            return out
        return forward
    return faults.patched(pde, "forward", make)


FAULTS = {"state_unchanged": faults.state_unchanged,
          "half_batch": _half_batch, "answer_altered": _answer_altered}

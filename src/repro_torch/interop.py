"""Carry the reference's parameters into the port.

The port's parameter tree has the reference's nested keys and stacked
shapes, so carrying a tree across is a dict copy: ``params_from_numpy``
takes nested dicts of numpy arrays (the reference's parameters after
``np.asarray`` on every leaf) and returns the port's tensors, checked
against the port's template; ``factors_from_numpy`` does the same for the
Pairformer's factor-MLP tree, and ``neural_decomp_from_numpy`` for the
neural decomposition's ``NeuralDecompParams`` (``jax.random`` has no torch
twin, so a parity test carries the reference's initial MLPs across).
Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.decomp import NeuralDecompParams
from repro_torch.models.api import get_model
from repro_torch.models.common import PDef, stack_layers
from repro_torch.models.pairformer import factor_mlp_template

__all__ = ["params_from_numpy", "factors_from_numpy",
           "neural_decomp_from_numpy"]


def _convert(tree, tmpl, device, dtype, path: str):
    if isinstance(tmpl, PDef):
        arr = np.asarray(tree)
        if arr.shape != tmpl.shape:
            raise ValueError(f"{path}: shape {arr.shape} != port template "
                             f"{tmpl.shape}")
        return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)
    if not isinstance(tree, dict) or set(tree) != set(tmpl):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{path or '<root>'}: keys {got} != port template "
                         f"{sorted(tmpl)}")
    return {k: _convert(tree[k], tmpl[k], device, dtype, f"{path}/{k}")
            for k in tmpl}


def params_from_numpy(tree: dict, cfg: ArchConfig, device="cuda",
                      dtype=torch.float32) -> dict:
    """The port's parameters for ``cfg`` from a nested dict of numpy arrays
    with the reference's keys and shapes."""
    return _convert(tree, get_model(cfg).template(), device, dtype, "")


def factors_from_numpy(tree: dict, cfg: ArchConfig, hidden: int = 256,
                       device="cuda", dtype=torch.float32) -> dict:
    """The port's factor-MLP parameters (Eq. 5) from a nested dict of numpy
    arrays, checked against the layer-stacked ``factor_mlp_template(cfg,
    hidden)`` that the serve path indexes per layer."""
    tmpl = stack_layers(factor_mlp_template(cfg, hidden), cfg.n_layers)
    return _convert(tree, tmpl, device, dtype, "")


def neural_decomp_from_numpy(tree, device="cuda",
                             dtype=torch.float32) -> NeuralDecompParams:
    """The port's ``NeuralDecompParams`` from the reference's (after
    ``np.asarray`` on every leaf) or from a dict with its fields
    (``q_layers``, ``k_layers``: sequences of ``(w, b)`` numpy arrays;
    ``heads``, ``rank``). Each MLP must chain (a layer's input width is the
    last one's output) and end at ``heads * rank``."""
    get = tree.get if isinstance(tree, dict) else (
        lambda key: getattr(tree, key))
    heads, rank = int(get("heads")), int(get("rank"))

    def mlp(name):
        layers, width = [], None
        for i, (w, b) in enumerate(get(name)):
            w, b = np.asarray(w), np.asarray(b)
            if w.ndim != 2 or b.shape != (w.shape[1],) or (
                    width is not None and w.shape[0] != width):
                raise ValueError(f"{name}[{i}]: w {w.shape}, b {b.shape} "
                                 f"after width {width}")
            width = w.shape[1]
            layers.append(tuple(
                torch.from_numpy(np.array(t)).to(device=device, dtype=dtype)
                for t in (w, b)))
        if width != heads * rank:
            raise ValueError(f"{name} ends at {width}, not heads x rank = "
                             f"{heads * rank}")
        return tuple(layers)

    return NeuralDecompParams(mlp("q_layers"), mlp("k_layers"), heads=heads,
                              rank=rank)

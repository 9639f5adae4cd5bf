"""Parameter templates and the layers shared by the models.

A model is described by a *template*: nested dicts whose leaves are ``PDef``
(shape + init law), the same shapes and laws as ``repro.models.common``.
``init_params`` materializes one with an explicit ``torch.Generator``; it
does not reproduce JAX's random bits (tests carry the reference's
parameters across with ``repro_torch.interop.params_from_numpy``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.bias import alibi_slopes

__all__ = ["PDef", "stack_layers", "materialize", "init_params",
           "tree_map", "compute_dtype", "rmsnorm", "swiglu", "gelu_mlp",
           "embed_lookup", "unembed_logits"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class PDef:
    """One parameter: shape + init law.

    init: ("normal", stddev) | ("zeros",) | ("ones",) | ("slopes", n_real)
    — "slopes" holds ALiBi slopes for the first ``n_real`` heads and zeros
    for the TP padding heads."""
    shape: tuple
    init: tuple = ("normal", 0.02)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_layers(layer_tmpl: dict, n_layers: int) -> dict:
    """Add a leading layers dim to every leaf."""
    return tree_map(lambda p: PDef((n_layers,) + p.shape, p.init), layer_tmpl)


def _materialize(pdef: PDef, generator: torch.Generator, device,
                 dtype) -> torch.Tensor:
    kind = pdef.init[0]
    if kind == "zeros":
        return torch.zeros(pdef.shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(pdef.shape, dtype=dtype, device=device)
    if kind == "slopes":
        n_real = pdef.init[1]
        s = torch.zeros(pdef.shape[-1], device=device)
        s[:n_real] = alibi_slopes(n_real, device=device)
        return s.expand(pdef.shape).to(dtype).contiguous()
    if kind == "normal":
        x = torch.randn(pdef.shape, generator=generator, device=device)
        return (pdef.init[1] * x).to(dtype)
    raise ValueError(pdef.init)


def materialize(tmpl: dict, generator: torch.Generator, device="cuda",
                dtype=torch.float32) -> dict:
    """Real tensors for a template, drawn from ``generator`` (which must
    live on ``device``) in a fixed leaf order."""
    return tree_map(lambda p: _materialize(p, generator, device, dtype), tmpl)


def init_params(cfg, generator: torch.Generator, device="cuda",
                dtype=torch.float32) -> dict:
    """Parameters of ``cfg``'s model (the template of ``get_model(cfg)``)."""
    from repro_torch.models.api import get_model
    return materialize(get_model(cfg).template(), generator, device, dtype)


def compute_dtype(cfg) -> torch.dtype:
    """The torch dtype of ``cfg.dtype`` (the compute dtype)."""
    return _DTYPES[cfg.dtype]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """float32 RMS norm times ``1 + scale``, cast back to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def swiglu(x: torch.Tensor, wi_fused: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN with the FUSED gate+up projection ``wi_fused (d, f, 2)``:
    gate at ``[..., 0]``, up at ``[..., 1]``."""
    d, f, _ = wi_fused.shape
    h2 = (x @ wi_fused.reshape(d, 2 * f)).unflatten(-1, (f, 2))
    return (F.silu(h2[..., 0]) * h2[..., 1]) @ wo


def gelu_mlp(x: torch.Tensor, wi: torch.Tensor,
             wo: torch.Tensor) -> torch.Tensor:
    """GELU FFN. ``jax.nn.gelu`` defaults to the tanh approximation, so the
    port asks for it by name (torch's default is the exact erf form)."""
    return F.gelu(x @ wi, approximate="tanh") @ wo


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: (B, S, D) @ (V, D)^T -> (B, S, V)."""
    return x @ table.T

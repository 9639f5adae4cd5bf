"""Transformer PDE solver with a learnable-scaled spatial-distance bias —
the paper's Sec. 4.4 / Table 5 model.

Port of ``repro.models.pde`` (forward and a differentiable loss). The bias is
``f(x_i, x_j) = -alpha_i * ||x_i - x_j||^2`` with ``alpha = softplus(coords
@ alpha_w + alpha_b)``, one per token and head, in float32. ``cfg.bias_mode``:

- ``"flashbias"`` — the exact rank-3d factors (Example 3.5) with alpha
  folded into ``phi_q (B, N, H, 3d)``; ``phi_k (B, N, 1, 3d)`` is shared by
  the heads. Both stay float32 into ``ops.flash_attention`` (kernel 1 on
  the card, phi mode, no mask); the N x N bias is never formed;
- ``"dense"`` — the ``(B, H, N, N)`` float32 bias materialized and added to
  the logits by the plain chunked ``attention`` (the paper's baseline,
  which runs out of memory at large N by design).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.attention import attention
from repro_torch.core.bias import scaled_sqdist_dense, sqdist_factors
from repro_torch.kernels import ops
from repro_torch.models.common import (PDef, compute_dtype, gelu_mlp,
                                       rmsnorm, stack_layers)
from repro_torch.spans import span

__all__ = ["pde_template", "forward", "regression_loss"]


def pde_template(cfg: ArchConfig) -> dict:
    d, h, f, cd = cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.coord_dim
    hd = cfg.resolved_head_dim
    layer = {
        "ln1": PDef((d,), (None,), ("zeros",)),
        "wqkv": PDef((d, 3, h, hd), ("fsdp", None, "heads", None)),
        "wo": PDef((h, hd, d), ("heads", None, "fsdp")),
        "alpha_w": PDef((cd, h), (None, "heads"), ("normal", 0.2)),
        "alpha_b": PDef((h,), ("heads",), ("ones",)),
        "ln2": PDef((d,), (None,), ("zeros",)),
        "wi": PDef((d, f), ("fsdp", "mlp")),
        "wo_mlp": PDef((f, d), ("mlp", "fsdp")),
    }
    return {
        "in_proj": PDef((cd, d), (None, "fsdp")),
        "layers": stack_layers(layer, cfg.n_layers),
        "final_norm": PDef((d,), (None,), ("zeros",)),
        "out_head": PDef((d, 4), ("fsdp", None)),   # pressure + 3 velocity
    }


def _pde_attention(lp: dict, x: torch.Tensor, coords: torch.Tensor,
                   cfg: ArchConfig) -> torch.Tensor:
    """x ``(B, N, D)``, coords ``(B, N, cd)``."""
    dt = x.dtype
    q, k, v = torch.einsum("bnd,dthe->tbnhe", x,
                           lp["wqkv"].to(dt)).unbind(0)   # (B, N, H, hd)
    c32 = coords.float()
    alpha = F.softplus(c32 @ lp["alpha_w"].float()
                       + lp["alpha_b"].float())           # (B, N, H)
    if cfg.bias_mode == "flashbias":
        pq0, pk0 = sqdist_factors(c32, c32, negate=True)  # (B, N, 3d)
        pq = alpha[..., None] * pq0[:, :, None, :]        # (B, N, H, 3d)
        o = ops.flash_attention(q, k, v, pq, pk0[:, :, None, :],
                                impl=cfg.attn_impl)
    else:
        bias = scaled_sqdist_dense(c32[:, None], c32[:, None],
                                   alpha.transpose(1, 2))  # (B, H, N, N)
        o = attention(q, k, v, bias=bias, impl="chunked",
                      chunk_size=cfg.attn_chunk)
    return torch.einsum("bnhe,hed->bnd", o, lp["wo"].to(dt))


def forward(params: dict, coords: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """coords ``(B, N, coord_dim)`` mesh points -> ``(B, N, 4)`` physics
    fields in the compute dtype."""
    with span("repro_torch.pde.forward"):
        dt = compute_dtype(cfg)
        x = coords.to(dt) @ params["in_proj"].to(dt)
        # one unbind per stacked leaf: its backward stacks the layers'
        # gradients once, where indexing per layer would fill and add a
        # gradient of the whole stack in every layer
        layers = {key: val.unbind(0) for key, val in params["layers"].items()}
        for i in range(cfg.n_layers):
            lp = {key: val[i] for key, val in layers.items()}
            x = x + _pde_attention(lp, rmsnorm(x, lp["ln1"]), coords, cfg)
            x = x + gelu_mlp(rmsnorm(x, lp["ln2"]), lp["wi"].to(dt),
                             lp["wo_mlp"].to(dt))
        x = rmsnorm(x, params["final_norm"])
        return x @ params["out_head"].to(dt)


def regression_loss(params: dict, batch: dict,
                    cfg: ArchConfig) -> torch.Tensor:
    """Mean squared error of ``forward`` against ``batch["targets"]``,
    differentiable: in flashbias mode the gradient reaches ``alpha_w`` /
    ``alpha_b`` through ``phi_q`` (Table 5's training through the factored
    bias)."""
    pred = forward(params, batch["coords"], cfg).float()
    return ((pred - batch["targets"].float()) ** 2).mean()

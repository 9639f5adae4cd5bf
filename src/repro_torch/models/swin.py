"""SwinV2-style window attention with a learnable relative-position bias —
the paper's vision experiment (Sec. 4.3).

Port of ``repro.models.swin`` (forward and a differentiable loss; training
uses the dense tables, as the reference's does). Each layer owns a
learnable ``(H, W, W)`` bias table; at inference FlashBias replaces it with
rank-R SVD factors computed offline (``svd_factorize``), which ride with
q/k through ``ops.flash_attention`` (kernel 1 on the card, phi mode, no
mask). ``cfg.bias_mode``:

- ``"dense"`` — the table is added to the logits in every layer (the
  official code's path, the paper's baseline): the plain chunked
  ``attention`` with ``bias=``;
- ``"flashbias"`` — with ``factors`` given, the SVD factors, rounded to the
  compute dtype as the reference rounds them, broadcast over the windows.
  Without factors the dense table is used (factors exist only for a
  trained model).

Tokens come window-partitioned ``(B, n_windows, W, 48)``, windows folded
into the batch, with a mean-pool classification head. The hierarchical
pyramid of real Swin is not modelled, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import decomp
from repro_torch.core.attention import attention
from repro_torch.kernels import ops
from repro_torch.models.common import (PDef, compute_dtype, gelu_mlp,
                                       rmsnorm, stack_layers)

__all__ = ["swin_template", "svd_factorize", "forward", "classify_loss"]


def swin_template(cfg: ArchConfig) -> dict:
    d, h, w, f = cfg.d_model, cfg.n_heads, cfg.window, cfg.d_ff
    hd = cfg.resolved_head_dim
    layer = {
        "ln1": PDef((d,), (None,), ("zeros",)),
        "wqkv": PDef((d, 3, h, hd), ("fsdp", None, "heads", None)),
        "wo": PDef((h, hd, d), ("heads", None, "fsdp")),
        # learnable relative-position bias table, one per window position
        "bias_table": PDef((h, w, w), ("heads", None, None), ("normal", 0.5)),
        "ln2": PDef((d,), (None,), ("zeros",)),
        "wi": PDef((d, f), ("fsdp", "mlp")),
        "wo_mlp": PDef((f, d), ("mlp", "fsdp")),
    }
    return {
        "patch_embed": PDef((48, d), (None, "fsdp")),   # 4x4x3 patch stub
        "layers": stack_layers(layer, cfg.n_layers),
        "final_norm": PDef((d,), (None,), ("zeros",)),
        "head": PDef((d, 1000), ("fsdp", None)),
    }


def svd_factorize(params: dict, rank: int) -> dict:
    """Offline SVD of every layer's bias table: ``{"phi_q": (L, H, W, R),
    "phi_k": (L, H, W, R)}`` in float32 (Table 1 row b). Run once per
    trained model."""
    pq, pk = decomp.svd_factors(params["layers"]["bias_table"], rank)
    return {"phi_q": pq, "phi_k": pk}


def _window_attention(lp: dict, x: torch.Tensor, cfg: ArchConfig,
                      factors_l: Optional[dict] = None) -> torch.Tensor:
    """x: ``(B*, W, D)`` with the windows folded into the batch."""
    dt = x.dtype
    q, k, v = torch.einsum("bwd,dthe->tbwhe", x,
                           lp["wqkv"].to(dt)).unbind(0)   # (B*, W, H, hd)
    if cfg.bias_mode == "flashbias" and factors_l is not None:
        bsz, w, h = q.shape[:3]
        pq, pk = (factors_l[key].to(dt).transpose(0, 1)[None].expand(
            bsz, w, h, -1) for key in ("phi_q", "phi_k"))
        o = ops.flash_attention(q, k, v, pq, pk, impl=cfg.attn_impl)
    else:
        o = attention(q, k, v, bias=lp["bias_table"][None].float(),
                      impl="chunked", chunk_size=cfg.attn_chunk)
    return torch.einsum("bwhe,hed->bwd", o, lp["wo"].to(dt))


def forward(params: dict, patches: torch.Tensor, cfg: ArchConfig,
            factors: Optional[dict] = None) -> torch.Tensor:
    """patches ``(B, n_win, W, 48)`` (raw patch pixels, the stub) -> logits
    ``(B, 1000)`` in the compute dtype. ``factors`` is ``svd_factorize``'s
    output (used in flashbias mode)."""
    b, nw, w, _ = patches.shape
    dt = compute_dtype(cfg)
    x = patches.to(dt) @ params["patch_embed"].to(dt)
    x = x.reshape(b * nw, w, cfg.d_model)
    # one unbind per stacked leaf: its backward stacks the layers'
    # gradients once, where indexing per layer would fill and add a
    # gradient of the whole stack in every layer
    layers = {key: val.unbind(0) for key, val in params["layers"].items()}
    per_layer = (None if factors is None
                 else {key: val.unbind(0) for key, val in factors.items()})
    for i in range(cfg.n_layers):
        lp = {key: val[i] for key, val in layers.items()}
        fl = (None if factors is None
              else {key: val[i] for key, val in per_layer.items()})
        x = x + _window_attention(lp, rmsnorm(x, lp["ln1"]), cfg, fl)
        x = x + gelu_mlp(rmsnorm(x, lp["ln2"]), lp["wi"].to(dt),
                         lp["wo_mlp"].to(dt))
    x = rmsnorm(x, params["final_norm"])
    pooled = x.reshape(b, nw * w, -1).mean(dim=1)
    return pooled @ params["head"].to(dt)


def classify_loss(params: dict, batch: dict, cfg: ArchConfig,
                  factors: Optional[dict] = None) -> torch.Tensor:
    """Mean cross-entropy of ``forward``'s logits against ``batch["labels"]``
    (differentiable)."""
    logits = forward(params, batch["patches"], cfg, factors).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"].long()[:, None])[:, 0]
    return (lse - gold).mean()

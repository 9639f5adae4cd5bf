"""Plain reference of the paper's transformer PDE solver (Sec. 4.4, Table
5; the ``pde`` family).

``x = coords W_in``; each layer adds softmax attention of
``rmsnorm(x)`` whose logits add the dense bias ``-alpha_ih ||x_i -
x_j||^2``, with ``alpha = softplus(coords A + a)`` per point and head, then
a GELU (tanh) MLP of ``rmsnorm(x)``; the output head maps the final-normed
state to 4 fields. The bias is formed from the distances themselves, not
from the rank-9 factors, one block of query rows at a time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.arith import Arith

BLOCK_ROWS = 1024


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) \
        * (1.0 + scale)


def _unbind(tree: dict) -> dict:
    """Per-layer views of the stacked leaves, in float32 (one unbind per
    leaf, so the backward stacks each leaf's gradient once)."""
    return {k: _unbind(v) if isinstance(v, dict) else v.float().unbind(0)
            for k, v in tree.items()}


def _at(tree: dict, i: int) -> dict:
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _block(qb, k, v, alpha_b, cb, c, a: Arith):
    """Attention of the query rows ``qb (B, H, r, hd)`` at points ``cb``."""
    d2 = (cb[:, :, None, :] - c[:, None, :, :]).square().sum(-1)
    bias = -alpha_b.transpose(1, 2)[..., None] * d2[:, None]
    logits = (a.q(qb) @ a.q(k).transpose(-1, -2)) / math.sqrt(qb.shape[-1])
    return a.q(torch.softmax(logits + bias, -1)) @ a.q(v)


def attention(lp: dict, h, coords, spec: dict, a: Arith, remat: bool):
    b, n, d = h.shape
    heads, hd = spec["n_heads"], spec["head_dim"]
    qkv = a.mm(h, lp["wqkv"].reshape(d, -1)).view(b, n, 3, heads, hd)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    alpha = F.softplus(coords @ lp["alpha_w"] + lp["alpha_b"])    # (B, N, H)
    parts = []
    for lo in range(0, n, BLOCK_ROWS):
        hi = min(n, lo + BLOCK_ROWS)
        args = (q[:, :, lo:hi], k, v, alpha[:, lo:hi], coords[:, lo:hi],
                coords, a)
        parts.append(checkpoint(_block, *args, use_reentrant=False)
                     if remat else _block(*args))
    o = torch.cat(parts, 2).transpose(1, 2).reshape(b, n, -1)
    return a.mm(o, lp["wo"].reshape(-1, d))


def forward(p: dict, coords: torch.Tensor, spec: dict, a: Arith,
            remat: bool = False) -> torch.Tensor:
    """coords ``(B, N, 3)`` -> fields ``(B, N, 4)``, float32."""
    coords = coords.float()
    x = a.q(a.mm(coords, p["in_proj"]))
    per_layer = _unbind(p["layers"])
    for i in range(spec["n_layers"]):
        lp = _at(per_layer, i)
        x = a.q(x + attention(lp, rmsnorm(x, lp["ln1"]), coords, spec, a,
                              remat))
        g = F.gelu(a.mm(rmsnorm(x, lp["ln2"]), lp["wi"]), approximate="tanh")
        x = a.q(x + a.mm(g, lp["wo_mlp"]))
    return a.mm(rmsnorm(x, p["final_norm"]), p["out_head"])


def loss(p: dict, batch: dict, spec: dict, a: Arith) -> torch.Tensor:
    """Mean squared error of the fields against ``batch["targets"]``."""
    pred = forward(p, batch["coords"], spec, a, remat=True)
    return (pred - batch["targets"].float()).square().mean()

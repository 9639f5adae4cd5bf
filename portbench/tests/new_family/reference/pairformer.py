"""Plain reference of the pairformer_lite trunk with factor MLPs: per
block the outgoing triangle multiplication, attention of the single rep
whose logits add ``phi_q phi_k^T`` of the factor MLPs, and the two
transitions. Nothing of the program."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _rms(x, scale):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) \
        * (1.0 + scale)


def _mlp(fp, x):
    y = torch.tanh(x @ fp["w0"] + fp["b0"])
    y = torch.tanh(y @ fp["w1"] + fp["b1"])
    return y @ fp["w2"] + fp["b2"]


def _at(tree, i):
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def forward(p, fac, feats, spec, dtype=torch.float32):
    """feats ``(B, N, 64)`` -> coordinates ``(B, N, 3)``, computed in
    ``dtype``."""
    p = {k: v if isinstance(v, dict) else v.to(dtype) for k, v in p.items()}
    h, r = spec["n_heads"], spec["bias_rank"]
    hd = spec["d_model"] // h
    x = feats.to(dtype)
    s = x @ p["single_in"]
    zp = x @ p["pair_in"]
    z = zp[:, :, None] + zp[:, None]
    n = z.shape[1]
    for i in range(spec["n_layers"]):
        lp = {k: v.to(dtype) for k, v in _at(p["layers"], i).items()}
        fl = {k: {kk: vv.to(dtype) for kk, vv in v.items()}
              for k, v in _at(fac, i).items()}
        zl = _rms(z, lp["tri_ln"])
        a = torch.sigmoid(zl @ lp["tri_g"]) * (zl @ lp["tri_a"])
        upd = torch.einsum("bikc,bjkc->bijc", a, zl @ lp["tri_b"])
        z = z + (upd / math.sqrt(n)) @ lp["tri_o"]
        hs = _rms(s, lp["ln1"])
        fx = torch.cat([z.mean(2) + z.mean(1), hs], -1)
        pq = _mlp(fl["q"], fx).unflatten(-1, (h, r))
        pk = _mlp(fl["k"], fx).unflatten(-1, (h, r))
        q, k, v = (hs @ lp["wqkv"].reshape(hs.shape[-1], -1)) \
            .unflatten(-1, (3, h, hd)).unbind(2)
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(hd) \
            + torch.einsum("bnhr,bmhr->bhnm", pq, pk)
        o = torch.einsum("bhnm,bmhd->bnhd", logits.softmax(-1), v)
        s = s + o.flatten(-2) @ lp["wo"].reshape(-1, s.shape[-1])
        s = s + F.gelu(_rms(s, lp["ln2"]) @ lp["wi"],
                       approximate="tanh") @ lp["wo_mlp"]
        z = z + F.gelu(_rms(z, lp["pair_ln"]) @ lp["pair_wi"],
                       approximate="tanh") @ lp["pair_wo"]
    return _rms(s, p["final_norm"]) @ p["out_head"]

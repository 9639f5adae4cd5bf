"""Pairformer-lite: attention with a pair-representation bias (AF3, the
paper's Sec. 4.4).

Port of ``repro.models.pairformer``: the training path (``forward``,
``denoise_loss``, ``fit_factor_mlps``) and the batched serve path. Per
block:

1. triangle multiplicative update (outgoing) on the pair rep ``z (B, N, N,
   Dp)``,
2. single-rep attention whose logits take an additive bias PROJECTED FROM
   ``z`` (the dynamic, per-sample bias of the paper's Table 1 row c),
3. transition MLPs on both representations.

A serve request is one complex, its ``(n_res, 64)`` residue features.
``serve_prefill`` (admission) runs the whole trunk once over a padded wave
and keeps, per layer, the attention's bias state in one of four forms:

- ``"svd"``   — truncated-SVD factors of the projected bias (the default
  served path; ``phi_q``/``phi_k (L, B, H, N, R)`` float32, ``R =
  min(bias_rank, N)``: head-major, the kernel's layout, where the reference
  keeps ``(L, B, N, H, R)``), attended through the ragged FlashBias kernel,
- ``"mlp"``   — the Eq. 5 factor-MLP outputs, same shapes at ``R =
  bias_rank`` (``factors=`` the fitted MLPs),
- ``"dense"`` — the projected bias itself ``(L, B, H, N, N)`` float32
  (``bias_mode="dense"``, the cached dense baseline),
- ``"pair"``  — the per-layer pair rep ``(L, B, N, N, Dp)``, re-projected
  at every step (``bias_mode="dense_recompute"``, the official AF3 dataflow
  and the paper's Table 6 baseline).

The two dense modes attend through the port's plain ``core.attention`` with
``bias=`` and ``kv_length=``, as the reference runs them through XLA.
``serve_step`` is one refinement iteration over the single rep of every
slot with the cached bias state; slots of length 0 are frozen.

Dtypes follow JAX's promotion of the reference at ``dtype="bfloat16"``
with float32 parameters: ``s`` stays in the compute dtype (its weights are
cast to it at use), ``z`` becomes float32 in the first triangle update (the
triangle and pair weights are not cast), the factor-MLP inputs concatenate
into float32, and the ``"pair"`` cache is stored in the compute dtype.
PyTorch refuses a mixed matmul that JAX promotes, so ``_mm`` promotes by
hand. (The reference's own ``serve_prefill`` cannot run at bfloat16: its
``lax.scan`` rejects the carry whose ``z`` turns float32; the port's layer
loop has no such constraint.)

Batching contract: every wave pads to the same ``N`` (the engine pins it to
``max_len``) and every op is batch-row independent, so a complex's result
is bit-identical whether it runs alone or with strangers at the same slot
count. ``insert_serve_cache_at_slots`` writes in place (the reference
returns new arrays) and drops out-of-range slot ids on the host.

Training: ``forward`` runs the layers in a Python loop (the reference
scans them) over residue features ``(B, N, 64)`` to ``(B, N, 3)``
coordinates. With ``bias_mode="flashbias"`` and fitted factor MLPs
(``factors=``) each layer's attention takes the MLPs' float32 factors
through ``ops.flash_attention`` (kernel 1 in phi mode on the card, R =
``bias_rank``); otherwise the projected dense bias goes through the plain
chunked ``core.attention``. ``denoise_loss`` is the mean squared error
against ``batch["coords"]``, differentiable in the trunk and in the factor
MLPs. ``fit_factor_mlps`` fits the factor MLPs to every layer's projected
bias with the trunk frozen (Eq. 5, plain Adam).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.attention import attention as core_attn
from repro_torch.core.decomp import adam_step, svd_factors
from repro_torch.kernels import ops
from repro_torch.models.common import (
    PDef,
    compute_dtype,
    gelu_mlp,
    rmsnorm,
    stack_layers,
    tree_map,
)

__all__ = ["pairformer_template", "factor_mlp_template", "cast_params",
           "forward", "denoise_loss", "fit_factor_mlps",
           "init_serve_cache", "serve_prefill", "serve_step",
           "insert_serve_cache_at_slots"]

# the weights the reference casts to the compute dtype at use
_CAST_TOP = ("single_in", "pair_in")
_CAST_LAYER = ("wqkv", "wo", "wi", "wo_mlp")


def pairformer_template(cfg: ArchConfig) -> dict:
    d, dp, h, f = cfg.d_model, cfg.d_pair, cfg.n_heads, cfg.d_ff
    hd = cfg.resolved_head_dim
    layer = {
        # triangle multiplicative update (outgoing)
        "tri_ln": PDef((dp,), (None,), ("zeros",)),
        "tri_a": PDef((dp, dp), (None, None)),
        "tri_b": PDef((dp, dp), (None, None)),
        "tri_g": PDef((dp, dp), (None, None)),
        "tri_o": PDef((dp, dp), (None, None)),
        # single attention with pair bias
        "ln1": PDef((d,), (None,), ("zeros",)),
        "wqkv": PDef((d, 3, h, hd), ("fsdp", None, "heads", None)),
        "wo": PDef((h, hd, d), ("heads", None, "fsdp")),
        "pair_bias_ln": PDef((dp,), (None,), ("zeros",)),
        "pair_bias_w": PDef((dp, h), (None, "heads")),
        # transitions
        "ln2": PDef((d,), (None,), ("zeros",)),
        "wi": PDef((d, f), ("fsdp", "mlp")),
        "wo_mlp": PDef((f, d), ("mlp", "fsdp")),
        "pair_ln": PDef((dp,), (None,), ("zeros",)),
        "pair_wi": PDef((dp, 4 * dp), (None, None)),
        "pair_wo": PDef((4 * dp, dp), (None, None)),
    }
    return {
        "single_in": PDef((64, d), (None, "fsdp")),      # residue-feature stub
        "pair_in": PDef((64, dp), (None, None)),
        "layers": stack_layers(layer, cfg.n_layers),
        "final_norm": PDef((d,), (None,), ("zeros",)),
        "out_head": PDef((d, 3), ("fsdp", None)),   # coordinate denoise stub
    }


def factor_mlp_template(cfg: ArchConfig, hidden: int = 256) -> dict:
    """Token-wise factor MLPs (App. H Table 12): 3 linear layers, tanh."""
    h, r = cfg.n_heads, cfg.bias_rank
    din = cfg.d_pair + cfg.d_model          # row/col pair summary + single

    def mlp():
        return {
            "w0": PDef((din, hidden), (None, None)),
            "b0": PDef((hidden,), (None,), ("zeros",)),
            "w1": PDef((hidden, hidden), (None, None)),
            "b1": PDef((hidden,), (None,), ("zeros",)),
            "w2": PDef((hidden, h * r), (None, None)),
            "b2": PDef((h * r,), (None,), ("zeros",)),
        }
    return {"q": mlp(), "k": mlp()}


def cast_params(params: dict, cfg: ArchConfig) -> dict:
    """The tree with the weights the reference casts at use (``single_in``,
    ``pair_in``, ``wqkv``, ``wo``, ``wi``, ``wo_mlp``) cast to the compute
    dtype once; the others stay as they are. Serving casts once with this;
    the model functions then find nothing left to cast."""
    dt = compute_dtype(cfg)
    out = dict(params)
    for key in _CAST_TOP:
        out[key] = params[key].to(dt)
    out["layers"] = {k: (v.to(dt) if k in _CAST_LAYER else v)
                     for k, v in params["layers"].items()}
    return out


def _layer(tree: dict, i: int) -> dict:
    return tree_map(lambda x: x[i], tree)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.matmul`` does."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _factor_apply(fp: dict, x: torch.Tensor, heads: int, rank: int):
    y = torch.tanh(x @ fp["w0"] + fp["b0"])
    y = torch.tanh(y @ fp["w1"] + fp["b1"])
    y = y @ fp["w2"] + fp["b2"]
    return y.unflatten(-1, (heads, rank))


def _triangle_update(lp: dict, z: torch.Tensor) -> torch.Tensor:
    """Outgoing triangle multiplicative update: z_ij += sum_k a_ik * b_jk."""
    zl = rmsnorm(z, lp["tri_ln"])
    a = torch.sigmoid(_mm(zl, lp["tri_g"])) * _mm(zl, lp["tri_a"])
    b = _mm(zl, lp["tri_b"])
    upd = torch.einsum("bikc,bjkc->bijc", a, b) / float(np.sqrt(z.shape[2]))
    return z + _mm(upd, lp["tri_o"])


def _pair_bias(lp: dict, z: torch.Tensor) -> torch.Tensor:
    """Project the pair rep to a per-head additive bias ``(B, H, N, N)``."""
    zb = rmsnorm(z, lp["pair_bias_ln"])
    return _mm(zb, lp["pair_bias_w"]).permute(0, 3, 1, 2)


def _factor_inputs(z: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Row/col pair summaries + single rep (App. H Table 12)."""
    row = z.mean(dim=2)            # (B, N, Dp)
    col = z.mean(dim=1)            # (B, N, Dp)
    return torch.cat([row + col, s], dim=-1)     # promotes, as JAX does


def _transition(lp: dict, s: torch.Tensor) -> torch.Tensor:
    dt = s.dtype
    return s + gelu_mlp(rmsnorm(s, lp["ln2"]), lp["wi"].to(dt),
                        lp["wo_mlp"].to(dt))


def _attend_cached(lp: dict, s: torch.Tensor, bias_state, cfg: ArchConfig,
                   lengths: torch.Tensor) -> torch.Tensor:
    """One pair-biased attention over the single rep from CACHED bias state
    (a factor pair, or a dense bias) — shared by admission and the serve
    step, so the two cannot diverge. q/k/v are projected head-major
    ``(B, H, N, hd)``, the kernel's layout, as the factors are stored."""
    dt = s.dtype
    h = rmsnorm(s, lp["ln1"])
    w = lp["wqkv"].to(dt)
    qkv = (h @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])
    q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous()     # (B, H, N, hd)
    if isinstance(bias_state, tuple):
        pq, pk = bias_state                               # (B, H, N, R) f32
        o = ops.flash_attention(q, k, v, pq, pk, impl=cfg.attn_impl,
                                layout="bhsd", lengths=lengths)
        o = o.transpose(1, 2)
    else:
        o = core_attn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      bias=bias_state, kv_length=lengths, impl="chunked",
                      chunk_size=cfg.attn_chunk)
    wo = lp["wo"].to(dt)
    return s + o.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _pair_transition(lp: dict, z: torch.Tensor) -> torch.Tensor:
    return z + gelu_mlp(rmsnorm(z, lp["pair_ln"]), lp["pair_wi"],
                        lp["pair_wo"])


def _unbound(tree: dict, n_layers: int) -> list:
    """The per-layer trees of a layer-stacked tree, through one ``unbind``
    per leaf: the backward then stacks each leaf's gradient once, where
    indexing the stack per layer would fill and add a gradient of the
    whole stack in every layer."""
    split = tree_map(lambda x: x.unbind(0), tree)
    return [tree_map(lambda x: x[i], split) for i in range(n_layers)]


def _single_attention(lp: dict, s: torch.Tensor, z: torch.Tensor,
                      cfg: ArchConfig, factors_l=None) -> torch.Tensor:
    """One pair-biased attention of the training path. With
    ``bias_mode="flashbias"`` and the layer's factor MLPs, their float32
    factors ride with q and k through ``ops.flash_attention`` (no ragged
    lengths: every residue is real); otherwise the projected dense bias is
    added by the plain chunked attention."""
    if cfg.bias_mode == "flashbias" and factors_l is not None:
        fx = _factor_inputs(z, rmsnorm(s, lp["ln1"])).float()
        state = tuple(
            _factor_apply(factors_l[key], fx, cfg.n_heads,
                          cfg.bias_rank).float().transpose(1, 2)
            for key in ("q", "k"))                      # (B, H, N, R)
    else:
        state = _pair_bias(lp, z).float()
    return _attend_cached(lp, s, state, cfg, None)


def _embed(params: dict, feats: torch.Tensor, cfg: ArchConfig):
    """The single rep and the outer-sum pair rep of residue features."""
    dt = compute_dtype(cfg)
    f = feats.to(dt)
    s = f @ params["single_in"].to(dt)
    z = f @ params["pair_in"].to(dt)
    return s, z[:, :, None, :] + z[:, None, :, :]


def forward(params: dict, feats: torch.Tensor, cfg: ArchConfig,
            factors: Optional[dict] = None) -> torch.Tensor:
    """feats ``(B, N, 64)`` residue features (the stub) -> ``(B, N, 3)``
    coordinates in the compute dtype. ``factors``: the layer-stacked factor
    MLPs (``factor_mlp_template``), used in flashbias mode."""
    dt = compute_dtype(cfg)
    s, z = _embed(params, feats, cfg)
    layers = _unbound(params["layers"], cfg.n_layers)
    fls = (_unbound(factors, cfg.n_layers) if factors is not None
           else [None] * cfg.n_layers)
    for lp, fl in zip(layers, fls):
        z = _triangle_update(lp, z)
        s = _single_attention(lp, s, z, cfg, fl)
        s = _transition(lp, s)
        z = _pair_transition(lp, z)
    s = rmsnorm(s, params["final_norm"])
    return s @ params["out_head"].to(dt)


def denoise_loss(params: dict, batch: dict, cfg: ArchConfig,
                 factors: Optional[dict] = None) -> torch.Tensor:
    """Mean squared error of ``forward``'s coordinates against
    ``batch["coords"] (B, N, 3)``, in float32."""
    pred = forward(params, batch["feats"], cfg, factors).float()
    return ((pred - batch["coords"].float()) ** 2).mean()


def fit_factor_mlps(params: dict, factor_params: dict,
                    sample_feats: torch.Tensor, cfg: ArchConfig, *,
                    steps: int = 300, lr: float = 1e-3, gen=None):
    """The paper's fine-tuning (Eq. 5): fit every layer's factor MLPs so
    that ``phi_q phi_k^T`` matches the layer's projected pair bias on
    ``sample_feats``, the trunk frozen. The trunk is replayed once with
    the dense attention (as the reference replays it, whatever the bias
    mode), and each layer's target bias and factor inputs kept; the loss
    is the mean over layers of each layer's mean squared error. Plain Adam
    (``core.decomp.adam_step``, the step count in float32). ``gen`` stands
    where the reference takes a PRNG key, which it never reads: the fit
    draws nothing at random.
    Returns (the fitted factor tree, the loss of every step as floats)."""
    del gen
    dense = cfg.replace(bias_mode="dense")
    ctxs = []
    with torch.no_grad():
        s, z = _embed(params, sample_feats, cfg)
        for lp in _unbound(params["layers"], cfg.n_layers):
            z = _triangle_update(lp, z)
            ctxs.append((_pair_bias(lp, z),
                         _factor_inputs(z, rmsnorm(s, lp["ln1"])).float()))
            s = _single_attention(lp, s, z, dense)
            s = _transition(lp, s)
            z = _pair_transition(lp, z)

    def loss_fn(fp: dict) -> torch.Tensor:
        total = 0.0
        for (target, fx), fl in zip(ctxs, _unbound(fp, cfg.n_layers)):
            pq, pk = (_factor_apply(fl[key], fx, cfg.n_heads, cfg.bias_rank)
                      for key in ("q", "k"))
            pred = torch.einsum("bnhr,bmhr->bhnm", pq, pk)
            total = total + ((pred - target) ** 2).mean()
        return total / len(ctxs)

    names = [(key, w) for key in ("q", "k") for w in factor_params[key]]
    p = [factor_params[key][w].detach().clone() for key, w in names]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]

    def tree(leaves) -> dict:
        out = {"q": {}, "k": {}}
        for (key, w), t in zip(names, leaves):
            out[key][w] = t
        return out

    losses = []
    for step in range(1, steps + 1):
        leaves = [t.requires_grad_(True) for t in p]
        loss = loss_fn(tree(leaves))
        grads = torch.autograd.grad(loss, leaves)
        adam_step(p, mu, nu, grads, torch.tensor(
            float(step), dtype=torch.float32, device=p[0].device), lr)
        losses.append(float(loss.detach()))
    return tree(p), losses


def _serve_mode(cfg: ArchConfig, factors) -> str:
    if cfg.bias_mode == "dense":
        return "dense"
    if cfg.bias_mode == "dense_recompute":
        return "pair"
    return "mlp" if factors is not None else "svd"


def _serve_rank(cfg: ArchConfig, n: int, mode: str) -> int:
    """Factor width of the serve cache: the factor MLPs emit exactly
    ``bias_rank`` columns, but an SVD of an (n, n) bias has at most n."""
    return cfg.bias_rank if mode == "mlp" else min(cfg.bias_rank, n)


def init_serve_cache(cfg: ArchConfig, batch: int, max_len: int,
                     factors=None, *, device="cuda") -> dict:
    """Zeroed pair slot cache. ``length`` doubles as the active mask (0 =
    retired slot, frozen by ``serve_step``). ``factors`` only selects the
    factor width; the fitted parameters are not read here."""
    dt = compute_dtype(cfg)
    ln, h, d = cfg.n_layers, cfg.n_heads, cfg.d_model
    f32 = torch.float32
    cache = {"s": torch.zeros((batch, max_len, d), dtype=dt, device=device),
             "length": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}
    mode = _serve_mode(cfg, factors)
    if mode == "dense":
        cache["bias"] = torch.zeros((ln, batch, h, max_len, max_len),
                                    dtype=f32, device=device)
    elif mode == "pair":
        cache["z"] = torch.zeros((ln, batch, max_len, max_len, cfg.d_pair),
                                 dtype=dt, device=device)
    else:
        r = _serve_rank(cfg, max_len, mode)
        for key in ("phi_q", "phi_k"):
            cache[key] = torch.zeros((ln, batch, h, max_len, r), dtype=f32,
                                     device=device)
    return cache


def serve_prefill(params: dict, batch: dict, cfg: ArchConfig, factors=None,
                  *, max_len: Optional[int] = None,
                  lengths: Optional[torch.Tensor] = None):
    """Admission trunk pass over a padded wave of complexes.

    batch: ``{"feats": (B, N_pad, 64)}`` with rows zero-padded past each
    complex's n_res; ``lengths (B,)`` the true n_res (0 for padding rows).
    Returns ``(None, wave_cache)``; the wave rows go into the slot cache
    through ``insert_serve_cache_at_slots``. (``max_len`` is accepted for
    the ``Model`` interface; the wave's own width ``N_pad`` is used.)"""
    feats = batch["feats"]
    b, n = feats.shape[0], feats.shape[1]
    dt, dev = compute_dtype(cfg), feats.device
    if lengths is None:
        lengths = torch.full((b,), n, dtype=torch.int32, device=dev)
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
    mode = _serve_mode(cfg, factors)

    valid = torch.arange(n, device=dev)[None, :] < lengths[:, None]  # (B, N)
    f = feats.to(dt)
    s = (f @ params["single_in"].to(dt)).masked_fill(~valid[..., None], 0)
    z = f @ params["pair_in"].to(dt)
    z = z[:, :, None, :] + z[:, None, :, :]
    # zero the pair rep outside the valid n_res x n_res block once: the
    # triangle update contracts over ALL k, so padded k would contaminate
    # valid entries. Zeroed here it STAYS zero (rmsnorm(0) = 0 kills the
    # triangle gates; the pair transition has no biases).
    z = z.masked_fill(~(valid[:, :, None] & valid[:, None, :])[..., None], 0)

    states = []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        z = _triangle_update(lp, z)
        if mode == "mlp":
            fl = _layer(factors, i)
            fx = _factor_inputs(z, rmsnorm(s, lp["ln1"])).float()
            # (B, N, H, R) each -> head-major (B, H, N, R)
            state = tuple(
                _factor_apply(fl[key], fx, cfg.n_heads,
                              cfg.bias_rank).transpose(1, 2)
                for key in ("q", "k"))
        elif mode == "svd":
            bias = _pair_bias(lp, z).float()
            # (B, H, N, R) each, head-major as the cache keeps them
            state = svd_factors(bias, _serve_rank(cfg, n, mode))
        elif mode == "pair":
            state = z                  # post-triangle z, as forward() uses
        else:
            state = _pair_bias(lp, z).float()
        attn_state = _pair_bias(lp, state).float() if mode == "pair" else state
        s = _attend_cached(lp, s, attn_state, cfg, lengths)
        s = _transition(lp, s)
        z = _pair_transition(lp, z)
        states.append(state)

    cache = {"s": s, "length": lengths}
    if mode == "dense":
        cache["bias"] = torch.stack(states)
    elif mode == "pair":
        cache["z"] = torch.stack(states)
    else:
        cache["phi_q"] = torch.stack([pq for pq, _ in states])
        cache["phi_k"] = torch.stack([pk for _, pk in states])
    return None, cache


def serve_step(params: dict, cache: dict, cfg: ArchConfig) -> dict:
    """One refinement iteration over every slot: all L layers of single-rep
    attention with the CACHED per-layer bias state (no triangle update, no
    factor recompute — those were paid once at admission), then the
    transition. Slots of length 0 are frozen. Returns a new dict sharing
    the bias state."""
    s0, lengths = cache["s"], cache["length"]
    s = s0
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if "bias" in cache:
            state = cache["bias"][i]
        elif "z" in cache:             # official dataflow: project at use
            state = _pair_bias(lp, cache["z"][i]).float()
        else:
            state = (cache["phi_q"][i], cache["phi_k"][i])
        s = _attend_cached(lp, s, state, cfg, lengths)
        s = _transition(lp, s)
    active = (lengths > 0)[:, None, None]
    return {**cache, "s": torch.where(active, s, s0)}


def insert_serve_cache_at_slots(dst: dict, src: dict, slots) -> dict:
    """Copy prefilled wave rows of ``src`` into slots of ``dst``, in place.
    ``s``/``length`` lead with the batch axis; the bias state leads with the
    layer axis (the slot axis second). ``slots[i]`` is wave row i's slot;
    out-of-range ids (padding rows) are dropped on the host, so no such
    index reaches the device."""
    n_slots = dst["length"].shape[0]
    pairs = [(i, int(s)) for i, s in enumerate(slots) if 0 <= int(s) < n_slots]
    if not pairs:
        return dst
    dev = dst["length"].device
    src_rows = torch.tensor([i for i, _ in pairs], device=dev)
    dst_rows = torch.tensor([s for _, s in pairs], device=dev)
    for key, v in dst.items():
        if key in ("s", "length"):
            v[dst_rows] = src[key][src_rows].to(v.dtype)
        else:
            v[:, dst_rows] = src[key][:, src_rows].to(v.dtype)
    return dst

"""Parameter templates and the layers shared by the models.

A model is described by a *template*: nested dicts whose leaves are ``PDef``
(shape + logical sharding axes + init law), the same shapes, axes and laws
as ``repro.models.common``. ``init_params`` materializes one with an
explicit ``torch.Generator``; it does not reproduce JAX's random bits
(tests carry the reference's parameters across with
``repro_torch.interop.params_from_numpy``). ``param_specs`` resolves the
axes against a mesh and ``shard_params`` places a parameter tree on it as
DTensors (the reference's ``param_specs`` / ``param_shardings``).
``TrainLayout`` is the masters' placement for sharded training: each
rank's FSDP and tensor-parallel shard as a plain local tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.bias import alibi_slopes

__all__ = ["PDef", "stack_layers", "materialize", "init_params",
           "template_map", "param_specs", "shard_params", "train_template",
           "TrainLayout",
           "tree_map", "tree_zip_map", "tree_leaves", "compute_dtype", "cast_floats",
           "param_bytes", "count_params", "rmsnorm", "swiglu", "gelu_mlp",
           "embed_lookup", "unembed_logits", "cross_entropy_loss",
           "apply_rope"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class PDef:
    """One parameter: shape + logical axes (one per dim, ``None`` for a
    replicated dim; ``repro_torch.dist.sharding``) + init law.

    init: ("normal", stddev) | ("zeros",) | ("ones",) | ("slopes", n_real)
    — "slopes" holds ALiBi slopes for the first ``n_real`` heads and zeros
    for the TP padding heads."""
    shape: tuple
    axes: tuple
    init: tuple = ("normal", 0.02)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"PDef: {len(self.axes)} axes {self.axes} for "
                             f"shape {self.shape}")


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_zip_map(fn, *trees):
    """``fn`` over matching leaves of nested dicts with one structure (the
    first tree's keys)."""
    if isinstance(trees[0], dict):
        return {k: tree_zip_map(fn, *(t[k] for t in trees))
                for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in sorted-key order (the order JAX
    flattens a dict in)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def stack_layers(layer_tmpl: dict, n_layers: int) -> dict:
    """Add a leading layers dim (logical axis ``"layers"``, never sharded by
    the default rules) to every leaf."""
    return tree_map(lambda p: PDef((n_layers,) + p.shape,
                                   ("layers",) + p.axes, p.init), layer_tmpl)


def template_map(fn, tmpl: dict, tree: dict, path: tuple = ()) -> dict:
    """``fn(pdef, leaf, path)`` over a template and a tree of its shape
    (``path`` the leaf's keys from the root)."""
    if isinstance(tmpl, dict):
        return {k: template_map(fn, tmpl[k], tree[k], path + (k,))
                for k in tmpl}
    return fn(tmpl, tree, path)


def param_specs(tmpl: dict, mesh, rules) -> dict:
    """Each leaf's ``spec_for`` its logical axes on ``mesh``."""
    from repro_torch.dist.sharding import spec_for
    return tree_map(lambda p: spec_for(p.axes, mesh, rules), tmpl)


def shard_params(params: dict, tmpl: dict, mesh, rules) -> dict:
    """The tree as DTensors on ``mesh``, each leaf placed by its template
    axes (``shard_put``: a dim that does not divide its mesh axes is
    replicated). Every rank holds the same full tree (one seed) and keeps
    its own shards, with no collective."""
    from repro_torch.dist.sharding import shard_put
    return template_map(lambda p, x, _: shard_put(x, mesh, rules, p.axes),
                        tmpl, params)


# the tensor-parallel logical axes (split over ``model`` by default)
TP_AXES = ("heads", "kv_heads", "mlp", "vocab", "expert")


def train_template(tmpl: dict, in_ssm: bool = False) -> dict:
    """The template with the axes of the masters' training layout: every
    axis kept (``fsdp`` and the tensor-parallel ones), except that the SSM
    branch (``"ssm"`` subtrees) keeps only ``fsdp``: it runs whole on every
    ``model`` rank, as it serves (ROADMAP.md Queue C)."""
    if isinstance(tmpl, dict):
        return {k: train_template(v, in_ssm or k == "ssm")
                for k, v in tmpl.items()}
    if not in_ssm:
        return tmpl
    return PDef(tmpl.shape, tuple(None if a in TP_AXES else a
                                  for a in tmpl.axes), tmpl.init)


class TrainLayout:
    """Where a sharded training run keeps each float32 master, and what
    its step must sum (the reference's ``param_shardings`` and
    ``grad_shardings`` under ``use_mesh_rules``).

    ``rules`` are the given ones with every logical axis that some leaf
    cannot split evenly replicated for all leaves (``dist.even_rules``);
    ``specs`` the per-leaf ``degraded_spec`` of ``train_template(tmpl)``;
    ``split_axes`` the mesh axes each leaf is split on (the gradient norm
    sums its squares over those); ``sum_axes`` the mesh axes its gradient
    is summed over after the backward (``dist.grad_sum_axes``), both
    without the axes of one rank; ``n_batch`` the ranks holding different
    rows. ``fsdp`` must resolve inside ``batch``: an FSDP reduce-scatter
    sums the gradients of different rows only there."""

    def __init__(self, tmpl: dict, mesh, rules):
        from repro_torch.dist.sharding import (
            degraded_spec, even_rules, grad_sum_axes, mesh_axis_sizes,
            spec_for, split_axes)
        self.template = train_template(tmpl)
        self.mesh = mesh
        self.rules = even_rules(((p.shape, p.axes)
                                 for p in tree_leaves(self.template)),
                                mesh, rules)
        fsdp = spec_for(("fsdp",), mesh, self.rules)[0] or ()
        batch = spec_for(("batch",), mesh, self.rules)[0] or ()
        if not set(fsdp) <= set(batch):
            raise ValueError(f"fsdp mesh axes {fsdp} outside the batch mesh "
                             f"axes {batch}: an FSDP gradient would sum "
                             f"ranks that hold the same rows")
        self.specs = tree_map(lambda p: degraded_spec(p.shape, p.axes, mesh,
                                                      self.rules),
                              self.template)
        sizes = mesh_axis_sizes(mesh)

        def real(axes):       # the axes of more than one rank, mesh order
            return tuple(a for a in sizes if a in axes and sizes[a] > 1)
        self.split_axes = tree_map(lambda s: real(split_axes(s)), self.specs)
        self.sum_axes = tree_map(lambda p: real(grad_sum_axes(
            p.shape, p.axes, mesh, self.rules)), self.template)
        self.n_batch = int(np.prod([sizes[a] for a in batch]))

    def shard(self, params: dict) -> dict:
        """Each rank's local shards of the full tree every rank made from
        one seed (no collective)."""
        return tree_map(lambda d: d.to_local(), shard_params(
            params, self.template, self.mesh, self.rules))

    def dtensors(self, tree):
        """DTensor views (no copy) of a tree of local shards: every dict of
        the masters' structure (the masters, the optimizer's moments) by
        the masters' placements, any other tensor replicated. Tuples,
        lists and dataclasses (``OptState``) are walked."""
        from torch.distributed.tensor import DTensor, Replicate
        from repro_torch.dist.sharding import placements_for

        def view(t, spec):
            return DTensor.from_local(t.detach(), self.mesh,
                                      placements_for(spec, self.mesh),
                                      run_check=False)

        def replicated(t):
            return DTensor.from_local(t.detach(), self.mesh,
                                      [Replicate()] * self.mesh.ndim,
                                      run_check=False)

        def masters(d):
            return (tree_zip_map(view, d, self.specs)
                    if _same_keys(d, self.specs) else None)
        return _walk(tree, replicated, masters)

    @staticmethod
    def local(tree):
        """The tree with every DTensor leaf replaced by its local shard."""
        from torch.distributed.tensor import DTensor
        return _walk(tree, lambda t: t.to_local() if isinstance(t, DTensor)
                     else t, lambda d: None)


def _same_keys(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_keys(a[k], b[k])
                                            for k in a)
    return not isinstance(a, dict) and not isinstance(b, dict)


def _walk(tree, leaf_fn, dict_fn):
    """``leaf_fn`` over the tensors of nested dicts, tuples, lists and
    dataclasses; ``dict_fn(d)``, where not None, replaces a whole dict."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        whole = dict_fn(tree)
        if whole is not None:
            return whole
        return {k: _walk(v, leaf_fn, dict_fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(v, leaf_fn, dict_fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _walk(getattr(tree, f.name), leaf_fn, dict_fn)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, torch.Tensor):
        return leaf_fn(tree)
    return tree


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


def cast_floats(tree, dtype):
    """Every floating-point tensor of ``tree`` cast to ``dtype`` (a torch
    dtype or its name); other leaves pass through."""
    dt = _DTYPES.get(dtype, dtype)
    return tree_map(lambda x: x.to(dt) if x.is_floating_point() else x, tree)


def param_bytes(tmpl) -> int:
    """Bytes of a template's parameters as float32 masters (the port keeps
    every master in float32, the reference's ``PDef`` default)."""
    return 4 * count_params(tmpl)


def count_params(tmpl) -> int:
    """Number of scalars in a template (padding included)."""
    return sum(int(np.prod(p.shape)) for p in tree_leaves(tmpl))


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


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       vocab_real: int) -> torch.Tensor:
    """Mean next-token cross-entropy in float32. The padded vocab rows
    (``>= vocab_real``) get -1e30, as in the reference: labels never point
    at them, but they would otherwise take softmax mass. The gold logit is
    gathered, no one-hot is made."""
    logits = logits.float()
    if vocab_real < logits.shape[-1]:
        pad = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(pad >= vocab_real, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10000.0) -> torch.Tensor:
    """RoPE on (B, S, H, D) with positions (B, S), rotating the two halves
    of D. Kept, as in the reference, for the multiplicative-bias extension;
    the LM configs use FlashBias-ALiBi."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freqs                 # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)

"""SVD and neural decompositions of attention biases (Table 1, rows b & c).

Port of ``repro.core.decomp``:

- ``svd_factors``: truncated SVD of a dense bias table (SwinV2's relative-
  position tables, the Pairformer's projected pair bias), at a given rank
  or at the rank that keeps a share of the singular-value energy;
- the neural decomposition (Eq. 5): token-wise factor MLPs ``phi_q``,
  ``phi_k`` (three linear layers with tanh between, App. H Table 12)
  fitted by ``fit_neural_decomposition`` so that ``phi_q(x_q) phi_k(x_k)^T``
  approximates a bias ``f(x_q, x_k)`` with no closed-form factors (the
  gravity and spherical-distance biases of App. G);
- ``reconstruction_error``.

The parameters are a ``NeuralDecompParams`` dataclass of float32 tensors,
made from an explicit ``torch.Generator``. ``jax.random`` has no torch
twin, so parity with the reference carries its parameters across
(``repro_torch.interop.neural_decomp_from_numpy``).

SVD factors are unique only up to sign, and up to rotation inside
near-tied singular values: compare ``phi_q @ phi_k^T``, never the factors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import lowrank

__all__ = ["svd_factors", "reconstruction_error", "NeuralDecompParams",
           "neural_decomp_init", "neural_decomp_apply", "predicted_bias",
           "fit_neural_decomposition", "adam_step"]


# ---------------------------------------------------------------------------
# SVD decomposition
# ---------------------------------------------------------------------------

def svd_factors(table: torch.Tensor, rank: Optional[int] = None,
                energy: float = 0.99) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-R factors of a (batched) dense bias table.

    table: ``(..., N, M)``. Returns ``phi_q (..., N, R)`` and ``phi_k (...,
    M, R)`` in float32 with ``phi_q @ phi_k^T`` the best rank-R
    approximation (Eckart-Young), ``R = min(rank, N, M)``. With ``rank``
    None, R is the smallest rank keeping ``energy`` of the squared singular
    values (Remark 3.8), the largest over the batch, so every slice meets
    the target. The singular values are split evenly (square root) between
    the two factors, which keeps their magnitudes balanced for the kernels
    downstream.

    A matrix holding NaN or Inf gets NaN factors, as the reference's SVD
    gives (``torch.linalg.svd`` would raise instead): the serve engine's
    admission guard then sees them. The check stays on the device."""
    mat = table.float()
    finite = torch.isfinite(mat)
    clean = torch.where(finite, mat, 0.0)
    if rank is None:
        rank = lowrank.rank_for_energy(clean, energy)
    u, s, vh = torch.linalg.svd(clean, full_matrices=False)
    r = int(min(rank, s.shape[-1]))
    sq = torch.sqrt(s[..., :r])
    phi_q = u[..., :, :r] * sq[..., None, :]
    phi_k = vh[..., :r, :].transpose(-1, -2) * sq[..., None, :]
    bad = ~finite.flatten(-2).all(dim=-1)[..., None, None]
    nan = torch.full((), float("nan"), device=mat.device)
    return torch.where(bad, nan, phi_q), torch.where(bad, nan, phi_k)


def reconstruction_error(table: torch.Tensor, phi_q: torch.Tensor,
                         phi_k: torch.Tensor) -> float:
    """Relative Frobenius error of ``phi_q @ phi_k^T`` against ``table``."""
    approx = phi_q @ phi_k.transpose(-1, -2)
    num = torch.linalg.vector_norm((approx - table).flatten())
    den = torch.linalg.vector_norm(table.flatten())
    return float(num / den.clamp(min=1e-30))


# ---------------------------------------------------------------------------
# Neural decomposition (Eq. 5): token-wise factor MLPs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NeuralDecompParams:
    """Two 3-layer tanh MLPs ``R^{C'} -> R^{H * R}`` (App. H Table 12):
    ``q_layers`` and ``k_layers`` are tuples of ``(w (din, dout), b
    (dout,))`` float32 tensors; ``heads`` and ``rank`` shape the output."""
    q_layers: tuple
    k_layers: tuple
    heads: int = 1
    rank: int = 8

    def leaves(self) -> list:
        """Every tensor, q's layers then k's, each layer's w before its b
        (the reference's pytree order)."""
        return [t for layers in (self.q_layers, self.k_layers)
                for layer in layers for t in layer]

    def replace_leaves(self, leaves) -> "NeuralDecompParams":
        """The same structure holding ``leaves`` (in ``leaves()`` order)."""
        it = iter(leaves)
        q = tuple((next(it), next(it)) for _ in self.q_layers)
        k = tuple((next(it), next(it)) for _ in self.k_layers)
        return NeuralDecompParams(q, k, heads=self.heads, rank=self.rank)


def _mlp_init(gen: torch.Generator, dims, device) -> tuple:
    """Weights ``N(0, 1) / sqrt(din)``, zero biases, from ``gen``."""
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        w = torch.randn((din, dout), generator=gen, device=device) \
            / float(np.sqrt(din))
        layers.append((w, torch.zeros((dout,), device=device)))
    return tuple(layers)


def _mlp_apply(layers, x: torch.Tensor) -> torch.Tensor:
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def neural_decomp_init(gen: torch.Generator, in_dim_q: int, in_dim_k: int,
                       *, hidden: int = 256, heads: int = 1, rank: int = 8,
                       device=None) -> NeuralDecompParams:
    """Factor MLPs ``in_dim -> hidden -> hidden -> heads * rank`` for the
    queries' and the keys' source features, on ``device`` (the generator's
    device unless given)."""
    device = gen.device if device is None else device
    return NeuralDecompParams(
        q_layers=_mlp_init(gen, (in_dim_q, hidden, hidden, heads * rank),
                           device),
        k_layers=_mlp_init(gen, (in_dim_k, hidden, hidden, heads * rank),
                           device),
        heads=heads, rank=rank)


def neural_decomp_apply(params: NeuralDecompParams, x_q: torch.Tensor,
                        x_k: torch.Tensor):
    """Factor tensors from source features: ``x_q (..., N, C'_q)``, ``x_k
    (..., M, C'_k)`` -> ``phi_q (..., N, H, R)``, ``phi_k (..., M, H, R)``."""
    shape = (params.heads, params.rank)
    return (_mlp_apply(params.q_layers, x_q).unflatten(-1, shape),
            _mlp_apply(params.k_layers, x_k).unflatten(-1, shape))


def predicted_bias(params: NeuralDecompParams, x_q: torch.Tensor,
                   x_k: torch.Tensor) -> torch.Tensor:
    """The ``(..., H, N, M)`` reconstruction ``phi_q phi_k^T``."""
    pq, pk = neural_decomp_apply(params, x_q, x_k)
    return torch.einsum("...nhr,...mhr->...hnm", pq, pk)


def adam_step(p: list, mu: list, nu: list, grads, step: torch.Tensor,
              lr) -> None:
    """One step of the plain Adam of the reference's Eq. 5 fits (b1 0.9, b2
    0.999, eps 1e-8), written out as the reference writes it: ``step`` is
    the float32 step count t (from 1), ``lr`` a float or a float32 tensor.
    Updates the lists ``p``, ``mu`` and ``nu`` in place (new tensors, no
    graph). ``torch.optim.Adam`` rounds in another order."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    with torch.no_grad():
        for j, g in enumerate(grads):
            mu[j] = b1 * mu[j] + (1 - b1) * g
            nu[j] = b2 * nu[j] + (1 - b2) * g * g
            mhat = mu[j] / (1 - b1 ** step)
            nhat = nu[j] / (1 - b2 ** step)
            p[j] = p[j].detach() - lr * mhat / (torch.sqrt(nhat) + eps)


def fit_neural_decomposition(
    gen: Optional[torch.Generator],
    params: NeuralDecompParams,
    sample_fn: Callable,
    *,
    steps: int = 1000,
    lr: float = 1e-3,
    lr_decay: float = 0.95,
    lr_decay_every: int = 50,
) -> Tuple[NeuralDecompParams, torch.Tensor]:
    """Optimize Eq. 5 with Adam on minibatches drawn by ``sample_fn``.

    ``sample_fn(gen) -> (x_q (N, C'), x_k (M, C'), target (H, N, M))``,
    called once a step with the same generator, whose state advances as it
    draws. The schedule is App. H Table 12's: Adam (b1 0.9, b2 0.999, eps
    1e-8), the learning rate ``lr * lr_decay ** (i // lr_decay_every)`` at
    step i (``adam_step``). Returns the fitted parameters and the loss of
    every step, a float32 tensor on the parameters' device (no read back
    to the host while fitting)."""
    p = [t.detach().clone() for t in params.leaves()]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    device = p[0].device
    losses = []
    for i in range(steps):
        xq, xk, target = sample_fn(gen)
        leaves = [t.requires_grad_(True) for t in p]
        pred = predicted_bias(params.replace_leaves(leaves), xq, xk)
        loss = ((pred - target) ** 2).mean()
        grads = torch.autograd.grad(loss, leaves)
        step = torch.tensor(float(i), dtype=torch.float32, device=device)
        cur_lr = lr * lr_decay ** torch.floor(step / lr_decay_every)
        adam_step(p, mu, nu, grads, step + 1.0, cur_lr)
        losses.append(loss.detach())
    return params.replace_leaves(p), torch.stack(losses)

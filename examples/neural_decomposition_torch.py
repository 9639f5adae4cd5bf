"""Paper Table 1(c) + App. G on the PyTorch/CUDA port: NEURAL decomposition
of biases that have no closed-form factorization — gravity 1/d^2 and
spherical (haversine) distance.

Token-wise factor MLPs (3 linear layers + tanh, App. H Table 12) are
trained with Eq. 5 to approximate f(x_q, x_k) ~= phi_q(x_q) phi_k(x_k)^T,
at rank R = 32 on minibatches of 64 random points.

    PYTHONPATH=src python examples/neural_decomposition_torch.py   # CUDA
    PYTHONPATH=src python examples/neural_decomposition_torch.py \
        --device cpu --steps 3
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core import decomp
from repro_torch.serve import resolve_device


def gravity(xq, xk):
    d2 = ((xq[:, None] - xk[None]) ** 2).sum(-1)
    return 1.0 / (d2 + 0.01)          # paper adds 0.01 for stability


def spherical(xq, xk):
    lat1, lon1 = xq[:, None, 0], xq[:, None, 1]
    lat2, lon2 = xk[None, :, 0], xk[None, :, 1]
    h = (torch.sin((lat1 - lat2) / 2) ** 2
         + torch.cos(lat1) * torch.cos(lat2)
         * torch.sin((lon1 - lon2) / 2) ** 2)
    return 2 * torch.arcsin(torch.sqrt(h.clamp(0.0, 1.0)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    results = {}
    for name, fn, lo, hi in (("gravity", gravity, 0.0, 1.0),
                             ("spherical", spherical, -1.5, 1.5)):
        gen = torch.Generator(device=device).manual_seed(0)
        params = decomp.neural_decomp_init(gen, 2, 2, hidden=64, heads=1,
                                           rank=32)

        def sample(g, fn=fn, lo=lo, hi=hi):
            xq = torch.rand((64, 2), generator=g, device=device) \
                * (hi - lo) + lo
            return xq, xq, fn(xq, xq)[None]

        fitted, losses = decomp.fit_neural_decomposition(
            gen, params, sample, steps=args.steps, lr=3e-3)
        xq, xk, target = sample(
            torch.Generator(device=device).manual_seed(99))
        with torch.no_grad():
            pred = decomp.predicted_bias(fitted, xq, xk)[0]
        rel = float(torch.linalg.vector_norm(pred - target[0])
                    / torch.linalg.vector_norm(target[0]))
        results[name] = (float(losses[0]), float(losses[-1]), rel)
        print(f"{name:10s} bias: Eq.5 loss {results[name][0]:.4f} -> "
              f"{results[name][1]:.4f}; held-out rel err {rel:.3f} (R=32, "
              f"{device})")
    print("(the fitted factors then ride with q/k exactly like the exact "
          "decompositions)")
    return results


if __name__ == "__main__":
    main()

"""Paper Sec. 4.4 on the PyTorch/CUDA port: a Transformer PDE solver with
a learnable spatial-distance bias, trained end to end with FlashBias (the
configuration where the dense path runs out of memory at 32k points —
Table 5).

    PYTHONPATH=src python examples/pde_solver_torch.py [--points 512] [--steps 80]
    PYTHONPATH=src python examples/pde_solver_torch.py --device cpu --steps 3

The bias ``alpha_i * ||x_i - x_j||^2`` reaches the attention as its exact
rank-9 factors (Example 3.5): on the card kernel 1's forward (its backward
is the plain attention's). Before training, the factored forward is held
against the dense-bias forward on one batch; the script raises where they
differ by more than ``TOL``. Runs on the CUDA device unless ``--device
cpu`` is given.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs.pde_solver import SMOKE
from repro_torch.data import PDEBatches
from repro_torch.models import pde as pde_mod
from repro_torch.models.common import materialize
from repro_torch.optim import AdamW, cosine
from repro_torch.serve import resolve_device
from repro_torch.train import make_train_step

# the factored and dense biases agree to float32 rounding (the forwards'
# gap reads ~2e-7 on the CPU): a wrong factor misses by orders more
TOL = 1e-4


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=512)
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = SMOKE.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=128)
    params = materialize(pde_mod.pde_template(cfg),
                         torch.Generator(device=device).manual_seed(0),
                         device=device)
    data = PDEBatches(n_points=args.points, global_batch=2, seed=0)

    def batch(step):
        return {k: torch.as_tensor(v, device=device)
                for k, v in data.batch(step).items()}

    # bias-path memory: dense (paper baseline) vs FlashBias factors
    n, h = args.points, cfg.n_heads
    print(f"N={n} points; dense bias would be {h * n * n * 4 / 1e6:.1f} MB "
          f"per layer; FlashBias factors are {2 * n * h * 9 * 4 / 1e3:.1f} KB")

    # exactness vs dense on a small batch
    b0 = batch(0)
    with torch.no_grad():
        out_fb = pde_mod.forward(params, b0["coords"], cfg)
        out_d = pde_mod.forward(params, b0["coords"],
                                cfg.replace(bias_mode="dense"))
    gap = float((out_fb - out_d).abs().max())
    print(f"exact decomposition check: max |fb - dense| = {gap:.2e}")
    if not gap <= TOL:
        raise SystemExit(f"the factored and dense-bias forwards differ by "
                         f"{gap:.2e} > {TOL:.0e}")

    opt = AdamW(lr_fn=cosine(1e-2, 5, args.steps), weight_decay=0.0)
    step = make_train_step(
        lambda p, b: pde_mod.regression_loss(p, b, cfg), opt)
    st = opt.init(params)
    losses = []
    for i in range(args.steps):
        params, st, m = step(params, st, batch(i))
        losses.append(float(m["loss"]))
        if i % 10 == 0:
            print(f"step {i:3d}  loss {losses[-1]:.5f}")
    print(f"loss {losses[0]:.5f} -> {losses[-1]:.5f} "
          f"(trained THROUGH the factored bias — the dense path would "
          f"store an (H,N,N) gradient)")
    return losses


if __name__ == "__main__":
    main()

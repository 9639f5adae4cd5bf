"""Batched Pairformer serving through the backend-abstracted engine of the
PyTorch/CUDA port (FlashBias Sec. 4.4): a request is ONE COMPLEX — a float
(n_res, d) residue feature array — and its budget counts refinement
iterations, not tokens.

Admission runs the trunk once per complex (triangle updates + pair
transitions), factorises each layer's pair-projected attention bias
(truncated SVD at the configured rank, Sec. 4.3; pass ``factors=`` for the
Eq. 5 factor MLPs), and caches the rank-R factors per slot — the
Pairformer analogue of a KV cache. Every engine step then refines the
single representation of EVERY live complex in one call, streaming
Theta(N R) factor bytes per slot instead of the N^2 dense bias, with
per-slot n_res masking over the padded batch (on the card, the ragged
FlashBias kernel, kernel 2). Results are bit-identical to serving each
complex alone (tests/test_torch_pair_serve.py).

    PYTHONPATH=src python examples/serve_pairformer_torch.py         # CUDA
    PYTHONPATH=src python examples/serve_pairformer_torch.py --device cpu
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import get_model, init_params
from repro_torch.serve import ServeEngine, resolve_device

SIZES = [14, 9, 21, 11, 17]
BUDGETS = [4, 6, 3, 5, 4]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = smoke_config("pairformer_lite")
    model = get_model(cfg)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    engine = ServeEngine(model, params, max_len=24, n_slots=2, device=device)
    rng = np.random.default_rng(0)

    # 5 variable-size complexes through 2 slots; the urgent one (priority
    # 1) overtakes the queue at admission time
    rids = [engine.submit(
        rng.standard_normal((n, cfg.d_model)).astype(np.float32), b,
        priority=1 if i == 3 else 0)
        for i, (n, b) in enumerate(zip(SIZES, BUDGETS))]

    t0 = time.monotonic()
    engine.run()
    dt = time.monotonic() - t0

    cache = engine.backend._cache
    kinds = ", ".join(f"{k}:{tuple(v.shape)}" for k, v in cache.items()
                      if k != "length")
    print(f"{cfg.name}: {len(rids)} complexes / 2 slots, "
          f"{sum(BUDGETS)} refinement steps in {dt:.2f}s")
    print(f"factor cache  {kinds}")
    out = {}
    for rid, n in zip(rids, SIZES):
        s = engine.result(rid)                  # final (n_res, d_model) rep
        print(f"  complex rid={rid} n_res={n:2d} -> single rep {s.shape}, "
              f"|s|_rms={float(np.sqrt((s ** 2).mean())):.4f}")
        out[rid] = s
    return out


if __name__ == "__main__":
    main()

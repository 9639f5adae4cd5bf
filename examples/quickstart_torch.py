"""FlashBias quickstart on the PyTorch/CUDA port: the paper's Eq. 3 in five
minutes.

    PYTHONPATH=src python examples/quickstart_torch.py               # CUDA
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Shows, on one attention call:
1. a dense ALiBi bias and its exact rank-2 factorization (Example 3.4),
2. that factored FlashBias attention == dense-bias attention,
3. the Eq. 3 concat identity (biased attention IS standard attention over
   C+R channels),
4. the IO model's predicted HBM saving (Example 3.9).

Checks 1-3 are exact up to float32 rounding: the script raises where one
exceeds ``TOL``. Runs on the CUDA device unless ``--device cpu`` is given.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import attention as A
from repro_torch.core import bias as B
from repro_torch.core.lowrank import IOModel
from repro_torch.serve import resolve_device

B_, N, H, D = 2, 128, 8, 64
# checks 1-3 agree to float32 rounding (~1e-6 here): a larger error is a
# wrong factorization, not rounding
TOL = 1e-4


def check(label: str, err: float) -> float:
    if not err <= TOL:
        raise SystemExit(f"{label}: error {err:.2e} exceeds {TOL:.0e}")
    return err


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((B_, N, H, D), generator=gen, device=device)
               for _ in range(3))

    # 1. exact decomposition: b[h,i,j] = slope_h * (j-i) = phi_q @ phi_k^T
    phi_q, phi_k = B.alibi_factors(N, N, H, device=device)
    dense = B.alibi_dense(N, N, H, device=device)
    recon = torch.einsum("hnr,mr->hnm", phi_q, phi_k)
    e1 = check("1. ALiBi factorization", float((recon - dense).abs().max()))
    print(f"1. ALiBi factorization error: {e1:.2e} (rank {phi_q.shape[-1]})")

    # 2. FlashBias attention == dense-bias attention
    pq4 = B.broadcast_factors(phi_q, B_, N, H)
    pk4 = B.broadcast_factors(phi_k, B_, N, H)
    o_dense = A.attention(q, k, v, bias=dense[None],
                          mask=A.MaskSpec("causal"), impl="dense")
    o_flash = A.attention(q, k, v, phi_q=pq4, phi_k=pk4,
                          mask=A.MaskSpec("causal"), impl="chunked",
                          chunk_size=32)
    e2 = check("2. FlashBias vs dense-bias",
               float((o_dense - o_flash).abs().max()))
    print(f"2. FlashBias vs dense-bias output error: {e2:.2e}")

    # 3. Eq. 3: concat factors onto q/k -> standard attention
    pk1 = B.broadcast_factors(phi_k, B_, N, 1)
    q_aug, k_aug = A.flashbias_concat_qk(q, k, pq4, pk1)
    o_concat = A.attention(q_aug, k_aug, v, mask=A.MaskSpec("causal"),
                           impl="dense", scale=1.0 / np.sqrt(D))
    e3 = check("3. Eq. 3 concat identity",
               float((o_concat - o_dense).abs().max()))
    print(f"3. Eq.3 concat identity error: {e3:.2e} "
          f"(channels {D} -> {q_aug.shape[-1]})")

    # 4. the paper's IO model: why this is fast
    io = IOModel(n=65536, m=65536, c=64, rank=64, sram=100 * 1024 // 2)
    ratio = io.speedup_over_dense_bias()
    print(f"4. Example 3.9 HBM-access ratio (dense-bias / FlashBias): "
          f"{ratio:.1f}x")
    print("   bias storage: dense", 65536 * 65536 * 2, "B -> factored",
          2 * 65536 * 64 * 2, "B (Thm 3.2)")
    return {"factorization": e1, "flashbias_vs_dense": e2, "concat": e3,
            "io_ratio": ratio}


if __name__ == "__main__":
    main()

"""End-to-end example: train a GPT-2-family LM with FlashBias-ALiBi on the
PyTorch/CUDA port.

    PYTHONPATH=src python examples/train_lm_alibi_torch.py    # ~10M, CUDA
    PYTHONPATH=src python examples/train_lm_alibi_torch.py \
        --device cpu --steps 3
    PYTHONPATH=src python examples/train_lm_alibi_torch.py --full  # ~100M

The paper's Sec. 4.2 setting: decoder-only, causal mask + ALiBi, the bias
consumed through the exact rank-2 decomposition (kernel 1 with the slopes
on the card), so the FlashBias loss equals the dense-ALiBi loss at step 0
(checked before training). Fault-tolerant loop: checkpoints land in
--ckpt-dir and a rerun resumes from the last one. Runs on the CUDA device
unless ``--device cpu`` is given.
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs.gpt2_alibi_15b import CONFIG
from repro_torch.data import LMBatches
from repro_torch.models import get_model, init_params
from repro_torch.models.common import count_params
from repro_torch.optim import AdamW, cosine
from repro_torch.serve import resolve_device
from repro_torch.train import TrainLoop, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params (slow on CPU)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a new temporary directory")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="flashbias_lm_")

    if args.full:   # ~100M: 12 layers x 768, vocab 50257
        cfg = CONFIG.replace(n_layers=12, d_model=768, n_heads=12,
                             n_kv_heads=12, d_ff=3072, head_dim=64,
                             tp=1, remat="none", dtype="float32",
                             grad_accum=1)
    else:           # ~10M demo
        cfg = CONFIG.replace(n_layers=6, d_model=256, n_heads=8,
                             n_kv_heads=8, d_ff=1024, head_dim=32,
                             vocab=8192, tp=1, remat="none",
                             dtype="float32", grad_accum=1)

    model = get_model(cfg)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    n_params = count_params(model.template())
    print(f"model: {cfg.name} derivative, {n_params / 1e6:.1f}M params, "
          f"FlashBias-ALiBi (exact R=2), on {device}")

    # sanity: FlashBias loss == dense-ALiBi loss at init (exact decomposition)
    data = LMBatches(vocab=cfg.vocab, seq_len=args.seq,
                     global_batch=args.batch, seed=0)

    def batch(step):
        return {k: torch.as_tensor(v, device=device)
                for k, v in data.batch(step).items()}
    with torch.no_grad():
        l_fb = float(model.loss(params, batch(0)))
        l_dense = float(get_model(cfg.replace(bias_mode="dense")).loss(
            params, batch(0)))
    print(f"exactness check: flashbias loss {l_fb:.5f} == dense-bias loss "
          f"{l_dense:.5f} (delta {abs(l_fb - l_dense):.2e})")
    if not abs(l_fb - l_dense) <= 1e-4 * abs(l_dense):
        raise SystemExit("the FlashBias and dense-ALiBi losses differ")

    opt = AdamW(lr_fn=cosine(3e-3, args.steps // 10, args.steps))
    step = make_train_step(model.loss, opt)
    log_path = os.path.join(ckpt_dir, "log.jsonl")
    loop = TrainLoop(step, batch, ckpt_dir=ckpt_dir, ckpt_every=50,
                     log_path=log_path)
    params, opt_state, info = loop.run(params, opt.init(params), args.steps)
    print("run info:", info)

    with open(log_path) as f:
        losses = [json.loads(line)["loss"] for line in f]
    if losses:
        k = max(1, len(losses) // 10)
        print(f"loss: first-{k} avg {sum(losses[:k]) / k:.4f} -> "
              f"last-{k} avg {sum(losses[-k:]) / k:.4f}")
    return losses


if __name__ == "__main__":
    main()

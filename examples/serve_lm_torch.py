"""Continuous batching across the three cache kinds, on the PyTorch/CUDA
port:

- stablelm (GQA, full KV slot segments, the flash-decoding kernel),
- hymba    (sliding-window RING cache + constant SSM state),
- mamba2   (pure constant-size SSM state — no KV growth at all).

Ragged prompts arrive at different times; freed slots are refilled from
the FIFO queue while the other slots keep decoding — one decode step per
engine step serves the whole slot batch.

    PYTHONPATH=src python examples/serve_lm_torch.py                 # CUDA
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

On the card the prefills run kernel 1 (hymba's in local mode) and the SSD
chunk scan (kernel 5), and stablelm's decode steps kernel 3.
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

ARCHS = ("stablelm_12b", "hymba_15b", "mamba2_130m")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {}
    for arch in ARCHS:
        cfg = smoke_config(arch)
        model = get_model(cfg)
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device=device)
        engine = ServeEngine(model, params, max_len=96, n_slots=2,
                             prefill_len=24, device=device)
        rng = np.random.default_rng(0)

        # 5 ragged requests through 2 slots: the queue drains as slots
        # free up
        rids = [engine.submit(
            rng.integers(0, cfg.vocab, (int(n),)).astype(np.int32), 12)
            for n in rng.integers(4, 25, (3,))]
        t0 = time.monotonic()
        engine.step()                              # admits the first wave
        rids += [engine.submit(
            rng.integers(0, cfg.vocab, (int(n),)).astype(np.int32), 12)
            for n in rng.integers(4, 25, (2,))]    # late arrivals
        engine.run()
        dt = time.monotonic() - t0

        results = [engine.result(r) for r in rids]
        n_tok = sum(r.size for r in results)
        cache = model.init_cache(2, 96, device=device)
        kinds = ", ".join(f"{k}:{tuple(v.shape)}" for k, v in cache.items()
                          if k != "length")
        print(f"{cfg.name:18s} {n_tok / dt:7.1f} tok/s "
              f"({len(rids)} reqs / 2 slots) | cache {kinds}")
        print(f"{'':18s} sample: {results[0][:12]}")
        out[arch] = results
    return out


if __name__ == "__main__":
    main()

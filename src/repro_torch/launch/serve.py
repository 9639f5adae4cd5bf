"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Drives the continuous-batching engine against synthetic traffic: ragged
prompt lengths, staggered arrivals (half the requests queue up front, the
rest join one per engine step while earlier ones decode), and per-request
sampling — the traffic of ``repro.launch.serve``. Runs on the CUDA device
unless ``--device cpu`` is given. ``--page-size N`` serves from a shared
page pool (lazy growth and preemption by default; ``--pool-pages`` sizes
the pool, small enough to watch it preempt).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import get_model, init_params
from repro_torch.serve import SamplingParams, ServeEngine, resolve_device


def drive(engine: ServeEngine,
          requests: List[Tuple[np.ndarray, int, SamplingParams]]) -> list:
    """Submit ``requests`` (prompt, new tokens, sampling) with staggered
    arrivals — the first half up front, then one per engine step — and step
    the engine until everything drains. Returns the request ids."""
    half = len(requests) // 2
    rids = [engine.submit(p, n, sampling=s) for p, n, s in requests[:half]]
    pending = list(requests[half:])
    while len(engine.scheduler) or engine.occupancy or pending:
        if pending:
            p, n, s = pending.pop(0)
            rids.append(engine.submit(p, n, sampling=s))
        engine.step()
    return rids


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="max prompt length (ragged draws in [4, prompt-len])")
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=0,
                    help="> 0: paged KV — shared page pool + page tables "
                         "instead of per-slot max_len segments")
    ap.add_argument("--page-reservation", choices=("lazy", "whole"),
                    default="lazy",
                    help="lazy: reserve prompt pages, grow on demand, "
                         "preempt on pool exhaustion; whole: reserve the "
                         "full footprint at admission")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="> 0: override the page-pool size (undersize it "
                         "to watch lazy growth preempt under pressure)")
    args = ap.parse_args(argv)
    if args.pool_pages and not args.page_size:
        ap.error("--pool-pages requires --page-size (paged KV)")

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=device)
    max_len = args.prompt_len + args.new_tokens + 8
    kw = {}
    if args.page_size:
        # every request fits max_len by construction: cap the page table at
        # one segment's footprint
        kw = {"page_size": args.page_size,
              "pages_per_slot": -(-max_len // args.page_size),
              "page_reservation": args.page_reservation}
        if args.pool_pages:
            kw["n_pages"] = args.pool_pages
    engine = ServeEngine(model, params, max_len=max_len, n_slots=args.slots,
                         prefill_len=args.prompt_len, device=device, **kw)
    del params                       # the engine holds its compute copy

    rng = np.random.default_rng(args.seed)
    lens = rng.integers(4, args.prompt_len + 1, (args.requests,))
    requests = [(rng.integers(0, cfg.vocab, (n,)).astype(np.int32),
                 args.new_tokens,
                 SamplingParams(args.temperature, args.top_k, seed=i))
                for i, n in enumerate(lens)]
    t0 = time.monotonic()
    rids = drive(engine, requests)
    dt = time.monotonic() - t0

    n_tok = sum(engine.result(r).size for r in rids)
    print(f"[serve] {cfg.name} on {device}: {args.requests} ragged requests "
          f"(prompts {lens.min()}-{lens.max()}) over {args.slots} slots: "
          f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s)")
    counts = engine.status_counts()
    line = ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
    print(f"[serve] lifecycle: {line}; {engine.n_quarantines} quarantines")
    stats = engine.page_stats()
    if stats:
        print(f"[serve] pages: {stats['watermark']}/{stats['n_pages']} peak "
              f"({args.page_reservation}), {stats['grown']} grown "
              f"mid-flight, {stats['preemptions']} preemptions")
    print("first request:", engine.result(rids[0])[:16])
    return [engine.result(r) for r in rids]


if __name__ == "__main__":
    main()

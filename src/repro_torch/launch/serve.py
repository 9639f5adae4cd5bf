"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Drives the continuous-batching engine against synthetic traffic: ragged
prompt lengths, staggered arrivals (half the requests queue up front, the
rest join one per engine step while earlier ones decode), and per-request
sampling — the traffic of ``repro.launch.serve``. Runs on the CUDA device
unless ``--device cpu`` is given. ``--page-size N`` serves from a shared
page pool (lazy growth and preemption by default; ``--pool-pages`` sizes
the pool, small enough to watch it preempt). ``--prefill-chunk N`` lands
prompts N tokens per engine step between decode steps; ``--prefix-cache``
(with ``--page-size``) shares completed prompt pages between requests, and
``--shared-prefix N`` gives every prompt a common N-token head to share.
The frontend configs (``musicgen_medium``, ``phi3_vision_42b``) give every
request ``frontend_len`` seeded embedding rows ahead of its prompt, and
``max_len`` grows by as many; chunked prefill refuses such requests, as the
reference's does. ``--inject-fault PLAN`` drives the engine under a fault plan
(``kind@step[/slot][xcount]``, comma-separated; kinds alloc, nan, step,
delay) and prints every fault that fired; ``--deadline-steps`` and
``--max-retries`` set every request's deadline and quarantine retries.

``--mesh DxM`` serves on a ``(data, model)`` ``DeviceMesh`` of D*M ranks,
one process each, started by ``torchrun`` (or anything that sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``): ``gloo`` with ``--device cpu``,
``nccl`` on the cards, rank r on card ``LOCAL_RANK``. Every rank serves the
same traffic and only rank 0 prints::

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch stablelm_12b --smoke --device cpu --mesh 2x2
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import get_model, init_params
from repro_torch.serve import (FaultPlan, SamplingParams, ServeEngine,
                               resolve_device)


def drive(engine: ServeEngine,
          requests: List[Tuple[np.ndarray, int, SamplingParams]],
          frontends: Optional[list] = None, **submit) -> list:
    """Submit ``requests`` (prompt, new tokens, sampling) with staggered
    arrivals — the first half up front, then one per engine step — and step
    the engine until everything drains. ``frontends``, where given, holds
    each request's (F, D) frontend rows; ``submit`` goes to every
    ``engine.submit`` (deadline, retries). Returns the request ids."""
    fronts = frontends or [None] * len(requests)
    queue = [(p, n, s, f) for (p, n, s), f in zip(requests, fronts)]
    half = len(queue) // 2
    rids = [engine.submit(p, n, sampling=s, frontend=f, **submit)
            for p, n, s, f in queue[:half]]
    pending = queue[half:]
    while len(engine.scheduler) or engine.occupancy or pending:
        if pending:
            p, n, s, f = pending.pop(0)
            rids.append(engine.submit(p, n, sampling=s, frontend=f,
                                      **submit))
        engine.step()
    return rids


def frontend_rows(cfg, n: int, seed: int) -> Optional[list]:
    """Seeded standard-normal (F, D) float32 frontend rows for ``n``
    requests of a frontend config (the reference's stub of the audio /
    vision towers: precomputed embeddings); None for the others."""
    if not cfg.frontend_len:
        return None
    rng = np.random.default_rng(seed + 1)
    return [rng.standard_normal((cfg.frontend_len, cfg.d_model)).astype(
        np.float32) for _ in range(n)]


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
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="> 0: chunked prefill — prompts land this many "
                         "tokens per engine step, interleaved with decode "
                         "(long arrivals never stall the batch)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-hashed prefix caching: requests whose "
                         "prompts share completed pages map their page "
                         "tables onto them and prefill only the novel "
                         "tail (needs --page-size; defaults "
                         "--prefill-chunk to the page size)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="> 0: prepend a common prefix of this many tokens "
                         "to every request (system-prompt traffic — watch "
                         "--prefix-cache hit rates)")
    ap.add_argument("--deadline-steps", type=int, default=0,
                    help="> 0: per-request deadline — a request still live "
                         "or queued after this many engine steps ends "
                         "TIMED_OUT")
    ap.add_argument("--max-retries", type=int, default=1,
                    help="quarantine retries per request before a guard "
                         "fault ends it FAILED (0: fail on the first "
                         "non-finite emission)")
    ap.add_argument("--inject-fault", default="",
                    help="fault plan, e.g. 'nan@6/0x2,alloc@3x4' — "
                         "kind@step[/slot][xcount], comma-separated; kinds: "
                         "alloc, nan, step, delay")
    ap.add_argument("--mesh", default="",
                    help="DxM (e.g. 2x2): serve on a (data, model) device "
                         "mesh — TP-split heads / pools, DP-split slot "
                         "rows; needs a world of D*M ranks (torchrun "
                         "--nproc-per-node D*M)")
    ap.add_argument("--init-method", default="env://",
                    help="process-group rendezvous of --mesh (env:// reads "
                         "torchrun's MASTER_ADDR / MASTER_PORT; file://PATH "
                         "needs no port)")
    args = ap.parse_args(argv)
    if args.pool_pages and not args.page_size:
        ap.error("--pool-pages requires --page-size (paged KV)")
    if args.prefix_cache and not args.page_size:
        ap.error("--prefix-cache requires --page-size (paged KV)")
    if args.prefix_cache and not args.prefill_chunk:
        args.prefill_chunk = args.page_size

    device = resolve_device(args.device)
    mesh, rank = None, 0
    if args.mesh:
        mesh, rank, device = _mesh(ap, args.mesh, args.init_method, device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=device)
    max_len = (args.shared_prefix + args.prompt_len + args.new_tokens + 8
               + cfg.frontend_len)
    kw = {}
    if args.page_size:
        # every request fits max_len by construction: cap the page table at
        # one segment's footprint
        kw = {"page_size": args.page_size,
              "pages_per_slot": -(-max_len // args.page_size),
              "page_reservation": args.page_reservation}
        if args.pool_pages:
            kw["n_pages"] = args.pool_pages
    if args.prefill_chunk:
        kw["prefill_chunk"] = args.prefill_chunk
    if args.prefix_cache:
        kw["prefix_cache"] = True
    if args.inject_fault:
        kw["faults"] = FaultPlan.parse(args.inject_fault)
    if mesh is not None:
        kw["mesh"] = mesh
    engine = ServeEngine(model, params, max_len=max_len, n_slots=args.slots,
                         prefill_len=args.shared_prefix + args.prompt_len,
                         device=device, **kw)
    del params                       # the engine holds its compute copy

    rng = np.random.default_rng(args.seed)
    lens = rng.integers(4, args.prompt_len + 1, (args.requests,))
    common = rng.integers(0, cfg.vocab, (args.shared_prefix,)).astype(np.int32)
    requests = [(np.concatenate([common, rng.integers(
                    0, cfg.vocab, (n,)).astype(np.int32)]),
                 args.new_tokens,
                 SamplingParams(args.temperature, args.top_k, seed=i))
                for i, n in enumerate(lens)]
    t0 = time.monotonic()
    rids = drive(engine, requests, frontend_rows(cfg, len(requests),
                                                 args.seed),
                 deadline_steps=args.deadline_steps or None,
                 max_retries=args.max_retries)
    dt = time.monotonic() - t0
    results = [engine.result(r) for r in rids]
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
        if rank:                      # every rank served; rank 0 reports
            return results

    n_tok = sum(r.size for r in results)
    where = device if mesh is None else (
        f"{device.type} mesh {args.mesh} (data x model)")
    print(f"[serve] {cfg.name} on {where}: {args.requests} ragged requests "
          f"(prompts {lens.min()}-{lens.max()}) over {args.slots} slots: "
          f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s)")
    counts = engine.status_counts()
    line = ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
    print(f"[serve] lifecycle: {line}; {engine.n_quarantines} quarantines, "
          f"{engine.n_faults_contained} faults contained")
    if engine.faults is not None:
        for step, kind, slot in engine.faults.fired:
            at = f" slot {slot}" if slot >= 0 else ""
            print(f"[serve] fault fired: {kind}@{step}{at}")
    stats = engine.page_stats()
    if stats:
        print(f"[serve] pages: {stats['watermark']}/{stats['n_pages']} peak "
              f"({args.page_reservation}), {stats['grown']} grown "
              f"mid-flight, {stats['preemptions']} preemptions")
        if "prefix" in stats:
            pf = stats["prefix"]
            print(f"[serve] prefix cache: {pf['hit_rate']:.0%} hit rate "
                  f"({pf['tokens_matched']}/{pf['tokens_matchable']} "
                  f"tokens), {pf['entries']} entries, "
                  f"{pf['cow_copies']} CoW copies, "
                  f"{pf['evictions']} evictions")
    print("first request:", results[0][:16])
    return results


def _mesh(ap, spec: str, init_method: str, device: torch.device):
    """The ``(data, model)`` mesh of ``--mesh DxM`` over a process group of
    ``WORLD_SIZE`` ranks (an error unless it is D*M, as the reference's
    launcher errs without D*M devices); returns (mesh, rank, this rank's
    device)."""
    from repro_torch.launch.mesh import init_mesh
    try:
        mesh, rank, device, _ = init_mesh(spec, init_method, device,
                                          names=(("data", "model"),))
    except ValueError as e:
        ap.error(str(e))
    return mesh, rank, device


if __name__ == "__main__":
    main()

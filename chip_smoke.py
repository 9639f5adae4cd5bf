#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--seed N]

Needs one CUDA device (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``; exits non-zero without them. Phases, each printed
as it runs, any failure ending the run:

1. build    — compile the CUDA sources of ``src/repro_torch/csrc`` (one
              nvcc per source, started together: ``flashbias_attn.cu``,
              which holds the static and the ragged attention kernels,
              ``flash_decode.cu``, which holds the contiguous and the
              paged decode kernels, and ``ssd_scan.cu``, the SSD chunk
              scan) and print ptxas's register / shared-memory report;
              count the HGMMA (wgmma) instructions of every kernel function
              of the attention and SSD libraries in their SASS
              (``cuobjdump -sass``): the run fails if a tensor-core body
              (``attn_fwd_tc``; ``ssd_states``, ``ssd_cb``,
              ``ssd_chunk_scan``) has none;
2. kernels  — each of the four attention kernels against its plain
              PyTorch version on the card, at the serving paths' shapes
              and off-path modes (N off the 64-row tile, head dims and
              ranks off 16), within the stated tolerances (length-0 rows
              of the ragged and the decode kernels exactly 0); every bf16
              call of kernels 1 and 2 takes the tensor-core body, every
              float32 call the CUDA-core one. The split-KV decode kernels
              also take lengths across their span boundaries
              (SPLIT_LENGTHS), and the cases that write the new token's
              row (the path shapes among them; paged, one with its write
              block the sentinel) must leave the caches bit-equal to the
              plain version's; the path shapes, called twice, must give
              bit-identical outputs;
3. serve    — GPT-2-ALiBi-1.5B at full width (48 layers, d_model 1600,
              bf16, random weights from ``--seed``) through ``ServeEngine``
              on 4 slots x 2048 positions: 8 ragged requests (prompts
              64-512 tokens, 32 new tokens each, 6 greedy and 2 sampled),
              staggered as the launcher does. Every request must end OK
              with 32 tokens, and the kernels' launch counters must equal
              48 x prefill waves and 48 x decode steps, every prefill
              launch on the tensor-core body;
4. paged    — the same 8 requests through a paged engine (page size 16,
              lazy reservation) whose pool is sized from the mix so that
              it grows pages and preempts; every request OK with 32
              tokens, the paged decode kernel launched 48 x decode steps
              and the contiguous one never, every prefill launch on the
              tensor-core body, every page free at the end;
5. parity   — the first wave's prefill and 4 decode steps again, with the
              plain path (impl="torch") on the card, logits compared, on
              the contiguous cache and on a paged cache (whose kernel path
              is also held against the contiguous kernel path): the kernel
              path's decode calls write the new row themselves, the plain
              path's by gather / where / scatter; then decode steps of both
              kernel paths timed and traced with torch.profiler (device
              busy time, idle share, top kernels, and the indexing kernels'
              calls and time per step);
6. times    — kernel, plain-version and library device times per call at
              the path shapes (torch.profiler), the least time the card
              could take (bound), decode step times and end-to-end tokens/s;
              the decode kernels' calls write the new row, as on the serve
              path, and their bounds count its bytes (the library calls
              write none);
7. pair     — Pairformer-lite at full width (16 layers, d_single 384,
              d_pair 128, 4 heads x 96, bf16 compute, random float32
              weights from ``--seed``) through ``ServeEngine`` on 4 slots x
              384 residues in SVD mode: 8 complexes (n_res 96-384), 4-8
              refinement steps each, staggered. Every request must end OK
              with a finite (n_res, 384) result, the ragged kernel's counter
              must equal 16 x (admission waves + refinement steps), each
              launch on the tensor-core body, and the other kernels must
              not launch;
8. pair parity — the first wave's admission and 2 steps again with the
              plain path (impl="torch"): bf16 in SVD mode and in factor-MLP
              mode (MLPs from ``--seed``, hidden 256), every ragged kernel
              call held in situ against the plain version on its inputs,
              and the final single reps' gap at most PAIR_CONTROL_MULT times
              that of a float64-attention control; float32 in SVD mode
              within PAIR_TOL_F32; deliberate faults of the attention, each
              of which the bf16 check must reject; and one complex served
              alone through a 4-slot engine bit-equal to its batched
              result. A failed check here fails the run at its end, after
              phase 9 has measured;
9. pair times — the ragged kernel, its plain version and the library call
              per call at the path shape, a refinement step of 4 full slots
              in the three cache modes (factored SVD, dense_recompute,
              dense) in alternating rounds, one factored step traced, and
              the admission wave's time;
10. ssm kernel — the SSD chunk-scan kernel against its plain version on y
              and the final state: at the SSM path's shape (4 x 4096
              positions, 32 heads x 64, state 128, float32, one b/c group,
              through the model's strided layout), then S off the chunk,
              S shorter than a chunk, a nonzero h0, b/c per head, a dt
              that would overflow an unmasked exp, bf16 x, under
              ``ssd_tolerance``, each on the tensor-core body; and one
              shape off it (P 20, N 8, chunk 48) on the CUDA-core body;
11. ssm serve — mamba2-130m at full width (24 layers, d_model 768, 32 SSM
              heads x 64, state 128, bf16, random weights from ``--seed``)
              through ``ServeEngine`` on 4 slots, max_len 2048: 8 requests
              with prompts of 4096 (longer than max_len), 3000, 1024, 2048,
              512, 777, 1500 and 256 tokens, 32 new tokens each, 6 greedy
              and 2 sampled, staggered. Every request ends OK with 32
              tokens; the SSD kernel launches 24 x admission waves, each
              on the tensor-core body, and the attention kernels never.
              An engine built with page_size=16 serves the same mix with
              the same greedy streams and reports that it does not page;
12. ssm parity and times — the first wave's prefill and 4 decode steps
              again with the plain path (impl="torch"): every SSD kernel
              call held in situ against the plain version on its inputs,
              the logits within SSM_LOGIT_TOL, and a deliberate fault (the
              state not carried across chunks) that the check must reject;
              then the kernel (and its split over the four device kernels
              of the tensor-core body), its plain version and its bound
              per call at the path shape, the admission wave, the decode
              step of 4 slots (device busy, idle share) and end-to-end
              tokens/s.

The last lines are the per-kernel JSON record, the card's name and power
limit as nvidia-smi reports them, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # dense tensor-core bf16
N_LAYERS = 48
SLOTS, MAX_LEN, PROMPT_MAX, NEW_TOKENS = 4, 2048, 512, 32
PAGE = 16                        # page size of the paged phases
LOGIT_TOL = 0.25                 # bf16 logits, 48 layers deep (see phase 5)
# decode lengths across the split kernel's span boundaries (128 keys at D 32,
# 32 at D 160) and the whole cache
SPLIT_LENGTHS = [0, 1, 63, 64, 65, 127, 128, 129, 777, 2048]
KERNELS = ("flashbias_attention_fwd", "flash_decode_fwd",
           "flash_decode_paged_fwd", "flashbias_attention_ragged_fwd",
           "ssd_scan_fwd")
PAIR_LAYERS, PAIR_SLOTS, PAIR_MAX_LEN = 16, 4, 384
PAIR_STEPS = 2                   # refinement steps of the parity phase
# Pair parity, bf16. Both paths keep s in bf16 through 16 layers and three
# passes (admission + 2 steps), so any change in where one attention output
# rounds spreads to most elements of s: the plain path against itself with
# its attention computed in float64 moves s by ~0.1 x RMS(s) at max |diff|.
# A bound on that end-to-end gap alone either sits below this floor or
# cannot tell a kernel fault from rounding, so the check has two parts:
# 1. in situ: every ragged kernel call of the kernel path is held against
#    the plain version on the same inputs under ``tolerance()``, the kernel
#    phase's rule: a fault of the kernel shows there, before rounding
#    compounds through the layers;
# 2. end to end: the kernel path's max |diff| of s from the plain path is at
#    most PAIR_CONTROL_MULT times the float64 control's, read in the same
#    run and mode. The kernel's output is one bf16 rounding of a float32
#    result and the control's one of a float64 result: drifts of one size.
# Deliberate faults of the plain attention (PAIR_FAULTS) stand in for a wrong
# kernel: the check must reject each of them, or the run fails.
PAIR_CONTROL_MULT = 2.0
# The same comparison in float32 throughout (compute dtype float32): the
# paths then differ only in the order of float32 sums inside attention
# (~1e-6 relative per call), which over 16 layers and three passes stays
# orders of magnitude below 1e-3 of RMS(s). In situ, the float32 rule of
# ``tolerance()`` holds.
PAIR_TOL_F32 = 1e-3
# (name, keys the attention skips, whether the bias takes the softmax
# scale): a kv tile the block loop misses, and the bias added before the
# scaling
PAIR_FAULTS = (("keys 64-127 skipped", (64, 128), False),
               ("bias scaled by the softmax scale", None, True))
SSM_LAYERS, SSM_SLOTS, SSM_MAX_LEN = 24, 4, 2048
SSM_PROMPTS = (4096, 3000, 1024, 2048, 512, 777, 1500, 256)
SSM_DECODE_STEPS = 4             # decode steps of the parity phase
# SSM parity, bf16 compute. The scan runs in float32 on both paths (the
# model casts x, b, c to float32 and keeps dt, a and the state there), so
# the paths differ only in float32 rounding inside the scan (the order of
# sums; on the tensor-core body also the bf16 hi + lo split of each
# operand, < 2^-15 relative per product term), ~1e-6 to 1e-5 relative.
# Such a difference shows in the bf16 model only where it flips the
# rounding of an element (1 bf16 ulp, 2^-8 relative) after the gated norm,
# and spreads through 24 layers as the attention kernels' roundings spread
# through the LM's 48 (phase 5: within 0.125 of the plain path's logits,
# tolerance 0.25). The largest logits here are bf16 values in [8, 16),
# whose ulp is 2^-4 = 0.0625 (the gap has read 0.0625, one such ulp): the
# bound, 0.125, is 2 such ulps at the logits' top scale. In situ, every
# kernel call is held against the plain version on its own inputs under
# ``ssd_tolerance``: a fault of the kernel shows there first.
SSM_LOGIT_TOL = 0.125


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time per call between CUDA events around ``iters`` back-to-back calls:
    the device's time plus any gaps in which it waits for the host to issue
    the next call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_rows(prof) -> list:
    """The device-side (kernel and copy) rows of a profile's averages."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def device_kernels(prof) -> list:
    """The device rows of the profiled calls: all but the profiler's own
    step annotation (``ProfilerStep#n``, which spans the step on the device
    timeline) and the spin kernels that open the kept step."""
    return [e for e in device_rows(prof)
            if not e.key.startswith("ProfilerStep")
            and SPIN_KERNEL not in e.key]


def device_us(e) -> float:
    return (getattr(e, "self_device_time_total", 0)
            or getattr(e, "self_cuda_time_total", 0))


PROFILE_TRIES = 3                # an incomplete profile is retried
PROFILE_HEAD = 4                 # ~25 ms spin kernels opening the warm-up
                                 # step and the kept step, doubled at every
                                 # retry
SPIN_KERNEL = "spin_kernel"      # torch.cuda._sleep's kernel
# the port's CUDA kernels as torch.profiler names them (kernels 1 and 2
# share the attn_fwd_tc template in bf16 and attn_fwd in float32, kernels 3
# and 4 the split-KV decode_split one; kernel 5 is ssd_fwd on the CUDA cores
# and the four SSD_STAGES on the tensor cores)
SSD_STAGES = ("ssd_states", "ssd_cb", "ssd_state_pass", "ssd_chunk_scan")
PORT_KERNEL = re.compile(
    r"(?<![A-Za-z0-9_])(attn_fwd|attn_fwd_tc|decode_split|ssd_fwd|"
    + "|".join(SSD_STAGES) + r")[<(]")
# the wrappers that also count their tensor-core launches: the two attention
# wrappers and the SSD scan's
ATTENTION = ("flashbias_attention_fwd", "flashbias_attention_ragged_fwd")
TENSOR_CORE = ATTENTION + ("ssd_scan_fwd",)


def window(prof) -> str:
    """Where a profile's device events and kernel launches lie in time
    (us, from the first event), for the report of an incomplete one."""
    from torch.autograd import DeviceType
    events = prof.events()
    t0 = min(e.time_range.start for e in events)
    dev = [e.time_range.start - t0 for e in events
           if getattr(e, "device_type", None) == DeviceType.CUDA]
    host = [e.time_range.start - t0 for e in events
            if "LaunchKernel" in e.name]
    span = (lambda t: f"{len(t)} from {min(t):.0f} to {max(t):.0f}"
            if t else "none")
    return f"device events {span(dev)}, launches {span(host)}"


def device_launches(wrapper) -> int:
    """The device kernels a counted wrapper has launched: its launch count,
    or, for the SSD wrapper, one of whose calls launches up to four, its
    count of device kernels."""
    return getattr(wrapper, "device_kernels", wrapper.launches)


def profiled(fn, iters: int, uniform: bool = True):
    """Run ``fn`` ``iters`` times under torch.profiler; returns the
    profile's device rows (``device_kernels``). The profiler has been seen to drop device events,
    so a profile is taken only when it is complete by what the run knows:
    the port's kernels recorded exactly as often as their counters of
    device kernels moved during it (``device_launches``), and, where every
    call of ``fn`` runs the same kernels (``uniform``), every device row
    counted a multiple of ``iters`` times.
    The events lost were those of a tracing session's start, more of them
    the longer the process had run, so the session opens with a warm-up
    step, traced and discarded (PROFILE_HEAD spin kernels of ~25 ms each,
    each behind a synchronize, and one call of ``fn``), and only the step
    after it is kept. Late in the run the kept step still lost its own
    first 1-36 ms (the SSD kernel's 20 calls of 4.4 ms, however long the
    warm-up), so the kept step opens with PROFILE_HEAD spin kernels too,
    left out of every sum (``device_kernels``), and waits for them before
    the calls, which then start on an idle device. The kept step's host
    rows hold that wait: a host breakdown comes from ``host_ops``. An
    incomplete profile is taken again with twice the spins, up to
    PROFILE_TRIES times, before the run fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    counters = launch_counters().values()
    seen = []
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     acc_events=True) as prof:
            for _ in range(PROFILE_HEAD << attempt):
                torch.cuda._sleep(50_000_000)         # clock cycles
                torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(PROFILE_HEAD << attempt):
                torch.cuda._sleep(50_000_000)
            torch.cuda.synchronize()
            before = sum(device_launches(c) for c in counters)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
        launched = sum(device_launches(c) for c in counters) - before
        kernels = device_kernels(prof)
        port = sum(e.count for e in kernels if PORT_KERNEL.search(e.key))
        ragged = [(e.key[:40], e.count) for e in kernels
                  if e.count % iters]
        if kernels and port == launched and not (uniform and ragged):
            return kernels
        seen.append(f"{len(kernels)} device rows, port kernels {port} of "
                    f"{launched} launched, rows not a multiple of {iters}: "
                    f"{ragged if uniform else 'not checked'}; "
                    f"{window(prof)}")
    raise AssertionError(f"torch.profiler recorded an incomplete profile in "
                         f"{PROFILE_TRIES} tries: {seen}")


def host_ops(fn, iters: int, top: int = 6) -> list:
    """The ``top`` host-side rows (by self CPU time) of ``iters`` calls of
    ``fn`` under torch.profiler, in a profile of their own that queues
    nothing ahead of the calls: after a traced and discarded warm-up call
    and a synchronize, the calls start on an idle device, as between
    serving steps, and end with one synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        prof.step()
    device = {e.key for e in device_rows(prof)}
    host = [e for e in prof.key_averages() if e.key not in device]
    return sorted(host, key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:top]


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn``: the summed durations of the kernels
    and copies it runs, from a complete torch.profiler profile over
    ``iters`` calls — without the gaps ``event_ms`` counts, which for a
    ~20 us decode kernel behind a Python wrapper are most of the bracket."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    kernels = profiled(fn, iters)
    return sum(device_us(e) for e in kernels) / iters / 1e3


def tolerance(dtype, ref) -> float:
    """float32: summation order only (1e-4). bfloat16: both sides round the
    same float32 result once, so 2 bf16 ulps at the output's scale."""
    import torch
    if dtype == torch.float32:
        return 1e-4
    return 2.0 ** -6 * max(1.0, float(ref.float().abs().max()))


def sass_functions(name: str, pattern: str) -> dict:
    """HGMMA instructions per kernel function of the built library ``name``,
    from ``cuobjdump -sass``: the functions whose mangled names match
    ``pattern``, keyed ``name<template arguments>`` from its two groups."""
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            head = re.search(r"Function : " + pattern, line)
            fn = (head.group(1) + (f"<{head.group(2)}>" if head.group(2)
                                   else "")) if head else None
            if fn is not None:
                counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def sass_hgmma() -> None:
    """HGMMA instructions per kernel function of the built attention and SSD
    libraries; fails unless every tensor-core body has some: each
    ``attn_fwd_tc<Dv, phi>`` and each instantiation of the SSD body's three
    kernels with products (``ssd_states``, ``ssd_cb``, ``ssd_chunk_scan``;
    ``ssd_state_pass`` has none, nor has the CUDA-core ``ssd_fwd``)."""
    attn = sass_functions("flashbias_attn",
                          r"\S*?\d(attn_fwd(?:_tc)?)I(\w+?)EE")
    ssd = sass_functions("ssd_scan", r"\S*?\d(ssd_\w+?)(?:I(\w+?)E)?E")
    log("build", f"HGMMA instructions per function in the SASS of "
                 f"libflashbias_attn: {attn}")
    log("build", f"HGMMA instructions per function in the SASS of "
                 f"libssd_scan: {ssd}")
    tc = {k: n for k, n in attn.items() if k.startswith("attn_fwd_tc")}
    tc.update({k: n for k, n in ssd.items()
               if k.split("<")[0] in ("ssd_states", "ssd_cb",
                                      "ssd_chunk_scan")})
    stages = {k.split("<")[0] for k in tc}
    if not all(tc.values()) or not {"attn_fwd_tc", "ssd_states", "ssd_cb",
                                    "ssd_chunk_scan"} <= stages:
        raise AssertionError(f"a tensor-core body without HGMMA: {tc}")


def check_tensor_core(phase: str, names=ATTENTION) -> None:
    """Every launch of the wrappers ``names`` (the attention wrappers by
    default) since their counters were set to 0 took the tensor-core
    body."""
    counters = launch_counters()
    got = {name: (counters[name].tensor_core_launches,
                  counters[name].launches) for name in names}
    log(phase, f"tensor-core launches / launches: {got}")
    if any(tc != n for tc, n in got.values()):
        raise AssertionError(f"{phase}: launches off the tensor-core body: "
                             f"{got}")


def reset_counters() -> dict:
    """Every launch counter set to 0; returns the counted wrappers."""
    counters = launch_counters()
    for name, fn in counters.items():
        fn.launches = 0
        if name in TENSOR_CORE:
            fn.tensor_core_launches = 0
        if hasattr(fn, "device_kernels"):
            fn.device_kernels = 0
    return counters


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def prefill_inputs(gen, b, h, kvh, n, d, dtype, bias, r=4):
    import torch
    dev = "cuda"
    q = torch.randn((b, h, n, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, kvh, n, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, kvh, n, d), generator=gen, device=dev).to(dtype)
    extra = {}
    if bias == "phi":
        extra["phi_q"] = torch.randn((b, h, n, r), generator=gen, device=dev)
        extra["phi_k"] = torch.randn((b, h, n, r), generator=gen, device=dev)
    elif bias == "alibi":
        from repro_torch.core.bias import alibi_slopes
        extra["slopes"] = alibi_slopes(h, device=dev)
    return q, k, v, extra


def decode_inputs(gen, b, kvh, g, s, d, dtype, bias, lengths, r=4):
    import torch
    dev = "cuda"
    q = torch.randn((b, kvh, g, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, kvh, s, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, kvh, s, d), generator=gen, device=dev).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    extra = {}
    if bias == "phi":
        extra["phi_q"] = torch.randn((b, kvh, g, r), generator=gen,
                                     device=dev)
        extra["phi_k"] = torch.randn((b, kvh, s, r), generator=gen,
                                     device=dev)
    elif bias == "alibi":
        from repro_torch.core.bias import alibi_slopes
        extra["slopes"] = alibi_slopes(kvh * g, device=dev).reshape(kvh, g)
    return q, k, v, lens, extra


def paged_table(rng, b, n_live, n_pages):
    """(b, n_live + 4) int32 page table: a random permutation of the pool's
    pages, then garbage columns (ids past the pool and negative ones) that
    the kernel must clamp and never reach past the length mask."""
    live = rng.permutation(n_pages)[:b * n_live].reshape(b, n_live)
    junk = rng.integers(-3, 2 * n_pages, (b, 4))
    junk[:, 0] = n_pages                     # the engine's sentinel
    return np.concatenate([live, junk], 1).astype(np.int32)


def widen_table(table, width: int, n_pages: int):
    """``table`` padded with sentinel columns (``n_pages``) to ``width``,
    the serve engine's table width: the split axis of the paged kernel's
    grid is sized from it."""
    import torch
    pad = torch.full((table.shape[0], width - table.shape[1]), n_pages,
                     dtype=table.dtype, device=table.device)
    return torch.cat([table, pad], 1).contiguous()


def sentinel_write(table, row: int, block: int, n_live: int, n_pages: int):
    """``table`` with the sentinel (``n_pages``) at ``row``'s ``block``, and
    the pool's last page (where the kernel clamps the sentinel to) taken
    out of every row's live pages, so that no row writes what another
    reads."""
    import torch
    t = table.cpu().numpy().copy()
    live = t[:, :n_live]
    spare = min(set(range(n_pages)) - set(live.ravel().tolist()))
    live[live == n_pages - 1] = spare
    t[row, block] = n_pages
    return torch.as_tensor(t, device=table.device)


def alibi_slab(table, lengths, n_pages, ps, rng):
    """The engine's factor slab ``(n_pages, ps, 2)``: row ``[1, pos]`` of
    every logical position a table maps, random rows elsewhere."""
    slab = rng.standard_normal((n_pages, ps, 2)).astype(np.float32)
    for b, n in enumerate(lengths):
        for j in range(-(-n // ps)):
            pos = np.arange(j * ps, (j + 1) * ps, dtype=np.float32)
            slab[table[b, j]] = np.stack([np.ones_like(pos), pos], -1)
    return slab


def paged_inputs(gen, rng, b, kvh, g, d, ps, dtype, bias, lengths, r=4):
    """Inputs of the paged decode kernel. ``bias="alibi_slab"`` is the
    serving path: phi mode with ``phi_q = slope * [-(len-1), 1]`` against
    the shared rank-2 ``[1, pos]`` slab; ``"phi"`` / ``"phi_kvh"`` random
    factors on a shared / per-kv-head slab; ``"alibi"`` in-kernel slopes."""
    import torch
    from repro_torch.core.bias import alibi_slopes
    dev = "cuda"
    n_live = -(-max(lengths) // ps)
    n_pages = b * n_live + 3
    q = torch.randn((b, kvh, g, d), generator=gen, device=dev).to(dtype)
    kp, vp = (torch.randn((kvh, n_pages, ps, d), generator=gen,
                          device=dev).to(dtype) for _ in range(2))
    table = paged_table(rng, b, n_live, n_pages)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    extra = {}
    slopes = alibi_slopes(kvh * g, device=dev).reshape(kvh, g)
    if bias == "alibi_slab":
        qpos = (lens.float() - 1)[:, None, None]
        extra["phi_q"] = torch.stack(
            [-qpos * slopes[None], slopes[None].expand(b, kvh, g)], -1)
        extra["phi_pages"] = torch.as_tensor(
            alibi_slab(table, lengths, n_pages, ps, rng), device=dev)[None]
    elif bias.startswith("phi"):
        lead = kvh if bias == "phi_kvh" else 1
        extra["phi_q"] = torch.randn((b, kvh, g, r), generator=gen,
                                     device=dev)
        extra["phi_pages"] = torch.randn((lead, n_pages, ps, r),
                                         generator=gen, device=dev)
    elif bias == "alibi":
        extra["slopes"] = slopes
    pt = torch.as_tensor(table, device=dev)
    return q, kp, vp, lens, pt, extra


def phase_kernels(seed: int) -> dict:
    import torch
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                                  flash_decode_paged_fwd,
                                                  flash_decode_paged_torch,
                                                  flash_decode_torch)
    from repro_torch.kernels.flashbias_attn import (
        flashbias_attention_fwd, flashbias_attention_ragged_fwd,
        flashbias_attention_torch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    worst = {}

    def check(name, got, want, dtype, path=False, wrapper=None, before=0):
        torch.cuda.synchronize()
        if wrapper is not None:
            tc = wrapper.tensor_core_launches - before
            if tc != (dtype == torch.bfloat16):
                raise AssertionError(f"{name}: {tc} tensor-core launches")
        err = float((got.float() - want.float()).abs().max())
        tol = tolerance(dtype, want)
        ok = bool(torch.isfinite(got).all()) and err <= tol
        log("kernels", f"{name}: max_abs_err {err:.3e} (tol {tol:.1e}) "
                       f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version ({err:.3e} > {tol:.1e})")
        if path:
            worst[name.split(" ")[0]] = err

    # prefill kernel: the serving path's shape, then off-path modes
    cases = [("flashbias_attention_fwd path B4 H64 N512 D32 bf16 alibi "
              "causal", 4, 64, 64, 512, 32, torch.bfloat16, "alibi",
              "causal", True)]
    for dtype in (torch.float32, torch.bfloat16):
        for bias in ("alibi", "phi", "none"):
            for mask in ("causal", "local", "none"):
                cases.append((f"flashbias_attention_fwd GQA4:2 N200 D160 "
                              f"{str(dtype)[6:]} {bias} {mask}", 2, 4, 2,
                              200, 160, dtype, bias, mask, False))
    cases.append(("flashbias_attention_fwd GQA8:2 N130 D64 f32 alibi local",
                  1, 8, 2, 130, 64, torch.float32, "alibi", "local", False))
    # the bf16 body off its tiles: N off the 64-row tile at the path's D,
    # D 40 (k-steps of 16 zero-padded, v's 32-column panel cut) and rank 4;
    # grids under 264 blocks split each block's kv tiles over two
    # warpgroups, larger ones take one
    cases += [("flashbias_attention_fwd N130 D32 bf16 alibi causal", 2, 8,
               8, 130, 32, torch.bfloat16, "alibi", "causal", False),
              ("flashbias_attention_fwd GQA4:2 N200 D40 bf16 phi local", 2,
               4, 2, 200, 40, torch.bfloat16, "phi", "local", False),
              ("flashbias_attention_fwd N77 D40 bf16 alibi none", 2, 4, 4,
               77, 40, torch.bfloat16, "alibi", "none", False),
              # a grid of 512 blocks: one warpgroup per block, with phi
              ("flashbias_attention_fwd B4 H16 N512 D64 bf16 phi causal", 4,
               16, 16, 512, 64, torch.bfloat16, "phi", "causal", False)]
    for name, b, h, kvh, n, d, dtype, bias, mask, path in cases:
        q, k, v, extra = prefill_inputs(gen, b, h, kvh, n, d, dtype, bias)
        kw = dict(scale=d ** -0.5, mask_kind=mask, window=48, **extra)
        before = flashbias_attention_fwd.tensor_core_launches
        check(name, flashbias_attention_fwd(q, k, v, **kw),
              flashbias_attention_torch(q, k, v, **kw), dtype, path,
              flashbias_attention_fwd, before)

    # decode kernels (3 and 4). Where a case writes the new token's row
    # (k_new, v_new, as the serve path does) the caches after the call must
    # be bit-equal to the plain version's; every length-0 row must be
    # exactly 0; the path shapes run twice and must be bit-identical.
    def decode_case(name, fn, plain, q, k, v, lens, extra, kw, dtype, path,
                    write):
        b, kvh, _, d = q.shape
        new = {}
        if write:
            new = {"k_new": torch.randn((b, kvh, d), generator=gen,
                                        device="cuda").to(dtype),
                   "v_new": torch.randn((b, kvh, v.shape[-1]), generator=gen,
                                        device="cuda").to(dtype)}

        def run(f):
            kc, vc = k.clone(), v.clone()
            return f(q, kc, vc, lens, *extra, **kw, **new), kc, vc

        got, k_got, v_got = run(fn)
        want, k_want, v_want = run(plain)
        check(name, got, want, dtype, path)
        if bool(got[lens == 0].any()):
            raise AssertionError(f"{name}: rows of length 0 are not 0")
        if write and not (torch.equal(k_got, k_want)
                          and torch.equal(v_got, v_want)):
            raise AssertionError(f"{name}: the caches after the fused row "
                                 f"write differ from the plain version's")
        if path:
            again, _, _ = run(fn)
            torch.cuda.synchronize()
            if not torch.equal(again, got):
                raise AssertionError(f"{name}: two calls on the same inputs "
                                     f"are not bit-identical")
            log("kernels", f"{name}: caches bit-equal to the plain "
                           f"version's, two calls bit-identical")

    # contiguous: the serving path's shape (writing the row), phi mode and
    # GQA, then lengths across the split boundaries (SPLIT_LENGTHS)
    cases = [("flash_decode_fwd path B4 KVH64 G1 S2048 D32 bf16 alibi write",
              4, 64, 1, 2048, 32, torch.bfloat16, "alibi",
              [0, 1, 777, 2048], True, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for bias in ("alibi", "phi", "none"):
            cases.append((f"flash_decode_fwd GQA G4 S1024 D160 "
                          f"{str(dtype)[6:]} {bias}", 4, 2, 4, 1024, 160,
                          dtype, bias, [0, 1, 333, 1024], False, False))
    cases.append(("flash_decode_fwd MHA G1 S512 D32 f32 phi", 3, 8, 1, 512,
                  32, torch.float32, "phi", [512, 5, 0], False, False))
    cases += [(f"flash_decode_fwd splits B{len(SPLIT_LENGTHS)} KVH64 G1 "
               f"S2048 D32 bf16 alibi write", len(SPLIT_LENGTHS), 64, 1,
               2048, 32, torch.bfloat16, "alibi", SPLIT_LENGTHS, False, True),
              ("flash_decode_fwd splits GQA G4 S2048 D160 f32 alibi write",
               len(SPLIT_LENGTHS), 2, 4, 2048, 160, torch.float32, "alibi",
               SPLIT_LENGTHS, False, True),
              ("flash_decode_fwd splits GQA G4 S2048 D160 bf16 phi write",
               len(SPLIT_LENGTHS), 2, 4, 2048, 160, torch.bfloat16, "phi",
               SPLIT_LENGTHS, False, True)]
    for name, b, kvh, g, s, d, dtype, bias, lengths, path, write in cases:
        q, k, v, lens, extra = decode_inputs(gen, b, kvh, g, s, d, dtype,
                                             bias, lengths)
        decode_case(name, flash_decode_fwd, flash_decode_torch, q, k, v,
                    lens, (), dict(scale=d ** -0.5, **extra), dtype, path,
                    write)

    # paged: the paged serving path's shape (phi mode against the shared
    # [1, pos] slab, page size 16, writing the row), then GQA, the other
    # bias modes, a per-kv-head slab and page size 48, then lengths across
    # the split boundaries, one row's write block the sentinel (the write
    # dropped, the clamped page's old row read; that page no row's own)
    cases = [(f"flash_decode_paged_fwd path B4 KVH64 G1 D32 ps{PAGE} bf16 "
              f"alibi-slab write", 4, 64, 1, 32, PAGE, torch.bfloat16,
              "alibi_slab", [0, 1, 777, 2048], True, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for bias in ("alibi_slab", "phi", "phi_kvh", "alibi", "none"):
            cases.append((f"flash_decode_paged_fwd GQA G4 D160 ps48 "
                          f"{str(dtype)[6:]} {bias}", 4, 2, 4, 160, 48,
                          dtype, bias, [0, 1, 333, 1024], False, False))
    cases.append(("flash_decode_paged_fwd MHA G1 D32 ps8 f32 phi_kvh", 3, 8,
                  1, 32, 8, torch.float32, "phi_kvh", [200, 5, 0], False,
                  False))
    cases += [(f"flash_decode_paged_fwd splits B{len(SPLIT_LENGTHS)} KVH64 G1 "
               f"D32 ps{PAGE} bf16 alibi-slab write", len(SPLIT_LENGTHS), 64,
               1, 32, PAGE, torch.bfloat16, "alibi_slab", SPLIT_LENGTHS,
               False, True),
              ("flash_decode_paged_fwd splits GQA G4 D160 ps48 f32 phi write "
               "sentinel", len(SPLIT_LENGTHS), 2, 4, 160, 48, torch.float32,
               "phi", SPLIT_LENGTHS, False, "sentinel")]
    for name, b, kvh, g, d, ps, dtype, bias, lengths, path, write in cases:
        q, kp, vp, lens, pt, extra = paged_inputs(gen, rng, b, kvh, g, d, ps,
                                                  dtype, bias, lengths)
        if write == "sentinel":
            pt = sentinel_write(pt, lengths.index(65), 64 // ps,
                                -(-max(lengths) // ps), kp.shape[1])
        decode_case(name, flash_decode_paged_fwd, flash_decode_paged_torch,
                    q, kp, vp, lens, (pt,), dict(scale=d ** -0.5, **extra),
                    dtype, path, bool(write))

    # ragged attention kernel (kernel 2): the Pairformer path's shape (4
    # slots, H = KVH 4, N = M = 384, D = Dv = R = 96, bf16 q/k/v, float32
    # factors, no mask), then off-path: float32, lengths off the 64-key
    # tile, a whole batch at length 0, rank 8, causal, ALiBi slopes, GQA.
    # Rows of length 0 must come out exactly 0.
    bf, f32 = torch.bfloat16, torch.float32
    path_lens = [PAIR_MAX_LEN, 200, 1, 0]
    cases = [("flashbias_attention_ragged_fwd path B4 H4 N384 D96 R96 bf16 "
              "phi", 4, 4, 4, 384, 96, 96, bf, "phi", "none", path_lens,
              True),
             ("flashbias_attention_ragged_fwd B4 H4 N384 D96 R96 f32 phi",
              4, 4, 4, 384, 96, 96, f32, "phi", "none", path_lens, False),
             ("flashbias_attention_ragged_fwd lengths 333/77/5/0 bf16 phi",
              4, 4, 4, 384, 96, 96, bf, "phi", "none", [333, 77, 5, 0],
              False),
             ("flashbias_attention_ragged_fwd all lengths 0 bf16 phi", 4, 4,
              4, 384, 96, 96, bf, "phi", "none", [0, 0, 0, 0], False),
             ("flashbias_attention_ragged_fwd R8 D64 f32 phi", 4, 4, 4, 200,
              64, 8, f32, "phi", "none", [200, 130, 63, 0], False),
             ("flashbias_attention_ragged_fwd causal bf16 phi", 4, 4, 4, 384,
              96, 96, bf, "phi", "causal", path_lens, False),
             ("flashbias_attention_ragged_fwd GQA8:2 f32 alibi causal", 2, 8,
              2, 130, 64, 0, f32, "alibi", "causal", [130, 65], False),
             ("flashbias_attention_ragged_fwd GQA8:2 bf16 alibi none", 4, 8,
              2, 256, 32, 0, bf, "alibi", "none", [256, 100, 0, 31], False)]
    for name, b, h, kvh, n, d, r, dtype, bias, mask, lengths, path in cases:
        q, k, v, extra = prefill_inputs(gen, b, h, kvh, n, d, dtype, bias,
                                        r=r)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        kw = dict(scale=d ** -0.5, mask_kind=mask)
        before = flashbias_attention_ragged_fwd.tensor_core_launches
        got = flashbias_attention_ragged_fwd(
            q, k, v, extra.get("phi_q"), extra.get("phi_k"),
            extra.get("slopes"), lens, **kw)
        check(name, got, flashbias_attention_torch(q, k, v, lengths=lens,
                                                   **kw, **extra),
              dtype, path, flashbias_attention_ragged_fwd, before)
        if bool(got[lens == 0].any()):
            raise AssertionError(f"{name}: rows of length 0 are not 0")
    return worst


# ---------------------------------------------------------------------------
# phases 3-5: full-width serving, paged serving and parity
# ---------------------------------------------------------------------------

def make_requests(seed: int, vocab: int):
    from repro_torch.serve import SamplingParams
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, PROMPT_MAX + 1, (8,))
    sampled = {2, 6}                 # one in each half of the arrivals
    return [(rng.integers(0, vocab, (int(n),)).astype(np.int32), NEW_TOKENS,
             SamplingParams(0.8, 40, seed=seed + i) if i in sampled
             else SamplingParams()) for i, n in enumerate(lens)]


def launch_counters() -> dict:
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                                  flash_decode_paged_fwd)
    from repro_torch.kernels.flashbias_attn import (
        flashbias_attention_fwd, flashbias_attention_ragged_fwd)
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd
    return {"flashbias_attention_fwd": flashbias_attention_fwd,
            "flash_decode_fwd": flash_decode_fwd,
            "flash_decode_paged_fwd": flash_decode_paged_fwd,
            "flashbias_attention_ragged_fwd": flashbias_attention_ragged_fwd,
            "ssd_scan_fwd": ssd_scan_fwd}


def drive_counted(engine, requests):
    """Drive ``requests`` through ``engine`` with every launch counter set
    to 0 just before and read just after; check every result."""
    import torch
    from repro_torch.launch.serve import drive
    from repro_torch.serve import OK
    counters = reset_counters()
    t0 = time.monotonic()
    rids = drive(engine, requests)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    vocab = engine.model.cfg.vocab
    n_tok = 0
    for rid in rids:
        rec = engine.result(rid)
        if rec.status != OK or rec.size != NEW_TOKENS:
            raise AssertionError(f"request {rid}: {rec!r}")
        if rec.min() < 0 or rec.max() >= vocab:
            raise AssertionError(f"request {rid}: token ids out of range")
        n_tok += rec.size
    return rids, launches, n_tok / wall, wall


def phase_serve(seed: int):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, init_params
    from repro_torch.serve import ServeEngine

    cfg = get_config("gpt2_alibi_15b")
    if cfg.n_layers != N_LAYERS:
        raise AssertionError(f"config has {cfg.n_layers} layers")
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    engine = ServeEngine(get_model(cfg), params, max_len=MAX_LEN,
                         n_slots=SLOTS, prefill_len=PROMPT_MAX,
                         device="cuda")
    del params                       # the engine holds its bf16 copy
    torch.cuda.synchronize()
    log("serve", f"{cfg.name}: {cfg.n_layers} layers, d_model "
                 f"{cfg.d_model}, {cfg.heads_padded} heads x "
                 f"{cfg.resolved_head_dim}, vocab {cfg.vocab_padded}; "
                 f"weights ready in {time.monotonic() - t0:.1f}s")
    requests = make_requests(seed, cfg.vocab)
    rids, launches, tok_s, wall = drive_counted(engine, requests)
    stats = engine.stats()
    want = {"flashbias_attention_fwd": N_LAYERS * stats["prefill_waves"],
            "flash_decode_fwd": N_LAYERS * stats["decode_steps"],
            "flash_decode_paged_fwd": 0,
            "flashbias_attention_ragged_fwd": 0, "ssd_scan_fwd": 0}
    log("serve", f"{len(rids)} requests OK x {NEW_TOKENS} tokens in "
                 f"{wall:.2f}s ({tok_s:.1f} tok/s); "
                 f"{stats['prefill_waves']} prefill waves, "
                 f"{stats['decode_steps']} decode steps; launches {launches}")
    if launches != want or not launches["flash_decode_fwd"]:
        raise AssertionError(f"kernel launches {launches} != {want}")
    check_tensor_core("serve")
    return engine, requests, launches, tok_s


def phase_paged(engine, requests):
    """The same requests through a paged engine (page size 16, lazy
    reservation) on the same weights. The pool holds the first wave's
    prompt pages and one more: the first page grown takes the spare, the
    next finds the pool dry and preempts."""
    from repro_torch.serve import ServeEngine
    first = sum(-(-p.size // PAGE) for p, _, _ in requests[:SLOTS])
    paged = ServeEngine(engine.model, engine.backend.params, max_len=MAX_LEN,
                        n_slots=SLOTS, prefill_len=PROMPT_MAX,
                        page_size=PAGE, n_pages=first + 1,
                        pages_per_slot=MAX_LEN // PAGE, device="cuda")
    rids, launches, tok_s, wall = drive_counted(paged, requests)
    stats, pages = paged.stats(), paged.page_stats()
    want = {"flashbias_attention_fwd": N_LAYERS * stats["prefill_waves"],
            "flash_decode_fwd": 0,
            "flash_decode_paged_fwd": N_LAYERS * stats["decode_steps"],
            "flashbias_attention_ragged_fwd": 0, "ssd_scan_fwd": 0}
    log("paged", f"{len(rids)} requests OK x {NEW_TOKENS} tokens in "
                 f"{wall:.2f}s ({tok_s:.1f} tok/s); "
                 f"{stats['prefill_waves']} prefill waves, "
                 f"{stats['decode_steps']} decode steps; launches "
                 f"{launches}; pages {pages}")
    if launches != want or not launches["flash_decode_paged_fwd"]:
        raise AssertionError(f"kernel launches {launches} != {want}")
    check_tensor_core("paged")
    if pages["grown"] < 1 or pages["preemptions"] < 1:
        raise AssertionError(f"the pool of {pages['n_pages']} pages neither "
                             f"grew and preempted: {pages}")
    if pages["n_free"] != pages["n_pages"]:
        raise AssertionError(f"pages left in use after the drain: {pages}")
    return launches, tok_s, pages


def page_cap(longest: int) -> int:
    """The serve engine's page bound: pages of ``longest`` rounded up to a
    power of two."""
    need, cap = -(-longest // PAGE), 1
    while cap < need:
        cap *= 2
    return cap


def paged_copy(model, cache, lengths, extra: int):
    """A paged cache holding the contiguous wave ``cache``: each row gets
    the pages of its length plus ``extra`` positions, in a random order."""
    rng = np.random.default_rng(7)
    need = [-(-(int(n) + extra) // PAGE) for n in lengths]
    n_pages = sum(need) + 2
    order = rng.permutation(n_pages)
    tables = np.full((SLOTS, MAX_LEN // PAGE), n_pages, np.int64)
    for i, n in enumerate(need):
        tables[i, :n] = order[sum(need[:i]):sum(need[:i]) + n]
    paged = model.init_paged_cache(SLOTS, n_pages, PAGE, MAX_LEN // PAGE,
                                   device="cuda")
    return model.insert_paged(paged, cache, np.arange(SLOTS), tables)


PARITY_PAIRS = (("cuda", "torch"), ("paged_cuda", "paged_torch"),
                ("paged_cuda", "cuda"))


def phase_parity(engine, requests):
    """The first wave again, on the card: prefill, then 4 greedy decode
    steps fed the contiguous kernel path's tokens, through four paths —
    contiguous and paged caches, each with impl="cuda" and impl="torch".
    The kernel path is held against the plain path on both caches, and the
    paged kernel path against the contiguous one. Then decode steps of
    both kernel paths are traced."""
    import torch
    from repro_torch.models import get_model

    cfg = engine.model.cfg
    params = engine.backend.params
    wave = requests[:SLOTS]
    toks = np.zeros((SLOTS, PROMPT_MAX), np.int64)
    lengths = np.array([p.size for p, _, _ in wave], np.int32)
    for i, (p, _, _) in enumerate(wave):
        toks[i, :p.size] = p
    batch = {"tokens": torch.as_tensor(toks, device="cuda")}
    lens = torch.as_tensor(lengths, device="cuda")
    models = {impl: get_model(cfg.replace(attn_impl=impl))
              for impl in ("cuda", "torch")}
    worst = {pair: 0.0 for pair in PARITY_PAIRS}
    agree = {pair: 0 for pair in PARITY_PAIRS}
    logits, caches = {}, {}
    with torch.no_grad():
        for impl, m in models.items():
            logits[impl], caches[impl] = m.prefill(params, batch,
                                                   max_len=MAX_LEN,
                                                   lengths=lens)
            logits[f"paged_{impl}"] = logits[impl]
            caches[f"paged_{impl}"] = paged_copy(m, caches[impl], lengths,
                                                 4 + TRACE_STEPS + 1)
        for step in range(5):
            top = {}
            for name, lg in logits.items():
                lg = lg[:, 0, :cfg.vocab].float()
                top[name] = (lg, lg.argmax(-1))
            parts = []
            for a, b in PARITY_PAIRS:
                err = float((top[a][0] - top[b][0]).abs().max())
                same = int((top[a][1] == top[b][1]).sum())
                worst[(a, b)] = max(worst[(a, b)], err)
                agree[(a, b)] += same
                parts.append(f"{a} vs {b} {err:.3e} ({same}/{SLOTS})")
            log("parity", f"{'prefill' if step == 0 else f'decode {step}'}: "
                          f"max |logits gap| (greedy agree) "
                          + "; ".join(parts))
            if step == 4:
                break
            nxt = top["cuda"][1][:, None]
            cap = page_cap(int(lengths.max()) + step + 2)
            for name in logits:
                m = models[name.removeprefix("paged_")]
                kw = {"max_pages": cap} if name.startswith("paged") else {}
                logits[name], caches[name] = m.decode(params, caches[name],
                                                      nxt, **kw)
        decode_lengths = caches["cuda"]["length"].clone()
    for a, b in PARITY_PAIRS:
        log("parity", f"{a} vs {b}: worst |logits| gap "
                      f"{worst[(a, b)]:.3e} (tol {LOGIT_TOL}); greedy "
                      f"agreement {agree[(a, b)]}/{5 * SLOTS}")
        if not worst[(a, b)] <= LOGIT_TOL:
            raise AssertionError(f"{a} and {b} paths disagree: "
                                 f"{worst[(a, b)]:.3e}")
    for name in ("torch", "paged_torch"):
        del caches[name]
    torch.cuda.empty_cache()
    cap = page_cap(int(lengths.max()) + 4 + TRACE_STEPS + 1)
    traces = trace_decode(models["cuda"], params, nxt, {
        "contiguous": (caches["cuda"], {}),
        "paged": (caches["paged_cuda"], {"max_pages": cap})})
    del caches
    torch.cuda.empty_cache()
    return traces, decode_lengths


INDEX_KERNELS = ("index", "gather", "scatter")
TRACE_ROUNDS, ROUND_STEPS = 6, 3
# steps per path: the timed rounds, then each profile try's warm-up step
# and 3 profiled steps
TRACE_STEPS = TRACE_ROUNDS * ROUND_STEPS + PROFILE_TRIES * (1 + 3)


def trace_decode(model, params, tokens, paths: dict) -> dict:
    """Decode steps of the kernel path on each cache of ``paths`` ({label:
    (cache, decode kwargs)}): timed on the host clock in alternating rounds
    of 3 steps (A B B A ..., each step ending in a synchronize), so both
    see the same host; then 3 steps each under torch.profiler for the
    device's busy time per step (the sum of its kernels' and copies'
    durations), the kernels that hold it longest, and the indexing kernels
    (gathers and scatters of cache rows, page ids and the factor slab)."""
    import torch

    labels = list(paths)
    caches = {label: cache for label, (cache, _) in paths.items()}
    walls = {label: [] for label in labels}

    def steps(label, n):
        kw = paths[label][1]
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            _, caches[label] = model.decode(params, caches[label], tokens,
                                            **kw)
            torch.cuda.synchronize()
            walls[label].append((time.monotonic() - t0) * 1e3)

    traces = {}
    with torch.no_grad():
        for r in range(TRACE_ROUNDS):
            for label in (labels if r % 2 == 0 else labels[::-1]):
                steps(label, ROUND_STEPS)
        for label in labels:
            def step():
                _, caches[label] = model.decode(params, caches[label],
                                                tokens, **paths[label][1])
            kernels = profiled(step, 3, uniform=False)
            step_ms = float(np.median(walls[label]))
            busy_ms = sum(device_us(e) for e in kernels) / 3 / 1e3
            index = [e for e in kernels
                     if any(w in e.key.lower() for w in INDEX_KERNELS)]
            traces[label] = t = {
                "step_ms": step_ms, "busy_ms": busy_ms,
                "idle_share": 1 - busy_ms / step_ms,
                "index_calls": sum(e.count for e in index) // 3,
                "index_ms": sum(device_us(e) for e in index) / 3 / 1e3}
            log("trace", f"{label} decode step {step_ms:.3f} ms on the host "
                         f"clock (median of {len(walls[label])}, rounds "
                         f"alternating with the other path); device busy "
                         f"{busy_ms:.3f} ms/step, idle share "
                         f"{t['idle_share']:.3f}; indexing kernels "
                         f"{t['index_calls']} calls, {t['index_ms']:.3f} "
                         f"ms/step")
            for e in sorted(kernels, key=device_us, reverse=True)[:8]:
                log("trace", f"  {device_us(e) / 3 / 1e3:8.3f} ms/step "
                             f"{e.count // 3:5d} calls/step  {e.key[:90]}")
            for e in host_ops(step, 3):
                log("trace", f"  host {e.self_cpu_time_total / 3 / 1e3:8.3f} "
                             f"ms/step {e.count // 3:5d} calls/step  "
                             f"{e.key[:70]}")
    return traces


# ---------------------------------------------------------------------------
# phase 6: times and bounds
# ---------------------------------------------------------------------------

def phase_times(engine, decode_lengths, card: str):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                                  flash_decode_paged_fwd,
                                                  flash_decode_paged_torch,
                                                  flash_decode_torch)
    from repro_torch.kernels.flashbias_attn import (
        flashbias_attention_fwd, flashbias_attention_torch)

    gen = torch.Generator(device="cuda").manual_seed(1)
    slopes = engine.backend.params["layers"]["attn"]["slopes"][0].float()
    b, h, n, d = SLOTS, slopes.shape[0], PROMPT_MAX, 32
    scale = d ** -0.5
    bf = torch.bfloat16
    out = {}

    # prefill kernel at the path shape: alibi + causal, bf16
    q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda").to(bf)
               for _ in range(3))
    kw = dict(slopes=slopes, scale=scale, mask_kind="causal")
    pos = torch.arange(n, device="cuda")
    mask = slopes[:, None, None] * (pos[None, None, :] - pos[None, :, None])
    mask = mask.masked_fill(pos[None, None, :] > pos[None, :, None],
                            -torch.inf).to(bf)[None]
    pairs = n * (n + 1) // 2
    bytes_ = (4 * b * h * n * d) * 2 + h * 4
    flops = b * h * pairs * 4 * d
    kernel = (lambda: flashbias_attention_fwd(q, k, v, **kw))
    out["flashbias_attention_fwd"] = dict(
        ms=device_ms(kernel),
        plain_ms=device_ms(lambda: flashbias_attention_torch(q, k, v, **kw)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale)),
        **bound(bytes_, flops))
    events = {"flashbias_attention_fwd": event_ms(kernel)}

    # decode kernel at the path shape: alibi, bf16, this run's lengths
    s = MAX_LEN
    kvh = h
    qd = torch.randn((b, kvh, 1, d), generator=gen, device="cuda").to(bf)
    kc, vc = (torch.randn((b, kvh, s, d), generator=gen,
                          device="cuda").to(bf) for _ in range(2))
    lens = decode_lengths.to(torch.int32).contiguous()
    kwd = dict(slopes=slopes.reshape(kvh, 1), scale=scale)
    kpos = torch.arange(s, device="cuda")
    dmask = slopes[None, :, None, None] * (
        kpos[None, None, None, :] - (lens - 1)[:, None, None, None]).float()
    dmask = dmask.masked_fill(
        kpos[None, None, None, :] >= lens[:, None, None, None],
        -torch.inf).to(bf)
    live = int(lens.sum())
    # each call writes the new token's row, as the serve path does: k_new
    # and v_new read once and written to the caches once (ROW_BYTES)
    new = {"k_new": torch.randn((b, kvh, d), generator=gen,
                                device="cuda").to(bf),
           "v_new": torch.randn((b, kvh, d), generator=gen,
                                device="cuda").to(bf)}
    row_bytes = 2 * 2 * b * kvh * d * 2
    bytes_ = (live * kvh * 2 * d * 2 + 2 * b * kvh * d * 2 + b * 4 + h * 4
              + row_bytes)
    flops = live * kvh * 4 * d
    kernel = (lambda: flash_decode_fwd(qd, kc, vc, lens, **kwd, **new))
    out["flash_decode_fwd"] = dict(
        ms=device_ms(kernel),
        plain_ms=device_ms(lambda: flash_decode_torch(qd, kc, vc, lens,
                                                      **kwd, **new)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qd, kc, vc, attn_mask=dmask, scale=scale)),
        **bound(bytes_, flops))
    events["flash_decode_fwd"] = event_ms(kernel)

    # paged decode kernel at the paged path shape: phi mode against the
    # shared [1, pos] slab, page size 16, pages in random order, the serve
    # engine's table width, bf16, this run's lengths, each call writing the
    # row. Library: gather each row's pages, then SDPA with a float ALiBi
    # mask (two calls).
    lengths = [int(n) for n in lens.tolist()]
    qp, kp, vp, lens_p, pt, extra = paged_inputs(
        gen, np.random.default_rng(2), b, kvh, 1, d, PAGE, bf, "alibi_slab",
        lengths)
    pt = widen_table(pt, MAX_LEN // PAGE, kp.shape[1])
    n_live = -(-max(lengths) // PAGE)
    last = (lens_p.long() - 1).clamp(min=0) // PAGE
    pages = pt.long()[:, :n_live].gather(
        1, torch.minimum(torch.arange(n_live, device="cuda")[None],
                         last[:, None]))
    kvp = torch.stack([kp, vp])                  # (2, KVH, n_pages, ps, d)
    pmask = dmask[..., :n_live * PAGE].contiguous()

    def gather_sdpa():
        kv = kvp[:, :, pages].reshape(2, kvh, b, n_live * PAGE, d)
        return F.scaled_dot_product_attention(
            qp, kv[0].transpose(0, 1),
            kv[1].transpose(0, 1), attn_mask=pmask, scale=scale)

    n_pages_read = sum(-(-n // PAGE) for n in lengths)
    bytes_ = (live * kvh * 2 * d * 2 + live * 2 * 4 + 2 * b * kvh * d * 2
              + b * kvh * 2 * 4 + b * 4 + n_pages_read * 4 + row_bytes)
    flops = live * kvh * (4 * d + 4)
    kernel = (lambda: flash_decode_paged_fwd(qp, kp, vp, lens_p, pt,
                                             scale=scale, **extra, **new))
    out["flash_decode_paged_fwd"] = dict(
        ms=device_ms(kernel),
        plain_ms=device_ms(lambda: flash_decode_paged_torch(
            qp, kp, vp, lens_p, pt, scale=scale, **extra, **new)),
        library_ms=device_ms(gather_sdpa),
        **bound(bytes_, flops))
    events["flash_decode_paged_fwd"] = event_ms(kernel)
    library = {"flashbias_attention_fwd": "SDPA, dense float mask",
               "flash_decode_fwd": "SDPA, float mask, no row write",
               "flash_decode_paged_fwd": "page gather + SDPA with a float "
                                         "mask, two calls, no row write"}
    for name, t in out.items():
        log("times", f"{name} (device time per call): kernel "
                     f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                     f"library ({library[name]}) {t['library_ms']:.4f} ms, "
                     f"bound "
                     f"{t['bound_ms']:.4f} ms ({t['bound_by']}); kernel "
                     f"between CUDA events, host gaps included, "
                     f"{events[name]:.4f} ms [{card}]")
    return out


# ---------------------------------------------------------------------------
# phases 7-9: Pairformer serving, parity and times
# ---------------------------------------------------------------------------

def make_complexes(seed: int):
    """8 complexes as (features, refinement steps, sampling): n_res drawn
    in [96, 384], the first at exactly 384 and the second off the 64-residue
    tile; 64-wide features (the ``single_in`` stub is (64, d)); 4-8 steps."""
    from repro_torch.serve import SamplingParams
    rng = np.random.default_rng(seed + 100)
    lens = rng.integers(96, PAIR_MAX_LEN + 1, (8,))
    lens[0] = PAIR_MAX_LEN
    if lens[1] % 64 == 0:
        lens[1] += 17 if lens[1] < 300 else -17
    steps = rng.integers(4, 9, (8,))
    return [(rng.standard_normal((int(n), 64)).astype(np.float32), int(t),
             SamplingParams()) for n, t in zip(lens, steps)]


def pair_wave(complexes):
    """A full admission wave of the first PAIR_SLOTS complexes: features
    padded to (PAIR_SLOTS, PAIR_MAX_LEN, 64) and their lengths, on the
    card."""
    import torch
    feats = np.zeros((PAIR_SLOTS, PAIR_MAX_LEN, 64), np.float32)
    lengths = np.zeros((PAIR_SLOTS,), np.int32)
    for i, (f, _, _) in enumerate(complexes[:PAIR_SLOTS]):
        feats[i, :f.shape[0]] = f
        lengths[i] = f.shape[0]
    return ({"feats": torch.as_tensor(feats, device="cuda")},
            torch.as_tensor(lengths, device="cuda"))


def phase_pair_serve(seed: int):
    """Pairformer-lite at full width through ServeEngine (SVD mode), with
    every launch counter set to 0 just before the drive and read after."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import drive
    from repro_torch.models import get_model, init_params
    from repro_torch.serve import OK, ServeEngine

    cfg = get_config("pairformer_lite")
    if cfg.n_layers != PAIR_LAYERS:
        raise AssertionError(f"config has {cfg.n_layers} layers")
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    engine = ServeEngine(get_model(cfg), params, max_len=PAIR_MAX_LEN,
                         n_slots=PAIR_SLOTS, device="cuda")
    del params                       # the engine holds its cast copy
    torch.cuda.synchronize()
    log("pair", f"{cfg.name}: {cfg.n_layers} layers, d_single "
                f"{cfg.d_model}, d_pair {cfg.d_pair}, {cfg.n_heads} heads x "
                f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, rank "
                f"{cfg.bias_rank}, {cfg.dtype}; weights ready in "
                f"{time.monotonic() - t0:.1f}s")
    complexes = make_complexes(seed)
    counters = reset_counters()
    t0 = time.monotonic()
    rids = drive(engine, complexes)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    stats = engine.stats()
    for rid, (f, _, _) in zip(rids, complexes):
        rec = engine.result(rid)
        if rec.status != OK or rec.shape != (f.shape[0], cfg.d_model):
            raise AssertionError(f"complex {rid}: {rec.status} "
                                 f"{rec.shape}")
        if not np.isfinite(rec).all():
            raise AssertionError(f"complex {rid}: non-finite result")
    want = {name: 0 for name in counters}
    want["flashbias_attention_ragged_fwd"] = PAIR_LAYERS * (
        stats["prefill_waves"] + stats["decode_steps"])
    n_steps = sum(t for _, t, _ in complexes)
    log("pair", f"{len(rids)} complexes OK (n_res "
                f"{[f.shape[0] for f, _, _ in complexes]}, "
                f"{n_steps} refinement steps in all) in {wall:.2f}s; "
                f"{stats['prefill_waves']} admission waves, "
                f"{stats['decode_steps']} engine steps; launches {launches}")
    if launches != want or not launches["flashbias_attention_ragged_fwd"]:
        raise AssertionError(f"kernel launches {launches} != {want}")
    check_tensor_core("pair")
    return engine, complexes, rids, launches


def bf16_ulp(x):
    """The bf16 spacing at |x| (8-bit significand): 2^(floor(log2|x|) - 7)."""
    import torch
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def ragged_attention(q, k, v, phi_q, phi_k, slopes=None, lengths=None, *,
                     scale, mask_kind="none", window=0, acc=None, skip=None,
                     bias_scale=1.0):
    """The pair path's ragged attention (factor bias, no mask, key bound
    ``lengths``) computed in ``acc``, optionally with a deliberate fault:
    keys in ``skip = (lo, hi)`` dropped, or the bias term scaled by
    ``bias_scale``. Takes both calling conventions of the ragged path (the
    kernel wrapper's and the plain version's). Rows with no key give 0."""
    import torch
    from repro_torch.core.attention import DEFAULT_MASK_VALUE
    if slopes is not None or mask_kind != "none":
        raise ValueError("the pair path attends with factors only, no mask")
    logits = (torch.einsum("bhnd,bhmd->bhnm", q.to(acc), k.to(acc)) * scale
              + bias_scale * torch.einsum("bhnr,bhmr->bhnm", phi_q.to(acc),
                                          phi_k.to(acc)))
    keys = torch.arange(k.shape[2], device=q.device)
    live = keys[None, :] < lengths.reshape(-1, 1)
    if skip is not None:
        live = live & ~((keys >= skip[0]) & (keys < skip[1]))[None, :]
    live = live[:, None, None, :]
    logits = logits.masked_fill(~live, DEFAULT_MASK_VALUE)
    o = torch.einsum("bhnm,bhmd->bhnd", torch.softmax(logits, -1), v.to(acc))
    return (o * live.any(-1, keepdim=True)).to(q.dtype)


@contextlib.contextmanager
def patched(module, name, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def phase_pair_parity(engine, complexes, rids, seed: int) -> list:
    """The first wave's admission and PAIR_STEPS refinement steps through
    the kernel path and the plain path on the card — bf16 in SVD mode and
    in factor-MLP mode, and float32 in SVD mode — with every ragged kernel
    call held in situ against the plain version on its inputs, and the
    final single reps compared on valid rows against the float64 control
    of the same mode; the check run on deliberate faults of the attention,
    each of which it must reject; then the first complex served alone
    through a 4-slot engine, bit-equal to its batched result. Returns the
    failed checks (every check runs and prints; ``main`` fails the run at
    its end if any did, after the remaining phases' measurements)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.models.common import materialize, stack_layers, tree_map
    from repro_torch.models.pairformer import factor_mlp_template
    from repro_torch.serve import ServeEngine

    cfg, params = engine.model.cfg, engine.backend.params
    batch, lens = pair_wave(complexes)
    valid = (torch.arange(PAIR_MAX_LEN, device="cuda")[None, :]
             < lens[:, None])
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    factors = materialize(stack_layers(factor_mlp_template(cfg, 256),
                                       cfg.n_layers), gen, device="cuda")
    params32 = tree_map(lambda x: x.float(), params)
    plain = ops.flashbias_attention_torch
    kernel = ops.flashbias_attention_ragged_fwd
    scale = cfg.resolved_head_dim ** -0.5

    def final_s(c, p, fac, impl):
        m = get_model(c.replace(attn_impl=impl))
        _, cache = m.prefill(p, batch, max_len=PAIR_MAX_LEN, lengths=lens,
                             factors=fac)
        for _ in range(PAIR_STEPS):
            cache = m.decode(p, cache)
        return cache["s"].float()[valid].flatten()

    def in_situ(fn, calls):
        """``fn`` with each call's output held against the plain version on
        the same inputs: (max |diff|, tolerance, diff in bf16 ulps of the
        worst element) appended to ``calls``."""
        def call(q, k, v, phi_q, phi_k, slopes=None, lengths=None, **kw):
            got = fn(q, k, v, phi_q, phi_k, slopes, lengths, **kw)
            want = plain(q, k, v, phi_q, phi_k, slopes, lengths=lengths, **kw)
            diff = (got.float() - want.float()).abs().flatten()
            worst = int(diff.argmax())
            ref = want.float().flatten()[worst:worst + 1]
            calls.append((float(diff[worst]), tolerance(want.dtype, want),
                          float(diff[worst] / bf16_ulp(ref)[0])))
            return got
        return call

    def in_situ_log(label, calls):
        """Logs the in-situ record of one run; True if every call was
        within its tolerance."""
        if len(calls) != PAIR_LAYERS * (1 + PAIR_STEPS):
            raise AssertionError(f"{label}: {len(calls)} ragged calls seen")
        worst = max(calls, key=lambda c: c[0] / c[1])
        over = sum(err > tol for err, tol, _ in calls)
        log("pair-parity", f"{label}: in situ, {len(calls)} ragged calls "
                           f"against the plain version on their inputs: "
                           f"worst {worst[0]:.3e} (tol {worst[1]:.1e}, "
                           f"{worst[2]:.1f} bf16 ulps of the element); "
                           f"{over} calls over the tolerance")
        return over == 0

    def gap(got, want):
        diff = (got - want).abs()
        worst = int(diff.argmax())
        return (float(diff.max()), float(want.square().mean().sqrt()),
                float(diff[worst] / bf16_ulp(want[worst])),
                int((diff > 0).sum()), bool(torch.isfinite(got).all()))

    def ratio(a, b):
        return a / b if b else (0.0 if a == 0 else float("inf"))

    def gap_log(label, g):
        log("pair-parity", f"{label}: max |s gap| {g[0]:.4e} = "
                           f"{g[0] / g[1]:.4f} x RMS(s) {g[1]:.4f} "
                           f"({g[2]:.1f} bf16 ulps of the worst element); "
                           f"elements differing {g[3]}"
                           f"{'' if g[4] else '; NON-FINITE values'}")

    failed, floor = [], {}
    with torch.no_grad():
        for label, fac in (("bf16 svd", None), ("bf16 mlp", factors)):
            want = final_s(cfg, params, fac, "torch")
            calls = []
            with patched(ops, "flashbias_attention_ragged_fwd",
                         in_situ(kernel, calls)):
                got = final_s(cfg, params, fac, "cuda")
            with patched(ops, "flashbias_attention_torch", functools.partial(
                    ragged_attention, acc=torch.float64)):
                control = final_s(cfg, params, fac, "torch")
            ok = in_situ_log(f"{label} kernel path", calls)
            g, gc = gap(got, want), gap(control, want)
            gap_log(f"{label} kernel path vs plain path", g)
            gap_log(f"{label} control: plain path with float64 attention vs "
                    f"plain path", gc)
            ok_e2e = g[4] and g[0] <= PAIR_CONTROL_MULT * gc[0]
            log("pair-parity", f"{label}: kernel gap / control gap "
                               f"{ratio(g[0], gc[0]):.3f} (at most "
                               f"{PAIR_CONTROL_MULT}); in situ "
                               f"{'ok' if ok else 'FAIL'}, end to end "
                               f"{'ok' if ok_e2e else 'FAIL'}")
            if not (ok and ok_e2e):
                failed.append(f"pair parity {label}: in situ ok {ok}, gap "
                              f"{g[0]:.4e} vs {PAIR_CONTROL_MULT} x control "
                              f"{gc[0]:.4e}")
            floor[label] = (want, gc[0])
        want = final_s(cfg.replace(dtype="float32"), params32, None, "torch")
        calls = []
        with patched(ops, "flashbias_attention_ragged_fwd",
                     in_situ(kernel, calls)):
            got = final_s(cfg.replace(dtype="float32"), params32, None,
                          "cuda")
        ok = in_situ_log("f32 svd kernel path", calls)
        g = gap(got, want)
        gap_log("f32 svd kernel path vs plain path", g)
        if not (ok and g[4] and g[0] <= PAIR_TOL_F32 * g[1]):
            log("pair-parity", "f32 svd: FAIL")
            failed.append(f"pair parity f32 svd: in situ ok {ok}, gap "
                          f"{g[0]:.4e} > {PAIR_TOL_F32} x RMS(s) {g[1]:.4e}")
        # the check on deliberate faults of the plain attention (bf16, SVD
        # mode): each must be rejected, in situ or end to end
        want, control_gap = floor["bf16 svd"]
        for name, skip, scaled in PAIR_FAULTS:
            calls = []
            fault = functools.partial(
                ragged_attention, acc=torch.float32, skip=skip,
                bias_scale=scale if scaled else 1.0)
            with patched(ops, "flashbias_attention_torch",
                         in_situ(fault, calls)):
                got = final_s(cfg, params, None, "torch")
            seen = not in_situ_log(f"fault '{name}'", calls)
            g = gap(got, want)
            gap_log(f"fault '{name}' vs plain path", g)
            seen_e2e = not (g[4] and g[0] <= PAIR_CONTROL_MULT * control_gap)
            log("pair-parity", f"fault '{name}': rejected in situ {seen}, "
                               f"end to end {seen_e2e} (gap / control gap "
                               f"{ratio(g[0], control_gap):.3f})")
            if not (seen or seen_e2e):
                failed.append(f"pair parity check passes the fault '{name}'")
    torch.cuda.empty_cache()
    feats, steps, _ = complexes[0]
    alone = ServeEngine(engine.model, params, max_len=PAIR_MAX_LEN,
                        n_slots=PAIR_SLOTS, device="cuda")
    rid = alone.submit(feats, steps)
    alone.run()
    got, want = alone.result(rid), engine.result(rids[0])
    same = bool(np.array_equal(got, want))
    log("pair-parity", f"complex 0 (n_res {feats.shape[0]}, {steps} steps) "
                       f"alone through a {PAIR_SLOTS}-slot engine: "
                       f"{'bit-equal' if same else 'DIFFERS'} to its batched "
                       f"result (max |gap| "
                       f"{float(np.abs(got - want).max()):.3e})")
    if not same:
        failed.append("pair batched != alone at the same slot count")
    del alone
    torch.cuda.empty_cache()
    return failed


STEP_MODES = {"factored": "flashbias", "dense_recompute": "dense_recompute",
              "dense": "dense"}
PAIR_ROUNDS, PAIR_ROUND_STEPS = 4, 2


def profile_steps(fn, n: int):
    """Run ``fn`` n times under torch.profiler (every call runs the same
    kernels); returns (device busy ms per call, the device rows of the
    profile)."""
    kernels = profiled(fn, n)
    return sum(device_us(e) for e in kernels) / n / 1e3, kernels


def phase_pair_times(engine, complexes, card: str) -> dict:
    """Kernel 2 against its plain version and the library call at the path
    shape; the admission wave; a refinement step of 4 full slots in the
    three cache modes, in alternating rounds; one factored step traced."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flashbias_attn import (
        flashbias_attention_ragged_fwd, flashbias_attention_torch)
    from repro_torch.models import get_model

    cfg, params = engine.model.cfg, engine.backend.params
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    b, h, n, d = PAIR_SLOTS, cfg.n_heads, PAIR_MAX_LEN, cfg.resolved_head_dim
    r = min(cfg.bias_rank, n)
    scale = d ** -0.5
    lengths = [f.shape[0] for f, _, _ in complexes[:PAIR_SLOTS]]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda").to(bf)
               for _ in range(3))
    pq, pk = (torch.randn((b, h, n, r), generator=gen, device="cuda")
              for _ in range(2))
    # library: the bias materialized from the float32 factors the kernel
    # reads, with the length mask folded in (one baddbmm into an additive
    # 0 / -inf key mask), cast once to the attention's bf16, then SDPA with
    # that float mask — the paper's "attention with bias" baseline, three
    # calls
    kpos = torch.arange(n, device="cuda")
    keymask = torch.zeros((b, h, 1, n), device="cuda").masked_fill(
        kpos >= lens[:, None, None, None], -torch.inf)
    keymask = keymask.reshape(b * h, 1, n).contiguous()
    pq3 = pq.reshape(b * h, n, r)
    pk3t = pk.reshape(b * h, n, r).transpose(1, 2)

    def library():
        mask = torch.baddbmm(keymask, pq3, pk3t).view(b, h, n, n)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask.to(bf),
                                              scale=scale)

    live = sum(lengths)
    bytes_ = (2 * b * h * n * d * 2 + 2 * live * h * d * 2 + live * h * r * 4
              + b * h * n * r * 4 + b * 4)
    flops = n * live * h * 2 * (d + r + d)
    kernel = (lambda: flashbias_attention_ragged_fwd(
        q, k, v, pq, pk, None, lens, scale=scale))
    out = dict(ms=device_ms(kernel),
               plain_ms=device_ms(lambda: flashbias_attention_torch(
                   q, k, v, pq, pk, scale=scale, lengths=lens)),
               library_ms=device_ms(library), **bound(bytes_, flops))
    log("pair-times", f"flashbias_attention_ragged_fwd (device time per "
                      f"call, B{b} H{h} N=M{n} D=Dv=R{d}, lengths "
                      f"{lengths}): kernel {out['ms']:.4f} ms, plain "
                      f"{out['plain_ms']:.4f} ms, library (float32 bias "
                      f"baddbmm, cast to bf16, SDPA with that float mask, "
                      f"three calls) "
                      f"{out['library_ms']:.4f} ms, bound "
                      f"{out['bound_ms']:.4f} ms ({out['bound_by']}); "
                      f"kernel between CUDA events, host gaps included, "
                      f"{event_ms(kernel):.4f} ms [{card}]")
    del q, k, v, pq, pk, pq3, pk3t
    torch.cuda.empty_cache()

    # four full slots (n_res 384 each): the admission wave, then one slot
    # cache per mode
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((b, n, 64)).astype(np.float32)
    batch = {"feats": torch.as_tensor(feats, device="cuda")}
    full = torch.full((b,), n, dtype=torch.int32, device="cuda")
    models = {label: get_model(cfg.replace(bias_mode=mode))
              for label, mode in STEP_MODES.items()}
    caches = {}
    with torch.no_grad():
        for label, m in models.items():
            torch.cuda.synchronize()
            t0 = time.monotonic()
            _, wave = m.prefill(params, batch, max_len=n, lengths=full)
            torch.cuda.synchronize()
            wave_ms = (time.monotonic() - t0) * 1e3
            cache = m.insert_cache(m.init_cache(b, n, device="cuda"), wave,
                                   np.arange(b))
            caches[label] = cache
            del wave
            torch.cuda.empty_cache()
            log("pair-times", f"{label}: admission wave of {b} x {n} "
                              f"residues {wave_ms:.1f} ms on the host clock "
                              f"[{card}]")
        fm = models["factored"]
        busy, kernels = profile_steps(
            lambda: fm.prefill(params, batch, max_len=n, lengths=full), 1)
        log("pair-times", f"factored admission wave: device busy "
                          f"{busy:.1f} ms; top kernels:")
        for e in sorted(kernels, key=device_us, reverse=True)[:6]:
            log("pair-times", f"  {device_us(e) / 1e3:9.3f} ms {e.count:6d} "
                              f"calls  {e.key[:80]}")
        torch.cuda.empty_cache()

        walls = {label: [] for label in models}

        def steps(label, count):
            for _ in range(count):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                caches[label] = models[label].decode(params, caches[label])
                torch.cuda.synchronize()
                walls[label].append((time.monotonic() - t0) * 1e3)

        labels = list(models)
        for label in labels:                       # warm-up
            steps(label, 1)
        for label in labels:
            walls[label].clear()
        for rnd in range(PAIR_ROUNDS):
            for label in (labels if rnd % 2 == 0 else labels[::-1]):
                steps(label, PAIR_ROUND_STEPS)
        step = {}
        for label in labels:
            busy, kernels = profile_steps(
                lambda: caches.__setitem__(label, models[label].decode(
                    params, caches[label])), 3)
            wall = float(np.median(walls[label]))
            step[label] = {"step_ms": wall, "busy_ms": busy,
                           "idle_share": 1 - busy / wall}
            log("pair-times", f"{label} refinement step ({b} x {n}, "
                              f"{cfg.n_layers} layers): "
                              f"{wall:.3f} ms on the host clock (median of "
                              f"{len(walls[label])}, rounds alternating "
                              f"between the modes); device busy {busy:.3f} "
                              f"ms/step, idle share "
                              f"{1 - busy / wall:.3f} [{card}]")
            if label == "factored":
                for e in sorted(kernels, key=device_us, reverse=True)[:8]:
                    log("pair-times", f"  {device_us(e) / 3 / 1e3:8.3f} "
                                      f"ms/step {e.count // 3:5d} calls/step"
                                      f"  {e.key[:80]}")
    del caches
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 10-12: Mamba2 SSM serving, parity and times
# ---------------------------------------------------------------------------

def ssd_tolerance(dtype, ref) -> float:
    """float32: the order of float32 sums of up to chunk x N terms, 1e-4 at
    the output's scale. bfloat16 y: both sides round one float32 result
    once, so 2 bf16 ulps at the output's scale."""
    import torch
    scale = max(1.0, float(ref.float().abs().max()))
    return (1e-4 if dtype == torch.float32 else 2.0 ** -6) * scale


def ssd_inputs(gen, b, s, h, p, n, dtype, per_head=False, dt_shift=0.0,
               with_h0=False):
    """Inputs of the SSD kernel as the model hands them over: x and dt as
    (B, H, S, *) views of (B, S, H, *) tensors, b and c one group sliced from
    a (B, S, 2N) tensor and seen as (B, 1, S, N) (or per head, (B, H, S,
    N)), a < 0; then h0 (B, H, P, N) or None."""
    import torch
    import torch.nn.functional as F
    dev = "cuda"
    x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device=dev))
    a = -torch.exp(0.3 * torch.randn((h,), generator=gen, device=dev))
    if per_head:
        bm, cm = (torch.randn((b, h, s, n), generator=gen, device=dev)
                  for _ in range(2))
    else:
        bc = torch.randn((b, s, 2 * n), generator=gen, device=dev)
        bm, cm = bc[:, None, :, :n], bc[:, None, :, n:]
    h0 = (torch.randn((b, h, p, n), generator=gen, device=dev)
          if with_h0 else None)
    return (x.transpose(1, 2), (dt + dt_shift).transpose(1, 2), a, bm,
            cm), h0


def phase_ssm_kernel(seed: int) -> float:
    """Kernel 5 against its plain version on y and the final state: the SSM
    path's shape, then off-path cases. Returns the path case's worst
    error."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_torch
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    f32, bf = torch.float32, torch.bfloat16
    # (name, B, S, H, P, N, chunk, x dtype, b/c per head, dt shift, h0, path);
    # every case takes the tensor-core body but the last, whose P, N and
    # chunk are off it
    cases = [
        ("ssd_scan_fwd path B4 H32 S4096 P64 N128 chunk256 f32 b/c shared",
         4, 4096, 32, 64, 128, 256, f32, False, 0.0, False, True),
        ("ssd_scan_fwd path shape bf16 x", 4, 4096, 32, 64, 128, 256, bf,
         False, 0.0, False, False),
        ("ssd_scan_fwd S1000 (off the chunk) h0", 2, 1000, 8, 64, 128, 256,
         f32, False, 0.0, True, False),
        ("ssd_scan_fwd S100 (one short chunk) h0", 2, 100, 8, 64, 128, 256,
         f32, False, 0.0, True, False),
        ("ssd_scan_fwd S777 b/c per head h0", 2, 777, 8, 64, 128, 256, f32,
         True, 0.0, True, False),
        ("ssd_scan_fwd S600 dt + 20 (an unmasked exp overflows)", 2, 600, 8,
         64, 128, 256, f32, False, 20.0, False, False),
        ("ssd_scan_fwd S600 bf16 x b/c per head h0", 2, 600, 8, 64, 128,
         256, bf, True, 0.0, True, False),
        ("ssd_scan_fwd P32 N64 chunk128 S333 b/c per head h0", 3, 333, 3,
         32, 64, 128, f32, True, 0.0, True, False),
        ("ssd_scan_fwd P20 N8 chunk48 S97 h0 (the CUDA-core body)", 2, 97,
         3, 20, 8, 48, f32, False, 0.0, True, False),
    ]
    worst = None
    for name, b, s, h, p, n, chunk, dtype, per_head, shift, with_h0, path \
            in cases:
        args, h0 = ssd_inputs(gen, b, s, h, p, n, dtype, per_head, shift,
                              with_h0)
        tc_before = ssd_scan_fwd.tensor_core_launches
        y, hf = ssd_scan_fwd(*args, chunk=chunk, h0=h0)
        torch.cuda.synchronize()
        tc = ssd_scan_fwd.tensor_core_launches - tc_before
        if tc != (name != cases[-1][0]):     # the last case is off the body
            raise AssertionError(f"{name}: the {'tensor' if tc else 'CUDA'}"
                                 f"-core body took the call")
        y_ref, h_ref = ssd_scan_torch(*args, chunk=chunk, h0=h0)
        err_y = float((y.float() - y_ref.float()).abs().max())
        err_h = float((hf - h_ref).abs().max())
        tol_y, tol_h = ssd_tolerance(dtype, y_ref), ssd_tolerance(f32, h_ref)
        ok = (bool(torch.isfinite(y).all() and torch.isfinite(hf).all())
              and y.dtype == dtype and err_y <= tol_y and err_h <= tol_h)
        log("ssm-kernel", f"{name}: {'tensor' if tc else 'CUDA'}-core "
                          f"body, y max_abs_err {err_y:.3e} (tol "
                          f"{tol_y:.1e}), h_fin {err_h:.3e} (tol "
                          f"{tol_h:.1e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version")
        if path:
            worst = max(err_y, err_h)
        del args, h0, y, hf, y_ref, h_ref
    torch.cuda.empty_cache()
    return worst


def make_ssm_requests(seed: int, vocab: int):
    """The SSM mix: SSM_PROMPTS tokens each (the first longer than
    SSM_MAX_LEN), NEW_TOKENS new tokens, requests 2 and 6 sampled."""
    from repro_torch.serve import SamplingParams
    rng = np.random.default_rng(seed + 200)
    sampled = {2, 6}
    return [(rng.integers(0, vocab, (n,)).astype(np.int32), NEW_TOKENS,
             SamplingParams(0.8, 40, seed=seed + i) if i in sampled
             else SamplingParams()) for i, n in enumerate(SSM_PROMPTS)]


def phase_ssm_serve(seed: int):
    """mamba2-130m at full width through ServeEngine, every launch counter
    set to 0 just before the drive and read after; then the same mix
    through an engine built with page_size, which must not page and must
    give the same greedy streams."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, init_params
    from repro_torch.serve import ServeEngine

    cfg = get_config("mamba2_130m")
    if cfg.n_layers != SSM_LAYERS:
        raise AssertionError(f"config has {cfg.n_layers} layers")
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    engine = ServeEngine(get_model(cfg), params, max_len=SSM_MAX_LEN,
                         n_slots=SSM_SLOTS, device="cuda")
    del params                       # the engine holds its bf16 copy
    torch.cuda.synchronize()
    log("ssm", f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
               f"{cfg.ssm_heads_padded} SSM heads x {cfg.ssm_head_dim}, "
               f"state {cfg.ssm_state}, conv {cfg.conv_width}, chunk "
               f"{cfg.ssd_chunk}, vocab {cfg.vocab_padded}, {cfg.dtype}; "
               f"weights ready in {time.monotonic() - t0:.1f}s")
    requests = make_ssm_requests(seed, cfg.vocab)
    rids, launches, tok_s, wall = drive_counted(engine, requests)
    stats = engine.stats()
    want = {name: 0 for name in launches}
    want["ssd_scan_fwd"] = SSM_LAYERS * stats["prefill_waves"]
    log("ssm", f"{len(rids)} requests OK x {NEW_TOKENS} tokens (prompts "
               f"{list(SSM_PROMPTS)}, max_len {SSM_MAX_LEN}) in {wall:.2f}s "
               f"({tok_s:.1f} tok/s); {stats['prefill_waves']} admission "
               f"waves, {stats['decode_steps']} decode steps; launches "
               f"{launches}")
    if launches != want or not launches["ssd_scan_fwd"]:
        raise AssertionError(f"kernel launches {launches} != {want}")
    check_tensor_core("ssm", ("ssd_scan_fwd",))

    paged = ServeEngine(engine.model, engine.backend.params,
                        max_len=SSM_MAX_LEN, n_slots=SSM_SLOTS,
                        page_size=PAGE, device="cuda")
    if paged.backend.paged or paged.page_stats():
        raise AssertionError(f"an SSM engine built with page_size={PAGE} "
                             f"pages: {paged.page_stats()}")
    prids, plaunches, _, pwall = drive_counted(paged, requests)
    same = [bool(np.array_equal(engine.result(a), paged.result(b)))
            for a, b in zip(rids, prids)]
    greedy = [i for i, (_, _, sp) in enumerate(requests)
              if sp.temperature == 0]
    log("ssm", f"page_size={PAGE} engine: pages {paged.backend.paged}, "
               f"page stats {paged.page_stats()}; {len(prids)} requests OK in "
               f"{pwall:.2f}s; streams equal to the first engine's: greedy "
               f"{sum(same[i] for i in greedy)}/{len(greedy)}, all "
               f"{sum(same)}/{len(same)}; launches {plaunches}")
    if not all(same[i] for i in greedy):
        raise AssertionError("page_size changed an SSM greedy stream")
    if plaunches["ssd_scan_fwd"] != SSM_LAYERS * paged.stats()[
            "prefill_waves"]:
        raise AssertionError(f"page_size engine launches {plaunches}")
    check_tensor_core("ssm", ("ssd_scan_fwd",))
    del paged
    torch.cuda.empty_cache()
    return engine, requests, launches, tok_s


def ssd_no_carry(x, dt, a, b, c, *, chunk, h0=None):
    """The deliberate fault: the plain version with the state reset to zero
    at every chunk (the final state is the last chunk's alone)."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan_torch
    ys, h = [], None
    for s0 in range(0, x.shape[2], chunk):
        part = slice(s0, s0 + chunk)
        y, h = ssd_scan_torch(x[:, :, part], dt[:, :, part], a,
                              b[:, :, part], c[:, :, part], chunk=chunk)
        ys.append(y)
    return torch.cat(ys, dim=2), h


def ssm_wave(requests):
    """The first admission wave: SSM_SLOTS prompts right-padded to the
    longest, on the card, with their lengths."""
    import torch
    wave = [p for p, _, _ in requests[:SSM_SLOTS]]
    toks = np.zeros((SSM_SLOTS, max(p.size for p in wave)), np.int64)
    for i, p in enumerate(wave):
        toks[i, :p.size] = p
    lengths = np.array([p.size for p in wave], np.int32)
    return ({"tokens": torch.as_tensor(toks, device="cuda")},
            torch.as_tensor(lengths, device="cuda"))


def phase_ssm_parity(engine, requests) -> list:
    """The first wave's prefill and SSM_DECODE_STEPS decode steps through
    the kernel path (every SSD kernel call held in situ against the plain
    version on its inputs) and the plain path, fed the kernel path's greedy
    tokens; the logits compared; then the check run on the deliberate
    fault, which it must reject. Returns the failed checks."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_torch
    from repro_torch.models import get_model

    cfg, params = engine.model.cfg, engine.backend.params
    batch, lens = ssm_wave(requests)
    models = {impl: get_model(cfg.replace(attn_impl=impl))
              for impl in ("cuda", "torch")}

    def in_situ(fn, calls):
        def call(x, dt, a, b, c, *, chunk, h0=None):
            got = fn(x, dt, a, b, c, chunk=chunk, h0=h0)
            want = ssd_scan_torch(x, dt, a, b, c, chunk=chunk, h0=h0)
            calls.append((float((got[0].float() - want[0].float()).abs()
                                .max()), ssd_tolerance(want[0].dtype,
                                                       want[0]),
                          float((got[1] - want[1]).abs().max()),
                          ssd_tolerance(torch.float32, want[1])))
            return got
        return call

    def run(model, fed=None):
        """Prefill and decode steps; the (B, vocab) float32 logits of each
        and the tokens fed (the run's own greedy picks unless ``fed``)."""
        logits, cache = model.prefill(params, batch, lengths=lens)
        out, tokens = [], []
        for step in range(SSM_DECODE_STEPS + 1):
            out.append(logits[:, 0, :cfg.vocab].float())
            if step == SSM_DECODE_STEPS:
                return out, tokens
            nxt = fed[step] if fed else out[-1].argmax(-1)[:, None]
            tokens.append(nxt)
            logits, cache = model.decode(params, cache, nxt)

    def in_situ_ok(label, calls) -> bool:
        if len(calls) != SSM_LAYERS:
            raise AssertionError(f"{label}: {len(calls)} SSD calls seen")
        over = sum(ey > ty or eh > th for ey, ty, eh, th in calls)
        wy = max(calls, key=lambda c: c[0] / c[1])
        wh = max(calls, key=lambda c: c[2] / c[3])
        log("ssm-parity", f"{label}: in situ, {len(calls)} SSD calls against "
                          f"the plain version on their inputs: worst y "
                          f"{wy[0]:.3e} (tol {wy[1]:.1e}), worst h_fin "
                          f"{wh[2]:.3e} (tol {wh[3]:.1e}); {over} calls over "
                          f"the tolerance")
        return over == 0

    def gaps(got, want):
        return [float((g - w).abs().max()) for g, w in zip(got, want)]

    failed = []
    with torch.no_grad():
        calls = []
        with patched(ops, "ssd_scan_fwd", in_situ(ssd_scan_fwd, calls)):
            got, fed = run(models["cuda"])
        want, _ = run(models["torch"], fed)
        fault_calls = []
        with patched(ops, "ssd_scan_fwd", in_situ(ssd_no_carry, fault_calls)):
            fault, _ = run(models["cuda"], fed)
    ok = in_situ_ok("kernel path", calls)
    g = gaps(got, want)
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(got, want))
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    ok_e2e = finite and max(g) <= SSM_LOGIT_TOL
    log("ssm-parity", f"kernel path vs plain path, prefill of "
                      f"{lens.tolist()} tokens then {SSM_DECODE_STEPS} "
                      f"decode steps: max |logits gap| per step "
                      f"{', '.join(f'{x:.3e}' for x in g)} (tol "
                      f"{SSM_LOGIT_TOL}); greedy agreement {agree}/"
                      f"{len(got) * SSM_SLOTS}; logit RMS "
                      f"{float(want[0].square().mean().sqrt()):.3f}, max "
                      f"|logit| {float(want[0].abs().max()):.3f}; in situ "
                      f"{'ok' if ok else 'FAIL'}, end to end "
                      f"{'ok' if ok_e2e else 'FAIL'}")
    if not (ok and ok_e2e):
        failed.append(f"ssm parity: in situ ok {ok}, logits gap {max(g):.3e}"
                      f" vs {SSM_LOGIT_TOL}")
    seen = not in_situ_ok("fault 'state not carried across chunks'",
                          fault_calls)
    gf = gaps(fault, want)
    seen_e2e = max(gf) > SSM_LOGIT_TOL
    log("ssm-parity", f"fault 'state not carried across chunks': max |logits "
                      f"gap| per step {', '.join(f'{x:.3e}' for x in gf)}; "
                      f"rejected in situ {seen}, end to end {seen_e2e}")
    if not (seen or seen_e2e):
        failed.append("ssm parity check passes the fault 'state not carried'")
    del got, want, fault
    torch.cuda.empty_cache()
    return failed


def ssd_stage_ms(fn, iters: int = 20):
    """Device time per call of ``fn`` (as ``device_ms``) and its part in
    each kernel of the SSD scan's tensor-core body (SSD_STAGES) and in the
    CUDA-core body (ssd_fwd)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    kernels = profiled(fn, iters)
    stages = {}
    for st in SSD_STAGES + ("ssd_fwd",):
        pat = re.compile(rf"(?<![A-Za-z0-9_]){st}[<(]")
        stages[st] = sum(device_us(e) for e in kernels
                         if pat.search(e.key)) / iters / 1e3
    return sum(device_us(e) for e in kernels) / iters / 1e3, stages


def phase_ssm_times(engine, requests, tok_s: float, card: str) -> dict:
    """Kernel 5 and its plain version per call at the path shape, with the
    bound; the admission wave of the first wave's 4 prompts; the decode
    step of 4 slots x 24 layers, its device busy time and idle share; and
    the serve phase's end-to-end tokens/s."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_torch

    cfg, params, model = engine.model.cfg, engine.backend.params, \
        engine.model
    batch, lens = ssm_wave(requests)
    b, s = batch["tokens"].shape
    h, p, n, q = (cfg.ssm_heads_padded, cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.ssd_chunk)
    gen = torch.Generator(device="cuda").manual_seed(3)
    args, _ = ssd_inputs(gen, b, s, h, p, n, torch.float32)
    chunks = [min(q, s - s0) for s0 in range(0, s, q)]
    flops = b * h * sum(ln * (ln + 1) // 2 * (2 * n + 2 * p)
                        + 4 * ln * n * p for ln in chunks)
    bytes_ = (2 * b * s * h * p * 4 + 2 * b * s * n * 4 + b * s * h * 4
              + h * 4 + b * h * p * n * 4)
    kernel = (lambda: ssd_scan_fwd(*args, chunk=q))
    ms, stages = ssd_stage_ms(kernel)
    out = dict(ms=ms,
               plain_ms=device_ms(lambda: ssd_scan_torch(*args, chunk=q)),
               library_ms=None,
               **bound(bytes_, flops))
    log("ssm-times", "ssd_scan_fwd device ms per call by kernel: " + ", ".join(
        f"{st} {t:.4f}" for st, t in stages.items()) + f" [{card}]")
    log("ssm-times", f"ssd_scan_fwd (device time per call, B{b} H{h} S{s} "
                     f"P{p} N{n} chunk {q}, float32): kernel "
                     f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
                     f"library none (no PyTorch call computes the SSD "
                     f"scan), bound {out['bound_ms']:.4f} ms "
                     f"({out['bound_by']}: {bytes_ / 1e9:.3f} GB at 3.35 "
                     f"TB/s, {flops / 1e9:.2f} GFLOP at 989 TFLOP/s "
                     f"{flops / BF16_FLOP_PER_S * 1e3:.4f} ms; as float32 "
                     f"FMAs at 67 TFLOP/s, the kernel's own arithmetic, "
                     f"{flops / 67e12 * 1e3:.4f} ms); kernel "
                     f"between CUDA events, host gaps included, "
                     f"{event_ms(kernel, iters=10):.4f} ms [{card}]")
    del args
    torch.cuda.empty_cache()

    with torch.no_grad():
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            _, cache = model.prefill(params, batch, lengths=lens)
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) * 1e3)
            del cache
        wave_ms = float(np.median(walls[1:]))
        busy, kernels = profile_steps(
            lambda: model.prefill(params, batch, lengths=lens), 1)
        log("ssm-times", f"admission wave ({b} x {s} positions, prompts "
                         f"{lens.tolist()}): {wave_ms:.1f} ms on the host "
                         f"clock (median of 3 after a warm-up); device busy "
                         f"{busy:.1f} ms; top kernels: [{card}]")
        for e in sorted(kernels, key=device_us, reverse=True)[:6]:
            log("ssm-times", f"  {device_us(e) / 1e3:9.3f} ms {e.count:6d} "
                             f"calls  {e.key[:80]}")

        logits, cache = model.prefill(params, batch, lengths=lens)
        tokens = logits[:, 0, :cfg.vocab].argmax(-1)[:, None]
        step_walls = []

        def step():
            model.decode(params, cache, tokens)

        for _ in range(13):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            step()
            torch.cuda.synchronize()
            step_walls.append((time.monotonic() - t0) * 1e3)
        step_ms = float(np.median(step_walls[1:]))
        kernels = profiled(step, 3)
        busy = sum(device_us(e) for e in kernels) / 3 / 1e3
        log("ssm-times", f"decode step ({SSM_SLOTS} slots, {cfg.n_layers} "
                         f"layers): {step_ms:.3f} ms on the host clock "
                         f"(median of 12 after a warm-up); device busy "
                         f"{busy:.3f} ms/step, idle share "
                         f"{1 - busy / step_ms:.3f}; end to end (serve "
                         f"phase) {tok_s:.1f} tok/s [{card}]")
        for e in sorted(kernels, key=device_us, reverse=True)[:6]:
            log("ssm-times", f"  {device_us(e) / 3 / 1e3:8.3f} ms/step "
                             f"{e.count // 3:5d} calls/step  {e.key[:80]}")
        log("ssm-times", f"decode step: {sum(e.count for e in kernels) // 3}"
                         f" device calls per step; top host ops:")
        for e in host_ops(step, 3):
            log("ssm-times", f"  host {e.self_cpu_time_total / 3 / 1e3:8.3f} "
                             f"ms/step {e.count // 3:5d} calls/step  "
                             f"{e.key[:70]}")
    del cache
    torch.cuda.empty_cache()
    return out


def bound(bytes_: int, flops: int) -> dict:
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    card = card_line()
    log("device", f"{torch.cuda.get_device_name(0)} x "
                  f"{torch.cuda.device_count()}; torch {torch.__version__}, "
                  f"CUDA {torch.version.cuda}; TF32 off; [{card}]")

    t_start = t0 = time.monotonic()
    report = build.build()
    log("build", f"{sorted(report)} built in {time.monotonic() - t0:.1f}s")
    for name, rep in report.items():
        fn = name
        for line in rep["ptxas"].splitlines():
            entry = re.search(r"Compiling entry function '\S*?\d([a-z_]+?)"
                              r"(?:I(\w+?)E)?E", line)
            if entry:
                fn = f"{name} {entry.group(1)}" + (
                    f"<{entry.group(2)}>" if entry.group(2) else "")
            elif "Used " in line or "spill" in line:
                log("build", f"{fn}: {line.strip()}")
    sass_hgmma()

    errors = phase_kernels(args.seed)
    engine, requests, launches, tok_s = phase_serve(args.seed)
    paged_launches, paged_tok_s, _ = phase_paged(engine, requests)
    launches["flash_decode_paged_fwd"] = \
        paged_launches["flash_decode_paged_fwd"]
    traces, decode_lengths = phase_parity(engine, requests)
    for label, rate in (("contiguous", tok_s), ("paged", paged_tok_s)):
        t = traces[label]
        log("times", f"{label}: decode step {t['step_ms']:.3f} ms (4 slots, "
                     f"48 layers), device idle share {t['idle_share']:.3f}; "
                     f"end to end {rate:.1f} tok/s [{card}]")
    times = phase_times(engine, decode_lengths, card)
    del engine
    torch.cuda.empty_cache()

    pair, complexes, rids, pair_launches = phase_pair_serve(args.seed)
    launches["flashbias_attention_ragged_fwd"] = \
        pair_launches["flashbias_attention_ragged_fwd"]
    failed = phase_pair_parity(pair, complexes, rids, args.seed)
    times["flashbias_attention_ragged_fwd"] = phase_pair_times(
        pair, complexes, card)
    del pair
    torch.cuda.empty_cache()

    errors["ssd_scan_fwd"] = phase_ssm_kernel(args.seed)
    ssm, ssm_requests, ssm_launches, ssm_tok_s = phase_ssm_serve(args.seed)
    launches["ssd_scan_fwd"] = ssm_launches["ssd_scan_fwd"]
    failed += phase_ssm_parity(ssm, ssm_requests)
    times["ssd_scan_fwd"] = phase_ssm_times(ssm, ssm_requests, ssm_tok_s,
                                            card)
    del ssm
    torch.cuda.empty_cache()

    replaces = {"flashbias_attention_fwd": "src/repro/kernels/"
                                           "flashbias_attn.py:149",
                "flash_decode_fwd": "src/repro/kernels/flash_decode.py:121",
                "flash_decode_paged_fwd": "src/repro/kernels/"
                                          "flash_decode.py:195",
                "flashbias_attention_ragged_fwd": "src/repro/kernels/"
                                                  "flashbias_attn.py:139",
                "ssd_scan_fwd": "src/repro/kernels/ssd_scan.py:78"}
    sources = {"flashbias_attention_fwd": "src/repro_torch/csrc/"
                                          "flashbias_attn.cu",
               "flash_decode_fwd": "src/repro_torch/csrc/flash_decode.cu",
               "flash_decode_paged_fwd": "src/repro_torch/csrc/"
                                         "flash_decode.cu",
               "flashbias_attention_ragged_fwd": "src/repro_torch/csrc/"
                                                 "flashbias_attn.cu",
               "ssd_scan_fwd": "src/repro_torch/csrc/ssd_scan.cu"}
    kernels = [{"name": name, "route": "cuda", "source": sources[name],
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": errors[name], **times[name]}
               for name in KERNELS]
    log("done", f"every phase ran in {time.monotonic() - t_start:.0f}s, "
                f"the build included")
    print(json.dumps({"kernels": kernels}))
    print(card)
    if failed:
        print(f"chip_smoke: FAILED: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

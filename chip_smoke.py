#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--seed N]

Needs one CUDA device (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``; exits non-zero without them. Phases, each printed
as it runs, any failure ending the run:

1. build    — compile both CUDA kernels from ``src/repro_torch/csrc``
              (one nvcc per source, started together) and print ptxas's
              register / shared-memory report;
2. kernels  — each kernel against its plain PyTorch version on the card,
              at the serving path's shapes and off-path modes, within the
              stated tolerances;
3. serve    — GPT-2-ALiBi-1.5B at full width (48 layers, d_model 1600,
              bf16, random weights from ``--seed``) through ``ServeEngine``
              on 4 slots x 2048 positions: 8 ragged requests (prompts
              64-512 tokens, 32 new tokens each, 6 greedy and 2 sampled),
              staggered as the launcher does. Every request must end OK
              with 32 tokens, and the kernels' launch counters must equal
              48 x prefill waves and 48 x decode steps;
4. parity   — the first wave's prefill and 4 decode steps again, with the
              plain path (impl="torch") on the card, logits compared; then
              decode steps of the kernel path timed and traced with
              torch.profiler (device busy time, idle share, top kernels);
5. times    — kernel, plain-version and library device times per call at
              the path shapes (torch.profiler), the least time the card
              could take (bound), decode step time and end-to-end tokens/s.

The last lines are the per-kernel JSON record, the card's name and power
limit as nvidia-smi reports them, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import argparse
import json
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
LOGIT_TOL = 0.25                 # bf16 logits, 48 layers deep (see phase 4)


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


def device_kernels(prof) -> list:
    """The device-side (kernel and copy) rows of a profile's averages."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def device_us(e) -> float:
    return (getattr(e, "self_device_time_total", 0)
            or getattr(e, "self_cuda_time_total", 0))


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn``: the summed durations of the kernels
    and copies it runs, from torch.profiler over ``iters`` calls — without
    the gaps ``event_ms`` counts, which for a ~20 us decode kernel behind a
    Python wrapper are most of the bracket."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(device_us(e) for e in device_kernels(prof))
    if not total:
        raise AssertionError("the profiler saw no kernels")
    return total / iters / 1e3


def tolerance(dtype, ref) -> float:
    """float32: summation order only (1e-4). bfloat16: both sides round the
    same float32 result once, so 2 bf16 ulps at the output's scale."""
    import torch
    if dtype == torch.float32:
        return 1e-4
    return 2.0 ** -6 * max(1.0, float(ref.float().abs().max()))


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


def phase_kernels(seed: int) -> dict:
    import torch
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                                  flash_decode_torch)
    from repro_torch.kernels.flashbias_attn import (
        flashbias_attention_fwd, flashbias_attention_torch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = {}

    def check(name, got, want, dtype, path=False):
        torch.cuda.synchronize()
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
    for name, b, h, kvh, n, d, dtype, bias, mask, path in cases:
        q, k, v, extra = prefill_inputs(gen, b, h, kvh, n, d, dtype, bias)
        kw = dict(scale=d ** -0.5, mask_kind=mask, window=48, **extra)
        check(name, flashbias_attention_fwd(q, k, v, **kw),
              flashbias_attention_torch(q, k, v, **kw), dtype, path)

    # decode kernel: the serving path's shape, then phi mode and GQA
    cases = [("flash_decode_fwd path B4 KVH64 G1 S2048 D32 bf16 alibi",
              4, 64, 1, 2048, 32, torch.bfloat16, "alibi",
              [0, 1, 777, 2048], True)]
    for dtype in (torch.float32, torch.bfloat16):
        for bias in ("alibi", "phi", "none"):
            cases.append((f"flash_decode_fwd GQA G4 S1024 D160 "
                          f"{str(dtype)[6:]} {bias}", 4, 2, 4, 1024, 160,
                          dtype, bias, [0, 1, 333, 1024], False))
    cases.append(("flash_decode_fwd MHA G1 S512 D32 f32 phi", 3, 8, 1, 512,
                  32, torch.float32, "phi", [512, 5, 0], False))
    for name, b, kvh, g, s, d, dtype, bias, lengths, path in cases:
        q, k, v, lens, extra = decode_inputs(gen, b, kvh, g, s, d, dtype,
                                             bias, lengths)
        kw = dict(scale=d ** -0.5, **extra)
        check(name, flash_decode_fwd(q, k, v, lens, **kw),
              flash_decode_torch(q, k, v, lens, **kw), dtype, path)
    return worst


# ---------------------------------------------------------------------------
# phases 3-4: full-width serving and parity
# ---------------------------------------------------------------------------

def make_requests(seed: int, vocab: int):
    from repro_torch.serve import SamplingParams
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, PROMPT_MAX + 1, (8,))
    sampled = {2, 6}                 # one in each half of the arrivals
    return [(rng.integers(0, vocab, (int(n),)).astype(np.int32), NEW_TOKENS,
             SamplingParams(0.8, 40, seed=seed + i) if i in sampled
             else SamplingParams()) for i, n in enumerate(lens)]


def phase_serve(seed: int):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import flash_decode_fwd
    from repro_torch.kernels.flashbias_attn import flashbias_attention_fwd
    from repro_torch.launch.serve import drive
    from repro_torch.models import get_model, init_params
    from repro_torch.serve import OK, ServeEngine

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

    flashbias_attention_fwd.launches = 0
    flash_decode_fwd.launches = 0
    t0 = time.monotonic()
    rids = drive(engine, requests)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"flashbias_attention_fwd": flashbias_attention_fwd.launches,
                "flash_decode_fwd": flash_decode_fwd.launches}

    stats = engine.stats()
    n_tok = 0
    for rid in rids:
        rec = engine.result(rid)
        if rec.status != OK or rec.size != NEW_TOKENS:
            raise AssertionError(f"request {rid}: {rec!r}")
        if rec.min() < 0 or rec.max() >= cfg.vocab:
            raise AssertionError(f"request {rid}: token ids out of range")
        n_tok += rec.size
    want = {"flashbias_attention_fwd": N_LAYERS * stats["prefill_waves"],
            "flash_decode_fwd": N_LAYERS * stats["decode_steps"]}
    log("serve", f"{len(rids)} requests OK x {NEW_TOKENS} tokens in "
                 f"{wall:.2f}s ({n_tok / wall:.1f} tok/s); "
                 f"{stats['prefill_waves']} prefill waves, "
                 f"{stats['decode_steps']} decode steps; launches {launches}")
    if launches != want or not all(launches.values()):
        raise AssertionError(f"kernel launches {launches} != {want}")
    return engine, requests, launches, n_tok / wall


def phase_parity(engine, requests):
    """The first wave again through impl="cuda" and impl="torch" on the
    card: prefill, then 4 greedy decode steps fed the cuda path's tokens."""
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
    worst, agree, total = 0.0, 0, 0
    with torch.no_grad():
        out = {impl: m.prefill(params, batch, max_len=MAX_LEN, lengths=lens)
               for impl, m in models.items()}
        for step in range(5):
            lc, lt = out["cuda"][0][:, 0].float(), out["torch"][0][:, 0].float()
            lc[:, cfg.vocab:] = -torch.inf
            lt[:, cfg.vocab:] = -torch.inf
            err = float((lc[:, :cfg.vocab] - lt[:, :cfg.vocab]).abs().max())
            worst = max(worst, err)
            tok_c, tok_t = lc.argmax(-1), lt.argmax(-1)
            agree += int((tok_c == tok_t).sum())
            total += SLOTS
            log("parity", f"{'prefill' if step == 0 else f'decode {step}'}: "
                          f"max |logits cuda - torch| {err:.3e}, greedy "
                          f"agree {int((tok_c == tok_t).sum())}/{SLOTS}")
            if step == 4:
                break
            nxt = tok_c[:, None]
            for impl, m in models.items():
                out[impl] = m.decode(params, out[impl][1], nxt)
        decode_lengths = out["cuda"][1]["length"].clone()
    log("parity", f"worst |logits| gap {worst:.3e} (tol {LOGIT_TOL}); "
                  f"greedy agreement {agree}/{total}")
    if not worst <= LOGIT_TOL:
        raise AssertionError(f"cuda and torch paths disagree: {worst:.3e}")
    del out["torch"]
    trace = trace_decode(models["cuda"], params, out["cuda"][1], nxt)
    del out
    torch.cuda.empty_cache()
    return trace, decode_lengths


def trace_decode(model, params, cache, tokens) -> dict:
    """Decode steps of the kernel path: 5 timed on the host clock (each
    ending in a synchronize), then 3 under torch.profiler for the device's
    busy time per step (the sum of its kernels' and copies' durations) and
    the kernels that hold it longest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls = []
    with torch.no_grad():
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            _, cache = model.decode(params, cache, tokens)
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                _, cache = model.decode(params, cache, tokens)
            torch.cuda.synchronize()

    kernels = device_kernels(prof)
    step_ms = float(np.median(walls))
    busy_ms = sum(device_us(e) for e in kernels) / 3 / 1e3
    if not busy_ms:
        raise AssertionError("the profiler saw no kernels in the decode steps")
    trace = {"step_ms": step_ms, "busy_ms": busy_ms,
             "idle_share": 1 - busy_ms / step_ms}
    log("trace", f"decode step {step_ms:.3f} ms on the host clock (median of "
                 f"5); device busy {busy_ms:.3f} ms/step, idle share "
                 f"{trace['idle_share']:.3f}")
    for e in sorted(kernels, key=device_us, reverse=True)[:8]:
        log("trace", f"  {device_us(e) / 3 / 1e3:8.3f} ms/step "
                     f"{e.count // 3:5d} calls/step  {e.key[:90]}")
    return trace


# ---------------------------------------------------------------------------
# phase 5: times and bounds
# ---------------------------------------------------------------------------

def phase_times(engine, decode_lengths, card: str):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
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
    bytes_ = live * kvh * 2 * d * 2 + 2 * b * kvh * d * 2 + b * 4 + h * 4
    flops = live * kvh * 4 * d
    kernel = (lambda: flash_decode_fwd(qd, kc, vc, lens, **kwd))
    out["flash_decode_fwd"] = dict(
        ms=device_ms(kernel),
        plain_ms=device_ms(lambda: flash_decode_torch(qd, kc, vc, lens,
                                                      **kwd)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qd, kc, vc, attn_mask=dmask, scale=scale)),
        **bound(bytes_, flops))
    events["flash_decode_fwd"] = event_ms(kernel)
    for name, t in out.items():
        log("times", f"{name} (device time per call): kernel "
                     f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                     f"library {t['library_ms']:.4f} ms, bound "
                     f"{t['bound_ms']:.4f} ms ({t['bound_by']}); kernel "
                     f"between CUDA events, host gaps included, "
                     f"{events[name]:.4f} ms [{card}]")
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

    t0 = time.monotonic()
    report = build.build()
    log("build", f"{sorted(report)} built in {time.monotonic() - t0:.1f}s")
    for name, rep in report.items():
        for line in rep["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{name}: {line.strip()}")

    errors = phase_kernels(args.seed)
    engine, requests, launches, tok_s = phase_serve(args.seed)
    trace, decode_lengths = phase_parity(engine, requests)
    log("times", f"decode step {trace['step_ms']:.3f} ms (4 slots, 48 "
                 f"layers); "
                 f"end to end {tok_s:.1f} tok/s [{card}]")
    times = phase_times(engine, decode_lengths, card)

    replaces = {"flashbias_attention_fwd": "src/repro/kernels/"
                                           "flashbias_attn.py:149",
                "flash_decode_fwd": "src/repro/kernels/flash_decode.py:121"}
    sources = {"flashbias_attention_fwd": "src/repro_torch/csrc/"
                                          "flashbias_attn.cu",
               "flash_decode_fwd": "src/repro_torch/csrc/flash_decode.cu"}
    kernels = [{"name": name, "route": "cuda", "source": sources[name],
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": errors[name], **times[name]}
               for name in ("flashbias_attention_fwd", "flash_decode_fwd")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

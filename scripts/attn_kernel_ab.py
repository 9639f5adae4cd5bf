#!/usr/bin/env python3
"""A/B timing of variants of the port's attention kernel on the card.

    python3 scripts/attn_kernel_ab.py [--variants base,bare] [--rounds 2]

Builds each variant of ``src/repro_torch/csrc/flashbias_attn.cu`` (a copy
of the sources with a few lines replaced) with nvcc, all at once, into
``build/attn_ab/<variant>/``, and times the bf16 body at the two serving
paths' shapes in rounds that alternate the order of the variants: kernel 1
(B4 H64 N=M512 D32, ALiBi, causal) and kernel 2 (B4 H4 N=M384 D=Dv=R96,
float32 factors, lengths 384/337/131/268). Device time per call comes from
``chip_smoke.device_ms`` (torch.profiler, 20 calls). Each line also gives
the variant's max |error| against the plain version at the two shapes.

Variants:

- ``base``: the source as it is;
- ``one_warpgroup`` / ``kv_split``: every grid takes one warpgroup per
  block / two that split the kv tiles (the source picks by grid size);
- ``bare``: a diagnostic with no q.k product, no P.V product, no logits
  and no exp: the loads, waits and barriers alone (its results are wrong
  and marked so).

Needs one Hopper card and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SRC = "flashbias_attn.cu"
NWG = ("  const int nwg = (long long)grid.x * grid.y * grid.z < 2LL * "
       "sm_count() ? 2 : 1;")
VARIANTS = {
    "base": [],
    "one_warpgroup": [(NWG, "  const int nwg = 1;")],
    "kv_split": [(NWG, "  const int nwg = 2;")],
    "bare": [
        ("      sm90::wgmma_ss_n64(s, sm90::make_desc(a_q",
         "      if (a.N < 0) sm90::wgmma_ss_n64(s, sm90::make_desc(a_q"),
        ("      sm90::WgmmaRS<DVP>::run(\n",
         "      if (a.N < 0) sm90::WgmmaRS<DVP>::run(\n"),
        ("      logits_of<PHI, true>(s, sb, sc2, sl2, row0, k0 + colq, a, "
         "kv_len, mx);", "      mx[0] = s[0];"),
        ("      logits_of<PHI, false>(s, sb, sc2, sl2, row0, k0 + colq, a, "
         "kv_len, mx);", "      mx[1] = s[1];"),
        ("      s[i] = ex2(s[i] - m_r[hi]);", "      s[i] = s[i] - m_r[hi];"),
    ],
}


def build_variants(names):
    """Compile every variant at once; returns {name: loaded library}."""
    from repro_torch.kernels import build
    procs = {}
    for name in names:
        out = ROOT / "build" / "attn_ab" / name
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(build.CSRC, out)
        src = (out / SRC).read_text()
        for old, new in VARIANTS[name]:
            if old not in src:
                raise SystemExit(f"variant {name}: line not found: {old!r}")
            src = src.replace(old, new)
        (out / SRC).write_text(src)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / "lib.so"),
               str(out / SRC)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} does not build:\n{text}")
        libs[name] = ctypes.CDLL(str(ROOT / "build" / "attn_ab" / name /
                                     "lib.so"))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("attn_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import repro_torch.kernels.flashbias_attn as fa
    from repro_torch.core.bias import alibi_slopes
    from repro_torch.kernels import build

    names = args.variants.split(",")
    libs = build_variants(names)
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16

    def rand(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q1, k1, v1 = (rand(4, 64, 512, 32) for _ in range(3))
    slopes = alibi_slopes(64, device="cuda")
    q2, k2, v2 = (rand(4, 4, 384, 96) for _ in range(3))
    pq, pk = (rand(4, 4, 384, 96, dtype=torch.float32) for _ in range(2))
    lens = torch.tensor([384, 337, 131, 268], dtype=torch.int32,
                        device="cuda")
    kw1 = dict(slopes=slopes, scale=32 ** -0.5, mask_kind="causal")
    kw2 = dict(scale=96 ** -0.5)
    cases = {
        "kernel 1": (lambda: fa.flashbias_attention_fwd(q1, k1, v1, **kw1),
                     fa.flashbias_attention_torch(q1, k1, v1, **kw1)),
        "kernel 2": (lambda: fa.flashbias_attention_ragged_fwd(
            q2, k2, v2, pq, pk, None, lens, **kw2),
                     fa.flashbias_attention_torch(q2, k2, v2, pq, pk,
                                                  lengths=lens, **kw2)),
    }
    card = cs.card_line()
    for rnd in range(args.rounds):
        order = names if rnd % 2 == 0 else names[::-1]
        for name in order:
            build._loaded["flashbias_attn"] = libs[name]
            fa._kernel.cache_clear()
            parts = []
            for label, (fn, want) in cases.items():
                got = fn()
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                ok = err <= cs.tolerance(bf, want)
                parts.append(f"{label} {cs.device_ms(fn):.4f} ms (max |err| "
                             f"{err:.2e}{'' if ok else ', WRONG'})")
            print(f"round {rnd} {name}: {'; '.join(parts)} [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

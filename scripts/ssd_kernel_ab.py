#!/usr/bin/env python3
"""A/B timing of variants of the port's SSD chunk-scan kernel on the card.

    python3 scripts/ssd_kernel_ab.py [--variants base,cb_recompute] [--rounds 2]

Builds each variant of ``src/repro_torch/csrc/ssd_scan.cu`` (a copy of the
sources with a few lines replaced) with nvcc, all at once, into
``build/ssd_ab/<variant>/``, and times kernel 5 at the SSM prefill path's
shape (B4 H32 S4096 P64 N128, chunk 256, float32 x, one b/c group, x and b
/ c as the model's strided views) in rounds that alternate the order of the
variants. Device time per call and its split over the device kernels come
from ``chip_smoke.ssd_stage_ms`` (torch.profiler, 20 calls). Each line also
gives the variant's max |error| on y and the final state against the plain
version, with the kernel phase's tolerance.

Variants:

- ``base``: the source as it is (with one b/c group, C B^T once per
  (b, chunk) in ``ssd_cb``, read by every head's scan from a scratch);
- ``cb_recompute``: every head's scan computes C B^T itself (no ``ssd_cb``);
- ``cuda_core``: every shape on the CUDA-core body (the previous design:
  one block per (b, h) walking the chunks with float32 FMAs);
- ``scan_no_c``, ``scan_no_cb``, ``scan_no_x``: diagnostics in which the
  scan does not load its split C tile, its C B^T tiles or its X^T tiles
  (its results are wrong and marked so): what each load costs.

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

SRC = "ssd_scan.cu"
VARIANTS = {
    "base": [],
    "cb_recompute": [("constexpr bool kCbScratch = true;",
                      "constexpr bool kCbScratch = false;")],
    "cuda_core": [("  return P > 0 && N > 0 && Q > 0 && P % 16 == 0",
                   "  return false && P > 0 && N > 0 && Q > 0 && P % 16 == 0")],
    # diagnostics of the scan (results wrong, marked so): one of its shared-
    # memory or register operands is not loaded
    "scan_no_c": [
        ("    sm90::mbar_expect_tx(bar, (uint32_t)(hbytes + (CB ? cbytes : 0)));",
         "    sm90::mbar_expect_tx(bar, (uint32_t)hbytes);"),
        ("    if (CB)\n      sm90::bulk_load(cHi, t.csplit",
         "    if (false)\n      sm90::bulk_load(cHi, t.csplit")],
    "scan_no_cb": [
        ("    for (int v = 0; v < 8; ++v) cb_next[v] = src[v * kWg + threadIdx.x];",
         "    for (int v = 0; v < 8; ++v) cb_next[v] = make_float4(src == nullptr, 0.f, 0.f, 0.f);")],
    "scan_no_x": [
        ("    sm90::mbar_expect_tx(bx, kXBytes);", "    sm90::mbar_expect_tx(bx, 0);"),
        ("    sm90::bulk_load(hHi + (kt & 1) * kXBytes,",
         "    if (false) sm90::bulk_load(hHi + (kt & 1) * kXBytes,")],
}


def build_variants(names):
    """Compile every variant at once; returns {name: loaded library}."""
    from repro_torch.kernels import build
    procs = {}
    for name in names:
        out = ROOT / "build" / "ssd_ab" / name
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
        libs[name] = ctypes.CDLL(str(ROOT / "build" / "ssd_ab" / name /
                                     "lib.so"))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ssd_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    import repro_torch.kernels.ssd_scan as ks
    from repro_torch.kernels import build

    names = args.variants.split(",")
    libs = build_variants(names)
    gen = torch.Generator(device="cuda").manual_seed(3)
    f32 = torch.float32
    inputs, _ = cs.ssd_inputs(gen, 4, 4096, 32, 64, 128, f32)
    y_ref, h_ref = ks.ssd_scan_torch(*inputs, chunk=256)
    tol_y, tol_h = cs.ssd_tolerance(f32, y_ref), cs.ssd_tolerance(f32, h_ref)
    card = cs.card_line()

    def fn():
        return ks.ssd_scan_fwd(*inputs, chunk=256)

    for rnd in range(args.rounds):
        order = names if rnd % 2 == 0 else names[::-1]
        for name in order:
            build._loaded["ssd_scan"] = libs[name]
            ks._kernel.cache_clear()
            y, h = fn()
            torch.cuda.synchronize()
            err_y = float((y - y_ref).abs().max())
            err_h = float((h - h_ref).abs().max())
            ok = err_y <= tol_y and err_h <= tol_h
            ms, stages = cs.ssd_stage_ms(fn)
            split = ", ".join(f"{st} {t:.4f}" for st, t in stages.items()
                              if t)
            print(f"round {rnd} {name}: {ms:.4f} ms ({split}); max |err| y "
                  f"{err_y:.2e} (tol {tol_y:.1e}), h_fin {err_h:.2e} (tol "
                  f"{tol_h:.1e}){'' if ok else ', WRONG'} [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

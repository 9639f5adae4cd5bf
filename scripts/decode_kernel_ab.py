#!/usr/bin/env python3
"""A/B timing of variants of the port's decode kernels (3 and 4) on the card.

    python3 scripts/decode_kernel_ab.py [--variants base,walk8] [--rounds 2]
        [--single-pass PATH]

Builds each variant of ``src/repro_torch/csrc/flash_decode.cu`` (a copy of
the sources with a few lines replaced) with nvcc, all at once, into
``build/decode_ab/<variant>/``, and times kernels 3 and 4 at the GPT-2
decode path's shapes in rounds that alternate the order of the variants:
B4 KVH64 G1 D32 bf16, the caches 2048 positions long (paged: page size 16,
pages in random order, phi mode against the shared ``[1, pos]`` slab),
lengths ``LENGTHS``, each call writing the new token's row. Device time per
call comes from ``chip_smoke.device_ms`` (torch.profiler, 20 calls). Each
line also gives the variant's max |error| against the plain version and
whether two calls gave bit-equal outputs.

Variants:

- ``base``: the source as it is (spans of 128 keys at the path's shapes;
  the G = 1, D 32 body asking for 8 resident blocks per SM; a split axis
  of as many blocks per (b, h) as the card holds at once; the arrival
  counted by one ``atom.acq_rel.gpu`` after the block's barrier);
- ``walk8`` / ``full_grid``: a split axis of 8 blocks, each walking splits
  z, z + 8, ... / of every split of the cache's length;
- ``span64`` / ``span256``: spans of up to 64 / 256 keys (the wrapper's
  ``MAX_SPAN`` and ``SPAN_TILE_BYTES``);
- ``minblocks12`` / ``minblocks16``: that body asking for 12 / 16 resident
  blocks per SM;
- ``fences``: ``__threadfence`` before and after a relaxed ``atomicAdd``
  in place of the ``atom.acq_rel.gpu`` arrival; ``fastexp``: ``__expf``
  for ``expf``;
- ``no_merge``, ``no_stage``, ``no_compute``: diagnostics (see
  ``VARIANTS``).

``--single-pass PATH``: also time an earlier single-pass design's source
(one block of 8 warps per (b, kv head) walking the whole row; its C entry
points take no new row and no scratch), with the new row written by the
two gather / ``where`` / scatter passes the model ran before the kernel
wrote it, for a comparison within one call.

Needs one Hopper card and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SRC = "flash_decode.cu"
LENGTHS = [165, 349, 551, 97]     # live keys per slot, the serve's range
BOUNDS = "__launch_bounds__(kThreads, MG == 1 && DK ? 8 : 1)"
VARIANTS = {
    "base": [],
    "walk8": [("constexpr int kGridSplits = 0;",
               "constexpr int kGridSplits = 8;")],
    "span64": [],
    "span256": [],
    "minblocks12": [(BOUNDS, BOUNDS.replace("8", "12"))],
    "minblocks16": [(BOUNDS, BOUNDS.replace("8", "16"))],
    "fastexp": [("expf(", "__expf(")],
    "fences": [("      if (tid == 0)\n        *sFlag = arrive_acq_rel(a.arrivals "
                "+ bh) == nsplit - 1;",
                "      if (tid == 0) {\n        __threadfence();\n        "
                "*sFlag = atomicAdd(a.arrivals + bh, 1) == nsplit - 1;\n"
                "        __threadfence();\n      }")],
    "full_grid": [("constexpr int kGridSplits = 0;",
                   "constexpr int kGridSplits = 1 << 30;")],
    # diagnostics (results wrong, marked so): the kernel without the last
    # split's merge, without its staging copies, or without its logits and
    # P.V loops: what each part costs
    "no_merge": [("      if (*sFlag) {",
                  "      if (*sFlag && tid == 0) a.arrivals[bh] = 0;\n"
                  "      if (false) {")],
    "no_stage": [("      cp_async16(dst + i * E, r == w_row",
                  "      if (i < 0) cp_async16(dst + i * E, r == w_row")],
    "no_compute": [("      for (int jb = 0; jb < nk; jb += per) {",
                    "      for (int jb = 0; jb < 0; jb += per) {"),
                   ("j < nk; j += kWarps * kpw) {",
                    "j < 0; j += kWarps * kpw) {")],
}
# variants that change the wrapper's split plan: (MAX_SPAN, SPAN_TILE_BYTES)
PLAN = {"span64": (64, 32 * 1024), "span256": (256, 64 * 1024)}


def _compile(name, out, src_text):
    from repro_torch.kernels import build
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    (out / SRC).write_text(src_text)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / "lib.so"),
           str(out / SRC)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_variants(names, single_pass):
    """Compile every variant at once; returns {name: loaded library}."""
    from repro_torch.kernels import build
    procs = {}
    base = (build.CSRC / SRC).read_text()
    for name in names:
        src = base
        for old, new in VARIANTS[name]:
            if old not in src:
                raise SystemExit(f"variant {name}: line not found: {old!r}")
            src = src.replace(old, new)
        procs[name] = _compile(name, ROOT / "build" / "decode_ab" / name, src)
    if single_pass:
        procs["single_pass"] = _compile(
            "single_pass", ROOT / "build" / "decode_ab" / "single_pass",
            Path(single_pass).read_text())
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} does not build:\n{text}")
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                  text)})
        print(f"{name}: registers per thread {regs}", flush=True)
        libs[name] = ctypes.CDLL(str(ROOT / "build" / "decode_ab" / name /
                                     "lib.so"))
    return libs


def single_pass_calls(lib):
    """Kernels 3 and 4 through the single-pass library: the new row written
    first by gather / where / scatter, as the model did, then the kernel."""
    import torch
    from repro_torch.kernels.flash_decode import _write_paged_row, _write_row
    contiguous, paged = lib.flash_decode_fwd, lib.flash_decode_paged_fwd
    contiguous.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_void_p])
    paged.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                      + [ctypes.c_float, ctypes.c_void_p])
    ptr = (lambda t: None if t is None else t.data_ptr())

    def call3(q, k, v, lens, slopes, k_new, v_new, scale):
        _write_row(k, v, lens, k_new, v_new)
        b, kvh, g, d = q.shape
        out = torch.empty((b, kvh, g, d), dtype=q.dtype, device=q.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = contiguous(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         lens.data_ptr(), None, None, slopes.data_ptr(),
                         out.data_ptr(), 1, b, kvh, g, k.shape[2], d, d, 0,
                         scale, stream)
        assert err == 0, err
        return out

    def call4(q, kp, vp, lens, pt, phi_q, phi_pages, k_new, v_new, scale):
        _write_paged_row(kp, vp, lens, pt, k_new, v_new)
        b, kvh, g, d = q.shape
        out = torch.empty((b, kvh, g, d), dtype=q.dtype, device=q.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = paged(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    lens.data_ptr(), pt.data_ptr(), phi_q.data_ptr(),
                    ptr(phi_pages), None, out.data_ptr(), 1, b, kvh, g,
                    pt.shape[1], kp.shape[1], kp.shape[2], d, d,
                    phi_q.shape[-1], phi_pages.shape[0], scale, stream)
        assert err == 0, err
        return out
    return call3, call4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--single-pass", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("decode_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import repro_torch.kernels.flash_decode as kd
    from repro_torch.core.bias import alibi_slopes
    from repro_torch.kernels import build

    names = args.variants.split(",")
    plan = (kd.MAX_SPAN, kd.SPAN_TILE_BYTES)
    libs = build_variants(names, args.single_pass)
    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    b, kvh, d, s = 4, 64, 32, 2048
    scale = d ** -0.5
    q, k, v, lens, _ = cs.decode_inputs(gen, b, kvh, 1, s, d, bf, "none",
                                        LENGTHS)
    slopes = alibi_slopes(kvh, device="cuda").reshape(kvh, 1)
    qp, kp, vp, lens_p, pt, extra = cs.paged_inputs(
        gen, np.random.default_rng(2), b, kvh, 1, d, cs.PAGE, bf,
        "alibi_slab", LENGTHS)
    pt = cs.widen_table(pt, s // cs.PAGE, kp.shape[1])
    k_new, v_new = (torch.randn((b, kvh, d), generator=gen,
                                device="cuda").to(bf) for _ in range(2))
    new = {"k_new": k_new, "v_new": v_new}
    want3 = kd.flash_decode_torch(q, k.clone(), v.clone(), lens,
                                  slopes=slopes, scale=scale, **new)
    want4 = kd.flash_decode_paged_torch(qp, kp.clone(), vp.clone(), lens_p,
                                        pt, scale=scale, **extra, **new)
    tol3, tol4 = cs.tolerance(bf, want3), cs.tolerance(bf, want4)
    sp = single_pass_calls(libs.pop("single_pass")) if args.single_pass \
        else None
    for rnd in range(args.rounds):
        order = list(libs) + (["single_pass"] if sp else [])
        order = order if rnd % 2 == 0 else order[::-1]
        for name in order:
            if name == "single_pass":
                f3 = (lambda: sp[0](q, k, v, lens, slopes, k_new, v_new,
                                    scale))
                f4 = (lambda: sp[1](qp, kp, vp, lens_p, pt,
                                    extra["phi_q"], extra["phi_pages"],
                                    k_new, v_new, scale))
            else:
                build._loaded["flash_decode"] = libs[name]
                kd._kernel.cache_clear()
                kd.MAX_SPAN, kd.SPAN_TILE_BYTES = PLAN.get(name, plan)
                f3 = (lambda: kd.flash_decode_fwd(q, k, v, lens,
                                                  slopes=slopes, scale=scale,
                                                  **new))
                f4 = (lambda: kd.flash_decode_paged_fwd(
                    qp, kp, vp, lens_p, pt, scale=scale, **extra, **new))
            parts = []
            for label, fn, want, tol in (("kernel 3", f3, want3, tol3),
                                         ("kernel 4", f4, want4, tol4)):
                got, again = fn(), fn()
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                same = bool(torch.equal(got, again))
                ms = cs.device_ms(fn)
                parts.append(f"{label} {ms:.4f} ms (max |err| {err:.2e}, "
                             f"tol {tol:.1e}{'' if err <= tol else ', WRONG'}"
                             f"; repeat {'bit-equal' if same else 'DIFFERS'})")
            print(f"round {rnd} {name}: " + "; ".join(parts) + f" [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One rank of a multi-process CPU run of the port's sharded serve engine
(``gloo``; not collected by pytest: the name lacks ``test_``).

    python tests/torch_dist_worker.py --init file:///tmp/x --rank 0 \
        --world 4 --mesh 2x2 --params DIR --out DIR --scenarios a,b

Every rank loads the same parameters (``DIR/<arch>.npz``, written by the
caller from the JAX reference's ``init_params``), serves each scenario's
requests through the unsharded engine and through the engine on a
``(data, model)`` mesh, and writes ``out/rank<R>.json``: both engines'
streams, statuses and page stats, the largest gap between their logits
(every sampling call) and between this rank's state shards and the
unsharded engine's state cut the same way, the collectives of one decode
step and the findings of ``check_backend_mesh``.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

PROMPTS = (13, 7, 18, 5, 26, 9)
SAMPLED = (1, 4)                # requests drawn at temperature 0.8, top-k 20
NEW_TOKENS = 8

# name -> (arch, engine keyword arguments, prompt lengths, shared prefix)
SCENARIOS = {
    "stablelm_contiguous": ("stablelm_12b", {"max_len": 64}, PROMPTS, 0),
    "stablelm_paged_chunked": (
        "stablelm_12b", {"max_len": 64, "prefill_chunk": 4, "page_size": 4,
                         "pages_per_slot": 16}, PROMPTS, 0),
    "stablelm_prefix": (
        "stablelm_12b", {"max_len": 64, "prefill_chunk": 4, "page_size": 4,
                         "pages_per_slot": 16, "prefix_cache": True},
        (5, 9, 3, 11, 6, 2), 12),
    "stablelm_paged_3_slots": (
        "stablelm_12b", {"max_len": 64, "n_slots": 3, "page_size": 4,
                         "n_pages": 20, "pages_per_slot": 16}, PROMPTS, 0),
    "gpt2_alibi_contiguous": ("gpt2_alibi_15b", {"max_len": 64}, PROMPTS, 0),
    "gpt2_alibi_paged": (
        "gpt2_alibi_15b", {"max_len": 64, "page_size": 4,
                           "pages_per_slot": 16}, PROMPTS, 0),
    "granite_moe": ("granite_moe_3b_a800m", {"max_len": 64}, PROMPTS, 0),
    "granite_moe_paged_chunked": (
        "granite_moe_3b_a800m", {"max_len": 64, "prefill_chunk": 4,
                                 "page_size": 4, "pages_per_slot": 16},
        PROMPTS, 0),
    "mamba2": ("mamba2_130m", {"max_len": 64}, PROMPTS, 0),
    "mamba2_chunked": ("mamba2_130m", {"max_len": 64, "prefill_chunk": 4},
                       PROMPTS, 0),
    "hymba_ring": ("hymba_15b", {"max_len": 48, "prefill_chunk": 8},
                   (40, 7, 33, 5, 26, 9), 0),
    "hymba_paged": ("hymba_15b", {"max_len": 32, "page_size": 4,
                                  "pages_per_slot": 8},
                    (13, 7, 18, 5, 20, 9), 0),
}
ARCHS = sorted({arch for arch, _, _, _ in SCENARIOS.values()})
WRAPPERS = ("flash_decode_fwd", "flash_decode_paged_fwd",
            "flashbias_attention_fwd", "flashbias_attention_ragged_fwd",
            "ssd_scan_fwd")


def requests(arch_vocab: int, lens, shared: int):
    """The scenario's prompts (seeded) and their sampling parameters."""
    from repro_torch.serve import SamplingParams
    rng = np.random.default_rng(0)
    common = rng.integers(0, arch_vocab, (shared,)).astype(np.int32)
    out = []
    for i, n in enumerate(lens):
        tail = rng.integers(0, arch_vocab, (n,)).astype(np.int32)
        sp = (SamplingParams(0.8, 20, seed=i) if i in SAMPLED
              else SamplingParams(0.0, 0, seed=i))
        out.append((np.concatenate([common, tail]), sp))
    return out


def load_params(params_dir: str, arch: str):
    from repro_torch.configs import smoke_config
    from repro_torch.interop import params_from_numpy
    flat = np.load(Path(params_dir) / f"{arch}.npz")
    tree: dict = {}
    for key in flat.files:
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return params_from_numpy(tree, smoke_config(arch), device="cpu")


def serve(model, params, kw, reqs, mesh=None):
    """Run the requests (half up front, the rest one per step); returns the
    engine, the streams and every sampling call's logits."""
    import torch
    from repro_torch.serve import ServeEngine
    kw = dict(kw)
    eng = ServeEngine(model, params, n_slots=kw.pop("n_slots", 4),
                      device="cpu", mesh=mesh, **kw)
    seen = []
    sample = eng.backend._sample

    def recording(logits, mask):
        seen.append(logits.detach().clone())
        return sample(logits, mask)
    eng.backend._sample = recording
    half = len(reqs) // 2
    rids = [eng.submit(p, NEW_TOKENS, sampling=sp) for p, sp in reqs[:half]]
    pending = list(reqs[half:])
    while len(eng.scheduler) or eng.occupancy or pending:
        if pending:
            p, sp = pending.pop(0)
            rids.append(eng.submit(p, NEW_TOKENS, sampling=sp))
        eng.step()
    recs = [eng.result(r) for r in rids]
    with torch.no_grad():
        return eng, recs, seen


def local_cut(full, placements, mesh):
    """``full`` cut to this rank's shard by ``placements``."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full, mesh, placements,
                             src_data_rank=None).to_local()


def run_scenario(name: str, mesh, params_dir: str) -> dict:
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import get_model
    from repro_torch.statcheck import check_backend_mesh
    arch, kw, lens, shared = SCENARIOS[name]
    cfg = smoke_config(arch)
    model, params = get_model(cfg), load_params(params_dir, arch)
    reqs = requests(cfg.vocab, lens, shared)
    ref, ref_recs, ref_logits = serve(model, params, kw, reqs)
    eng, recs, logits = serve(model, params, kw, reqs, mesh=mesh)
    out = {
        "streams": [r.tolist() for r in recs],
        "ref_streams": [r.tolist() for r in ref_recs],
        "statuses": [r.status for r in recs],
        "ref_statuses": [r.status for r in ref_recs],
        "page_stats": eng.page_stats(),
        "ref_page_stats": ref.page_stats(),
        "sample_calls": [len(logits), len(ref_logits)],
    }
    out["logit_gap"] = max(
        (float((a - b).abs().max()) for a, b in zip(logits, ref_logits)),
        default=0.0)
    be, rb = eng.backend, ref.backend
    gaps = {}
    for key, d in be.state_dtensors().items():
        full = rb._last_tok if key == "last_tok" else rb._cache[key]
        want = local_cut(full, d.placements, mesh)
        got = d.to_local()
        gaps[key] = (float((got.double() - want.double()).abs().max())
                     if got.shape == want.shape else
                     f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    out["state_gaps"] = gaps
    out["placements"] = {k: [repr(p) for p in d.placements]
                         for k, d in be.state_dtensors().items()}
    # the heads' all-reduce where model splits, the all-gather of the
    # slot rows where data splits them; with neither, no collective at all
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    rows_split = be._rows.stop - be._rows.start < be.n_slots
    expect = (("all_reduce",) if sizes["model"] > 1 else ()) + (
        ("all_gather_into_tensor",) if rows_split else ())
    out["findings"] = [str(f) for f in check_backend_mesh(
        be, expect_any=expect, expect_all=expect)]
    out["rows"] = [be._rows.start, be._rows.stop]
    del ref, eng
    torch.distributed.barrier()
    return out


def run_units(mesh) -> dict:
    """``shard_put`` placements and replication, ``constrain``, and the
    kernel wrappers' refusal of a DTensor, on the ``(2, 2)`` mesh."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.dist import Rules, constrain, shard_put, use_mesh_rules
    from repro_torch.kernels import flash_decode, flashbias_attn, ssd_scan
    out = {"shard_put": {}}
    for axes, shape in ((("batch", "heads"), (4, 6)),
                        (("batch", "heads"), (3, 6)),
                        (("batch", "mlp"), (4, 5)),
                        (("layers", "kv_heads"), (2, 4))):
        d = shard_put(torch.arange(float(np.prod(shape))).reshape(shape),
                      mesh, Rules(), axes)
        out["shard_put"][f"{','.join(axes)} {shape[0]}x{shape[1]}"] = [
            str(tuple(d.placements)), list(d.to_local().shape)]
    x = distribute_tensor(torch.ones(4, 2), mesh, [Replicate(), Replicate()])
    with use_mesh_rules(mesh, Rules()):
        inside = constrain(x, "batch", None)
    out["constrain"] = {"inside": str(tuple(inside.placements)),
                        "outside": constrain(x, "batch", None) is x}
    t = distribute_tensor(torch.ones(1, 1, 1, 16), mesh,
                          [Replicate(), Replicate()])
    calls = {
        "flash_decode_fwd": lambda: flash_decode.flash_decode_fwd(
            t, t, t, t, scale=1.0),
        "flash_decode_paged_fwd": lambda: flash_decode.flash_decode_paged_fwd(
            t, t, t, t, t, scale=1.0),
        "flashbias_attention_fwd":
            lambda: flashbias_attn.flashbias_attention_fwd(t, t, t,
                                                           scale=1.0),
        "flashbias_attention_ragged_fwd":
            lambda: flashbias_attn.flashbias_attention_ragged_fwd(
                t, t, t, None, None, None, t, scale=1.0),
        "ssd_scan_fwd": lambda: ssd_scan.ssd_scan_fwd(t, t, t, t, t),
    }
    refused = []
    for name, call in calls.items():
        try:
            call()
        except TypeError as e:
            if "DTensor" in str(e):
                refused.append(name)
    out["refused"] = sorted(refused)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--params", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--scenarios", required=True)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=args.init, rank=args.rank,
                            world_size=args.world,
                            timeout=datetime.timedelta(seconds=60))
    d, m = (int(v) for v in args.mesh.split("x"))
    mesh = init_device_mesh("cpu", (d, m), mesh_dim_names=("data", "model"))
    results = {}
    for name in args.scenarios.split(","):
        try:
            results[name] = (run_units(mesh) if name == "units" else
                             run_scenario(name, mesh, args.params))
        except Exception as e:           # reported, then the rank stops
            results[name] = {"error": f"{type(e).__name__}: {e}"}
            Path(args.out, f"rank{args.rank}.json").write_text(
                json.dumps(results))
            raise
    Path(args.out, f"rank{args.rank}.json").write_text(json.dumps(results))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())

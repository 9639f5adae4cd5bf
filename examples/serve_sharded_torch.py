"""The sharded serve engine of the PyTorch port on a (2, 2) device mesh.

Runs the continuous-batching engine on a ``(data, model)`` ``DeviceMesh``:
the weights split their heads, FFN columns and vocab over ``model``, the
slot rows split over ``data``, the KV page pool splits along ``kv_heads``
(and is whole on every ``data`` rank), while the page allocator and the
page tables stay on the host. Admission is chunked: prompts land 4 tokens
per engine step, between decode steps.

It then shows that the mesh is real: the decode step issues collectives
(counted under ``CommDebugMode`` by ``statcheck.check_backend_mesh``), and
the streams equal the unsharded engine's (the sums over ranks reorder the
float32 arithmetic, so the logits agree to rounding, not bit for bit).

Four ``gloo`` processes on the CPU, started here, or a world of four that
``torchrun`` started (four cards with ``--device cuda``):

    PYTHONPATH=src python examples/serve_sharded_torch.py
    torchrun --nproc-per-node 4 examples/serve_sharded_torch.py
"""
import argparse
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

PROMPTS = [13, 7, 18, 5, 26, 9]
MESH = (2, 2)


def run(model, params, cfg, device, mesh=None):
    from repro_torch.serve import SamplingParams, ServeEngine
    engine = ServeEngine(model, params, max_len=64, n_slots=4,
                         prefill_chunk=4, page_size=4, pages_per_slot=16,
                         mesh=mesh, device=device)
    rng = np.random.default_rng(0)
    rids = [engine.submit(
        rng.integers(0, cfg.vocab, (n,)).astype(np.int32), 8,
        sampling=SamplingParams(0.0, 0, seed=i))
        for i, n in enumerate(PROMPTS)]
    engine.run()
    return engine, [engine.result(r) for r in rids]


def rank_main(device_type: str, init_method: str) -> list:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import smoke_config
    from repro_torch.models import get_model, init_params
    from repro_torch.statcheck import check_backend_mesh

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world != MESH[0] * MESH[1]:
        raise SystemExit(f"a (2, 2) mesh needs 4 ranks, got {world}")
    device = torch.device(device_type)
    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         rank)))
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world)
    mesh = init_device_mesh(device_type, MESH,
                            mesh_dim_names=("data", "model"))
    say = print if rank == 0 else (lambda *a: None)

    cfg = smoke_config("stablelm_12b")
    model = get_model(cfg)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    engine, outs = run(model, params, cfg, device, mesh)
    say(f"[sharded] {cfg.name} on mesh {MESH} (data, model): "
        f"{len(PROMPTS)} requests, chunked prefill (chunk=4)")
    say("[sharded] first request:", outs[0].tolist())

    findings = check_backend_mesh(engine.backend,
                                  expect_all=("all_reduce",))
    assert not findings, [str(f) for f in findings]
    say("[sharded] decode step issues collectives; state axes and "
        "placements check out")

    _, outs1 = run(model, params, cfg, device)
    assert all(a.size == b.size and (a == b).all()
               for a, b in zip(outs, outs1)), "mesh run diverged"
    say("[sharded] streams equal the unsharded engine's")
    dist.destroy_process_group()
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    if "RANK" in os.environ:                 # torchrun, or a spawned rank
        rank_main(args.device, os.environ.get("INIT_METHOD", "env://"))
        return 0
    world = MESH[0] * MESH[1]
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                   INIT_METHOD=f"file://{tmp}/store")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--device", args.device],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
            for r in range(world)]
        try:
            codes = [p.wait(timeout=120) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    if any(codes):
        print(f"[sharded] ranks exited with {codes}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

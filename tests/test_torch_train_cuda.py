"""Training and the decode dispatch's layouts on the card (tests marked
``cuda``, which skip without one; no JAX here, so they also run where it
is absent):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_train_cuda.py

- ``ops.flash_decode`` with ``kv_layout="bshd"`` (contiguous and paged)
  and with per-q-head factors (G 2 and 4; the route repeats the keys over
  each group and runs kernel 3 or 4 at G = 1) at D 96 on the card, against
  the plain path on the CPU: float32 within 1e-4 (summation order), bf16
  within 2 bf16 ulps of the output's scale; the new row written into the
  caller's bshd cache as the plain path writes it; the kernel launched once
  per call.
- A float32 SMOKE LM (``gpt2_alibi_15b``, remat "dots") and the SSM
  (``mamba2_130m``) trained 3 steps on the card through the kernel path
  against the same steps on the CPU: losses within 1e-4 relative (float32
  sums in other orders), kernel 1 (kernel 5) launched twice per layer and
  microbatch (the backward recomputes the checkpointed layer).
- A checkpoint saved on the card restores onto it, and the resumed loop's
  losses equal the uninterrupted ones bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.data import LMBatches
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                              flash_decode_paged_fwd)
from repro_torch.kernels.flashbias_attn import flashbias_attention_fwd
from repro_torch.kernels.ssd_scan import ssd_scan_fwd
from repro_torch.models import get_model, init_params
from repro_torch.models.common import tree_map
from repro_torch.optim import AdamW, cosine
from repro_torch.train import TrainLoop, make_train_step

pytestmark = pytest.mark.cuda

B, KVH, D, R, S, PS = 3, 4, 96, 3, 300, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, ref):
    if dtype == torch.float32:
        return 1e-4
    return 2.0 ** -6 * max(1.0, float(ref.float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_bshd_per_q_head_decode_on_card_matches_cpu(cuda, paged, g, dtype):
    gen = torch.Generator().manual_seed(g)
    h = KVH * g
    lengths = torch.tensor([1, 177, S - 1], dtype=torch.int32)
    q = torch.randn((B, 1, h, D), generator=gen).to(dtype)
    k = torch.randn((B, S, KVH, D), generator=gen).to(dtype)
    v = torch.randn((B, S, KVH, D), generator=gen).to(dtype)
    k_new = torch.randn((B, KVH, D), generator=gen).to(dtype)
    v_new = torch.randn((B, KVH, D), generator=gen).to(dtype)
    phi_q = torch.randn((B, 1, h, R), generator=gen)
    phi_k = torch.randn((B, S, h, R), generator=gen)        # per q head
    kw = {}
    if paged:
        n_pages = B * (-(-S // PS)) + 2
        table = torch.randperm(n_pages, generator=gen)[:B * (-(-S // PS))]
        table = table.reshape(B, -1).to(torch.int32)
        pools = []
        for x in (k, v, phi_k):
            pool = torch.zeros((n_pages, PS) + x.shape[2:], dtype=x.dtype)
            padded = torch.nn.functional.pad(
                x, (0, 0, 0, 0, 0, table.shape[1] * PS - S))
            pool[table.reshape(-1).long()] = padded.reshape(
                (-1, PS) + x.shape[2:])
            pools.append(pool)
        k, v, phi_k = pools
        kw["page_table"] = table
    launches = (flash_decode_paged_fwd if paged else flash_decode_fwd)
    outs, caches = {}, {}
    for name, dev in (("plain", "cpu"), ("kernel", cuda)):
        kc, vc = k.clone().to(dev), v.clone().to(dev)
        before = launches.launches
        outs[name] = ops.flash_decode(
            q.to(dev), kc, vc, lengths.to(dev), phi_q=phi_q.to(dev),
            phi_k=phi_k.to(dev), k_new=k_new.to(dev), v_new=v_new.to(dev),
            impl="cuda", **{n: t.to(dev) for n, t in kw.items()}).cpu()
        caches[name] = (kc.cpu(), vc.cpu())
        assert launches.launches - before == (name == "kernel")
    want = outs["plain"]
    err = float((outs["kernel"].float() - want.float()).abs().max())
    assert err <= _tol(dtype, want), err
    for a, b in zip(caches["plain"], caches["kernel"]):
        assert torch.equal(a, b)


def _train(cfg, device, steps: int, ckpt_dir=None, num=None, seed=0):
    opt = AdamW(lr_fn=cosine(1e-3, 1, steps))
    data = LMBatches(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=seed)
    params = tree_map(lambda t: t.to(device), init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu"))
    losses = []

    def step(p, o, b):
        out = step_fn(p, o, b)
        losses.append(float(out[2]["loss"]))
        return out
    step_fn = make_train_step(get_model(cfg).loss, opt,
                              grad_accum=cfg.grad_accum)
    loop = TrainLoop(step, lambda s: {k: torch.as_tensor(x, device=device)
                                      for k, x in data.batch(s).items()},
                     ckpt_dir=ckpt_dir, ckpt_every=2)
    loop.run(params, opt.init(params), num or steps)
    return losses


@pytest.mark.parametrize("arch", ["gpt2_alibi_15b", "mamba2_130m"])
def test_training_on_card_matches_cpu(cuda, arch):
    cfg = smoke_config(arch).replace(remat="dots", grad_accum=2,
                                     attn_impl="cuda")
    want = _train(cfg.replace(attn_impl="torch"), "cpu", 3)
    counter = (ssd_scan_fwd if arch == "mamba2_130m"
               else flashbias_attention_fwd)
    before = counter.launches
    got = _train(cfg, cuda, 3)
    assert counter.launches - before == 3 * 2 * cfg.n_layers * 2
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_resume_on_card_is_bit_exact(cuda, tmp_path):
    cfg = smoke_config("gpt2_alibi_15b").replace(remat="dots",
                                                 attn_impl="cuda")
    whole = _train(cfg, cuda, 5)
    _train(cfg, cuda, 5, ckpt_dir=str(tmp_path), num=3)
    resumed = _train(cfg, cuda, 5, ckpt_dir=str(tmp_path))
    assert resumed == whole[3:]

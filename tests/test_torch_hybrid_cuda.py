"""The hybrid family's kernels on the card (tests marked ``cuda``, which skip
without one; no JAX here, so they also run where it is absent):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_hybrid_cuda.py

- Kernel 1 in its ``local`` mask mode at the hymba prefill's shapes (48
  heads over 6 kv heads, D 64, window 1024, ALiBi, bf16) against its plain
  version, one batch row at a time: N 3000 (a partial last 64-row tile and
  rows whose window starts mid-tile), N 1024 (exactly the window), N 1100
  and N 130, every bf16 call on the tensor-core body; N 1100 and 130 in
  float32 on the CUDA-core body. Tolerance: 2 bf16 ulps at the output's
  scale (both sides round one float32 result once), float32 1e-4
  (summation order).
- Kernel 5 at N 16 (64 heads x 64, chunk 256, float32, one b/c group, as
  the hymba SSM branch calls it), with and without a carried ``h0``, on the
  tensor-core body: ``1e-4 x max(1, max|ref|)`` (summation order and the
  bf16 hi + lo split, < 2^-15 relative per product term).
- A float32 hymba-shaped SMOKE model (state 16) prefilled past its window
  and decoded over the ring on the card, kernel path against the plain path
  (``attn_impl="torch"``): logits within 1e-3 (float32 sums in other orders
  through 2 layers), kernel 1 and kernel 5 launched once per layer, and the
  decode steps launch no kernel.
"""
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels.flashbias_attn import (
    flashbias_attention_fwd,
    flashbias_attention_torch,
)
from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_torch
from repro_torch.models import get_model, init_params

pytestmark = pytest.mark.cuda

H, KVH, D, WINDOW = 48, 6, 64, 1024


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, ref) -> float:
    if dtype == torch.float32:
        return 1e-4
    return 2.0 ** -6 * max(1.0, float(ref.float().abs().max()))


KERNEL1_CASES = [(3000, torch.bfloat16), (1024, torch.bfloat16),
                 (1100, torch.bfloat16), (130, torch.bfloat16),
                 (1100, torch.float32), (130, torch.float32)]


@pytest.mark.parametrize("n,dtype", KERNEL1_CASES,
                         ids=[f"N{n}-{str(d)[6:]}" for n, d in KERNEL1_CASES])
def test_kernel1_local_at_the_hymba_shape(cuda, n, dtype):
    gen = torch.Generator(device="cuda").manual_seed(n)
    q = torch.randn((2, H, n, D), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((2, KVH, n, D), generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    slopes = torch.rand((H,), generator=gen, device=cuda) * 0.1
    kw = dict(scale=D ** -0.5, mask_kind="local", window=WINDOW)
    before = (flashbias_attention_fwd.launches,
              flashbias_attention_fwd.tensor_core_launches)
    got = flashbias_attention_fwd(q, k, v, None, None, slopes, **kw)
    torch.cuda.synchronize()
    assert flashbias_attention_fwd.launches == before[0] + 1
    assert flashbias_attention_fwd.tensor_core_launches == before[1] + (
        dtype == torch.bfloat16)
    for b in range(2):
        want = flashbias_attention_torch(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                         None, None, slopes, **kw)
        err = float((got[b:b + 1].float() - want.float()).abs().max())
        assert err <= _tol(dtype, want), (b, err)


@pytest.mark.parametrize("s,with_h0", [(3000, False), (700, True),
                                       (512, True)])
def test_kernel5_at_state_16(cuda, s, with_h0):
    gen = torch.Generator(device="cuda").manual_seed(s)
    bsz, h, p, n = 4, 64, 64, 16
    x = torch.randn((bsz, s, h, p), generator=gen, device=cuda)
    dt = torch.nn.functional.softplus(
        torch.randn((bsz, s, h), generator=gen, device=cuda))
    a = -torch.exp(0.3 * torch.randn((h,), generator=gen, device=cuda))
    b, c = (torch.randn((bsz, 1, s, n), generator=gen, device=cuda)
            for _ in range(2))
    h0 = (torch.randn((bsz, h, p, n), generator=gen, device=cuda)
          if with_h0 else None)
    args = (x.transpose(1, 2), dt.transpose(1, 2), a, b, c)
    before = (ssd_scan_fwd.launches, ssd_scan_fwd.tensor_core_launches,
              ssd_scan_fwd.device_kernels)
    y, h_fin = ssd_scan_fwd(*args, chunk=256, h0=h0)
    torch.cuda.synchronize()
    assert ssd_scan_fwd.launches == before[0] + 1
    assert ssd_scan_fwd.tensor_core_launches == before[1] + 1
    assert ssd_scan_fwd.device_kernels == before[2] + 4
    y_ref, h_ref = ssd_scan_torch(*args, chunk=256, h0=h0)
    for got, want in ((y, y_ref), (h_fin, h_ref)):
        assert torch.isfinite(got).all()
        err = float((got - want).abs().max())
        assert err <= 1e-4 * max(1.0, float(want.abs().max())), err


def test_hymba_model_on_the_card_matches_the_plain_path(cuda):
    cfg = smoke_config("hymba_15b").replace(ssm_state=16, ssd_chunk=64)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device=cuda)
    w = cfg.window
    toks = torch.randint(0, cfg.vocab, (3, 2 * w + 5), device=cuda,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))
    lens = torch.tensor([2 * w + 5, w, 7], dtype=torch.int32, device=cuda)
    out = {}
    for impl in ("cuda", "torch"):
        model = get_model(cfg.replace(attn_impl=impl))
        counts = (flashbias_attention_fwd.launches, ssd_scan_fwd.launches)
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": toks},
                                          max_len=4 * w, lengths=lens)
            steps = [logits]
            nxt = toks[:, :1]                       # the same feed for both
            launched = (flashbias_attention_fwd.launches - counts[0],
                        ssd_scan_fwd.launches - counts[1])
            for _ in range(w + 2):                  # every row wraps
                logits, cache = model.decode(params, cache, nxt)
                steps.append(logits)
        torch.cuda.synchronize()
        assert cache["k"].shape[3] == w
        after = (flashbias_attention_fwd.launches - counts[0],
                 ssd_scan_fwd.launches - counts[1])
        want = (cfg.n_layers, cfg.n_layers) if impl == "cuda" else (0, 0)
        assert launched == after == want, (impl, launched, after)
        out[impl] = torch.cat(steps, 1)
    err = float((out["cuda"] - out["torch"]).abs().max())
    assert err <= 1e-3, err

"""Kernel 5 (``csrc/ssd_scan.cu``) against its plain version on the card.

Marked ``cuda``: each test skips inside a fixture where no CUDA device is
present. The off-path cases of ``chip_smoke.py``'s kernel phase: S not a
multiple of the chunk, S shorter than one chunk, a nonzero ``h0``, b / c
shared over heads and per head, a dt large enough that an unmasked
``exp(cum_i - cum_j)`` would overflow, float32 and bf16 x, other head and
state widths, and x / y as strided views of the model's ``(B, S, H, P)``
layout. Each case names the body it takes: the tensor-core body (P and N
multiples of 16, chunk a multiple of 64), whose calls move
``.tensor_core_launches`` and launch four device kernels with one b/c
group and three with per-head b / c, or the CUDA-core body (one device
kernel), which leaves that counter alone. Tolerance, y and h_fin: float32
``1e-4 x max(1, max|ref|)`` (summation order of sums of up to chunk x N
terms and, on the tensor-core body, the bf16 hi + lo split of each
operand, < 2^-15 relative per product term); bf16 y ``2^-6 x max(1,
max|ref|)`` (both sides round one float32 result once: 2 bf16 ulps at the
output's scale). Runs on the GPU machine, which has no JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_ssd_kernel.py
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, ref):
    scale = max(1.0, float(ref.float().abs().max()))
    return (1e-4 if dtype == torch.float32 else 2.0 ** -6) * scale


def _inputs(gen, bsz, s, h, p, n, heads_bc, dtype, dt_shift=0.0):
    """x as a (B, H, S, P) view of a (B, S, H, P) tensor (the model's
    layout), dt (B, H, S) likewise, b / c (B, 1|H, S, N)."""
    dev = "cuda"
    x = torch.randn((bsz, s, h, p), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((bsz, s, h), generator=gen, device=dev)) + dt_shift
    a = -torch.exp(0.3 * torch.randn((h,), generator=gen, device=dev))
    g = h if heads_bc else 1
    b = torch.randn((bsz, g, s, n), generator=gen, device=dev)
    c = torch.randn((bsz, g, s, n), generator=gen, device=dev)
    return x.transpose(1, 2), dt.transpose(1, 2), a, b, c


def _check(got, want, dtype):
    torch.cuda.synchronize()
    (y, h), (y_ref, h_ref) = got, want
    assert y.dtype == dtype and y.shape == y_ref.shape
    assert h.shape == h_ref.shape and h.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    err_y = float((y.float() - y_ref.float()).abs().max())
    err_h = float((h - h_ref).abs().max())
    assert err_y <= _tol(dtype, y_ref), err_y
    assert err_h <= _tol(torch.float32, h_ref), err_h


CASES = [
    # (name, B, S, H, P, N, chunk, heads_bc, dtype, h0, dt_shift,
    #  tensor-core body)
    ("S1000 not a chunk multiple", 2, 1000, 4, 64, 128, 256, False,
     torch.float32, False, 0.0, True),
    ("S100 shorter than a chunk, h0", 2, 100, 4, 64, 128, 256, False,
     torch.float32, True, 0.0, True),
    ("S600 b/c per head, h0", 2, 600, 4, 64, 128, 256, True, torch.float32,
     True, 0.0, True),
    ("S600 bf16 x, h0", 2, 600, 4, 64, 128, 256, False, torch.bfloat16,
     True, 0.0, True),
    ("S300 dt + 20 (unmasked exp overflows)", 2, 300, 4, 64, 128, 256,
     False, torch.float32, False, 20.0, True),
    ("P32 N64 chunk 128 S333", 3, 333, 3, 32, 64, 128, True, torch.float32,
     True, 0.0, True),
    ("P16 N16 chunk 48 S97 bf16", 2, 97, 2, 16, 16, 48, False,
     torch.bfloat16, False, 0.0, False),
    # the tensor-core body at the SSM path's widths: B2 S1000 H4 P64 N128
    ("tensor cores S1000 b/c shared, h0", 2, 1000, 4, 64, 128, 256, False,
     torch.float32, True, 0.0, True),
    ("tensor cores S1000 b/c per head, h0", 2, 1000, 4, 64, 128, 256, True,
     torch.float32, True, 0.0, True),
    ("tensor cores S1000 bf16 x b/c shared, h0", 2, 1000, 4, 64, 128, 256,
     False, torch.bfloat16, True, 0.0, True),
    ("tensor cores S1000 bf16 x b/c per head", 2, 1000, 4, 64, 128, 256,
     True, torch.bfloat16, False, 0.0, True),
    ("tensor cores P128 N256 chunk 64 S200 h0", 1, 200, 2, 128, 256, 64,
     False, torch.float32, True, 0.0, True),
    ("tensor cores P48 N144 chunk 192 S401 b/c per head", 2, 401, 3, 48,
     144, 192, True, torch.float32, False, 0.0, True),
    # shapes off the tensor-core body
    ("P20 N8 chunk 64 S130 (P off 16)", 2, 130, 3, 20, 8, 64, False,
     torch.float32, True, 0.0, False),
    ("P64 N128 chunk 96 S300 (chunk off 64)", 2, 300, 2, 64, 128, 96, True,
     torch.float32, True, 0.0, False),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain_version(cuda, case):
    _, bsz, s, h, p, n, chunk, heads_bc, dtype, with_h0, shift, tc = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, dt, a, b, c = _inputs(gen, bsz, s, h, p, n, heads_bc, dtype, shift)
    h0 = (torch.randn((bsz, h, p, n), generator=gen, device="cuda")
          if with_h0 else None)
    before = (ssd_scan_fwd.launches, ssd_scan_fwd.tensor_core_launches,
              ssd_scan_fwd.device_kernels)
    got = ssd_scan_fwd(x, dt, a, b, c, chunk=chunk, h0=h0)
    assert ssd_scan_fwd.launches == before[0] + 1
    assert ssd_scan_fwd.tensor_core_launches == before[1] + tc
    kernels = (3 if heads_bc else 4) if tc else 1
    assert ssd_scan_fwd.device_kernels == before[2] + kernels
    # y comes back in x's memory layout: a view of a (B, S, H, P) tensor
    assert got[0].transpose(1, 2).is_contiguous()
    _check(got, ssd_scan_torch(x, dt, a, b, c, chunk=chunk, h0=h0), dtype)


def test_ops_dispatch_on_the_card(cuda):
    """``ops.ssd_scan`` in the model's layout: ``"auto"`` launches the kernel
    (zero-copy views) and matches the ``"torch"`` path."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    bsz, s, h, p, n = 2, 700, 4, 64, 128
    x = torch.randn((bsz, s, h, p), generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn((bsz, s, h), generator=gen, device="cuda"))
    a = -torch.exp(0.3 * torch.randn((h,), generator=gen, device="cuda"))
    bc = torch.randn((bsz, s, 2 * n), generator=gen, device="cuda")
    b, c = bc[..., :n], bc[..., n:]                # strided, as the model's
    before = ssd_scan_fwd.launches
    got = ops.ssd_scan(x, dt, a, b, c, chunk=256)
    assert ssd_scan_fwd.launches == before + 1
    want = ops.ssd_scan(x, dt, a, b, c, chunk=256, impl="torch")
    assert got[0].is_contiguous()
    _check(got, want, torch.float32)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(2)
    x, dt, a, b, c = _inputs(gen, 1, 64, 2, 6, 16, False, torch.float32)
    with pytest.raises(ValueError, match="multiples of 4"):
        ssd_scan_fwd(x, dt, a, b, c, chunk=32)
    x, dt, a, b, c = _inputs(gen, 1, 64, 2, 16, 16, False, torch.float32)
    with pytest.raises(ValueError, match="h0"):
        ssd_scan_fwd(x, dt, a, b, c, chunk=32,
                     h0=torch.zeros((1, 2, 16, 8), device="cuda"))

"""Kernel 1 at the paper's vision and PDE shapes, on the card (tests marked
``cuda``, which skip without one; no JAX here, so they also run where it is
absent):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_swin_pde_cuda.py

- the Swin shape (N = 576, 16 heads x 32, rank 16, no mask) with factors
  broadcast over the windows from ``(H, W, R)``, as ``swin.forward`` passes
  them;
- a PDE shape with N off the 64-row tile, head dim 16, rank 9 float32
  factors and ``phi_k`` shared by the heads (``(B, N, 1, 9)`` into
  ``ops.flash_attention``, which expands it), bf16 and float32;
- each bf16 call takes the tensor-core body, each float32 call the
  CUDA-core one; the models' forwards launch the kernel once per layer.

Tolerance: float32, summation order only (1e-4); bfloat16, 2 bf16 ulps at
the output's scale (both sides round the same float32 result once).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.flashbias_attn import (
    flashbias_attention_fwd,
    flashbias_attention_torch,
)
from repro_torch.models import pde, swin
from repro_torch.models.common import init_params


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


def _check(got, want, dtype, tc_before):
    torch.cuda.synchronize()
    tc = flashbias_attention_fwd.tensor_core_launches - tc_before
    assert tc == (dtype == torch.bfloat16), tc
    err = float((got.float() - want.float()).abs().max())
    assert torch.isfinite(got).all() and err <= _tol(dtype, want), err


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [8, 128])
def test_kernel1_at_the_swin_shape(cuda, windows):
    """bf16 q/k/v and rank-16 factors, rounded to bf16 and broadcast over
    the windows from (H, W, R), no mask."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    h, n, d, r = 16, 576, 32, 16
    q, k, v = (torch.randn((windows, h, n, d), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    pq, pk = ((0.35 * torch.randn((h, n, r), generator=gen, device=cuda))
              .to(torch.bfloat16)[None].expand(windows, h, n, r)
              for _ in range(2))
    before = flashbias_attention_fwd.tensor_core_launches
    got = flashbias_attention_fwd(q, k, v, pq, pk, scale=d ** -0.5)
    want = flashbias_attention_torch(q, k, v, pq, pk, scale=d ** -0.5)
    _check(got, want, torch.bfloat16, before)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [4154, 187])
def test_kernel1_at_a_pde_shape(cuda, dtype, n):
    """N off the 64-row tile, head dim 16, float32 rank-9 factors of the
    scaled squared distance, ``phi_k`` shared by the 8 heads, through
    ``ops.flash_attention`` in the model's layout."""
    from repro_torch.core.bias import sqdist_factors
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, h, d = 1, 8, 16
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    x = torch.rand((b, n, 3), generator=gen, device=cuda)
    alpha = torch.nn.functional.softplus(
        torch.randn((b, n, h), generator=gen, device=cuda) + 1.0)
    pq0, pk0 = sqdist_factors(x, x)
    pq, pk = alpha[..., None] * pq0[:, :, None], pk0[:, :, None]
    before = flashbias_attention_fwd.tensor_core_launches
    got = ops.flash_attention(q, k, v, pq, pk, impl="cuda")
    want = ops.flash_attention(q, k, v, pq, pk, impl="torch")
    _check(got, want, dtype, before)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["swinv2_b", "pde_solver"])
def test_forward_launches_kernel1_once_per_layer(cuda, arch):
    """SMOKE at bf16 on the card: one tensor-core launch per layer, and the
    logits within 2 bf16 ulps x depth of the plain path's."""
    cfg = smoke_config(arch).replace(dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(2)
    params = init_params(cfg, gen, device=cuda)
    rng = np.random.default_rng(3)
    if arch == "swinv2_b":
        x = torch.tensor(rng.standard_normal((2, 2, cfg.window, 48)),
                         dtype=torch.float32, device=cuda)
        factors = swin.svd_factorize(params, cfg.bias_rank)

        def run(impl):
            return swin.forward(params, x, cfg.replace(attn_impl=impl),
                                factors)
    else:
        x = torch.tensor(rng.uniform(0, 1, (1, 300, 3)), dtype=torch.float32,
                         device=cuda)

        def run(impl):
            return pde.forward(params, x, cfg.replace(attn_impl=impl))
    launches = flashbias_attention_fwd.launches
    tc = flashbias_attention_fwd.tensor_core_launches
    with torch.no_grad():
        got = run("cuda")
        torch.cuda.synchronize()
        assert flashbias_attention_fwd.launches - launches == cfg.n_layers
        assert (flashbias_attention_fwd.tensor_core_launches - tc
                == cfg.n_layers)
        want = run("torch")
    err = float((got.float() - want.float()).abs().max())
    assert err <= cfg.n_layers * _tol(torch.bfloat16, want), err

"""The backward kernel (``flashbias_attention_bwd``) on the card (tests
marked ``cuda``, which skip without one; no JAX here, so they also run
where it is absent):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_attention_backward_cuda.py

- Its gradients of q, k, v and the factors against the plain float32
  backward at the training shapes: the PDE solver (B 1, H 8, N = M = 32186,
  D 16, R 9, ``phi_k`` shared by the heads), once with random factors and
  once with the model's: the squared-distance factors of points in the
  unit cube (``sqdist_factors``) scaled by a per-query, per-head alpha; the
  reference there is ``ops._recompute_grads`` (the forward recomputed by
  query blocks and differentiated). GPT-2-ALiBi-1.5B (B 2, H 64, N 1024, D
  32, ALiBi, causal), the Pairformer (B 1, H 4, N 384, D 96, R 96) and, at
  small shapes, every mask and bias mode, GQA, ragged tiles and each width
  the kernel is built for, against ``flashbias_attention_bwd_torch`` (on
  the same cotangent and kernel 1's lse). Two calls on the same inputs
  give the same bits.
- Kernel 1's ``return_lse`` against the plain forward's; the output with
  it bit-equal to the output without it.
- One PDE training step at full width (8192 points) launches the backward
  kernel once per layer and never enters the plain recompute.

Tolerances, each of a gradient's scale (its largest magnitude). q, k and v:
2^-6. The kernel rounds P and dS to bf16 where they are mma operands (2^-9
relative each) and the gradients of q, k, v to bf16 once; summed over
thousands of keys the worst element sits near 2^-8 of the scale (at most
6.9e-3 measured on an H100). The factors: TOL_PHI = 2^-10 (9.8e-4). Their
products split dS and the factors into bf16 hi + lo (hi.hi + hi.lo +
lo.hi); what is left includes kernel 1's lse (within 2e-4 of the plain
forward's), which scales each row's P. On an H100 (80GB HBM3, 700 W) the
kernel read at most 3.7e-4 over these cases and 4.3e-4 at the PDE shape of
``chip_smoke.py``'s phase 24, while one bf16 pass of the two products (dS
and the factors each rounded to bf16 once, float32 sums:
``_one_bf16_pass_dphi``) read 1.95e-3 and 5.6e-3 at the PDE shape with
random factors, 4.2e-3 and 5.4e-3 with the model's (dphi_k, dphi_q).
TOL_PHI lies between, 2.3x above the one and 2x below the other, and the
PDE case with the model's factors checks that the one-pass control fails
it on both factors. lse: within 2e-4 of the plain forward's (the bias's
hi / lo split; +inf on the same rows).
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.core.bias import sqdist_factors
from repro_torch.kernels import ops
from repro_torch.kernels.flashbias_attn import (flashbias_attention_bwd,
                                                flashbias_attention_bwd_torch,
                                                flashbias_attention_fwd,
                                                flashbias_attention_torch)
from repro_torch.models import get_model, init_params
from repro_torch.models.common import tree_leaves

pytestmark = pytest.mark.cuda

NAMES = ("dq", "dk", "dv", "dphi_q", "dphi_k")
TOL_PHI = 2.0 ** -10
TOL = {"dq": 2.0 ** -6, "dk": 2.0 ** -6, "dv": 2.0 ** -6,
       "dphi_q": TOL_PHI, "dphi_k": TOL_PHI}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, kvh, n, m, d, r, bias, shared=False, sqdist=False):
    """bf16 q, k, v and dO, float32 factors (random, or the PDE model's
    scaled squared-distance factors with ``sqdist``) or ALiBi slopes."""
    g = torch.Generator(device="cuda").manual_seed(n + m + d + r)
    t = lambda *s: torch.randn(s, generator=g, device="cuda")
    q, k, v = t(b, h, n, d).bfloat16(), t(b, kvh, m, d).bfloat16(), \
        t(b, kvh, m, d).bfloat16()
    pq = pk = sl = None
    if sqdist:
        pts = torch.rand((b, n, 3), generator=g, device="cuda")
        alpha = F.softplus(t(b, n, h))
        pq0, pk0 = sqdist_factors(pts, pts, negate=True)
        pq = (alpha[..., None] * pq0[:, :, None]).transpose(1, 2) \
            .contiguous()
        pk = pk0[:, None].expand_as(pq)
    elif bias == "phi":
        pq = t(b, h, n, r)
        pk = t(b, 1, m, r).expand(b, h, m, r) if shared else t(b, h, m, r)
    if bias == "alibi":
        sl = torch.rand(h, generator=g, device="cuda") * 0.5
    return q, k, v, t(b, h, n, d).bfloat16(), pq, pk, sl


def _run(b, h, kvh, n, m, d, r, mask, bias, window=0, shared=False,
         sqdist=False, blocked=False):
    """Kernel 1 forward with lse, the backward kernel twice, and the plain
    backward: ``flashbias_attention_bwd_torch`` on the same cotangent and
    lse, or with ``blocked`` ``ops._recompute_grads`` (where the dense
    scores would not fit)."""
    q, k, v, do, pq, pk, sl = _inputs(b, h, kvh, n, m, d, r, bias, shared,
                                      sqdist)
    kw = dict(scale=d ** -0.5, mask_kind=mask, window=window)
    o, lse = flashbias_attention_fwd(q, k, v, pq, pk, sl, return_lse=True,
                                     **kw)
    assert torch.equal(o, flashbias_attention_fwd(q, k, v, pq, pk, sl, **kw))
    needs = (True, True, True, bias == "phi", bias == "phi")
    got = flashbias_attention_bwd(q, k, v, do, lse, pq, pk, sl, needs=needs,
                                  **kw)
    again = flashbias_attention_bwd(q, k, v, do, lse, pq, pk, sl, needs=needs,
                                    **kw)
    if blocked:
        want = ops._recompute_grads(
            (q, k, v, pq, pk, sl), needs + (False,), kw, do,
            ops.backward_block_rows(b, h, n, m))[:5]
        return got, again, want, (q, k, v, do, lse, pq, pk, kw)
    _, want_lse = flashbias_attention_torch(q, k, v, pq, pk, sl,
                                            return_lse=True, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    fin = torch.isfinite(want_lse)
    assert float((lse - want_lse)[fin].abs().max()) <= 2e-4
    want = flashbias_attention_bwd_torch(q, k, v, do, lse, pq, pk, sl,
                                         needs=needs, **kw)
    return got, again, want, None


def _errors(got, want) -> dict:
    """Each gradient's max error over its scale."""
    out = {}
    for name, a, w in zip(NAMES, got, want):
        if a is not None and w is not None:
            out[name] = float((a.float() - w.float()).abs().max()) \
                / float(w.float().abs().max())
    return out


def _check(got, again, want):
    for name, a, a2, w in zip(NAMES, got, again, want):
        assert (a is None) == (w is None), name
        if w is None:
            continue
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.equal(a, a2), f"{name}: two calls differ"
    err = _errors(got, want)
    print("errors over scale", {k: f"{e:.3e}" for k, e in err.items()})
    for name, e in err.items():
        assert e <= TOL[name], (name, e, TOL[name])
    return err


def _one_bf16_pass_dphi(q, k, v, do, lse, pq, pk, kw, rows=2048):
    """dphi_q and dphi_k as one bf16 pass gives them: the float32 dS of the
    plain backward (P from lse, no mask, no GQA) and the factors each
    rounded to bf16 once before their product, float32 sums; the kernel
    splits both into hi + lo instead."""
    n = q.shape[2]
    kf, vf = k.float(), v.float()
    pq16, pk16 = pq.bfloat16().float(), pk.bfloat16().float()
    dpq, dpk = [], torch.zeros(pk.shape, device=q.device)
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        s = q[:, :, lo:hi].float() @ kf.transpose(-1, -2) * kw["scale"] \
            + pq[:, :, lo:hi] @ pk.transpose(-1, -2)
        p = torch.exp(s - lse[:, :, lo:hi, None])
        dp = do[:, :, lo:hi].float() @ vf.transpose(-1, -2)
        ds = (p * (dp - (p * dp).sum(-1, keepdim=True))).bfloat16().float()
        del s, p, dp
        dpq.append(ds @ pk16)
        dpk += ds.transpose(-1, -2) @ pq16[:, :, lo:hi]
    return torch.cat(dpq, dim=2), dpk


@pytest.mark.parametrize("shape", ["pde", "pde_model_factors", "gpt2",
                                   "pairformer"])
def test_kernel_at_the_training_shapes(cuda, shape):
    args = {"pde": ((1, 8, 8, 32186, 32186, 16, 9, "none", "phi"),
                    dict(shared=True, blocked=True)),
            "pde_model_factors": ((1, 8, 8, 32186, 32186, 16, 9, "none",
                                   "phi"), dict(sqdist=True, blocked=True)),
            "gpt2": ((2, 64, 64, 1024, 1024, 32, 0, "causal", "alibi"), {}),
            "pairformer": ((1, 4, 4, 384, 384, 96, 96, "none", "phi"), {})}
    a, kw = args[shape]
    got, again, want, saved = _run(*a, **kw)
    _check(got, again, want)
    if shape == "pde_model_factors":
        one = _one_bf16_pass_dphi(*saved)
        err = _errors((None, None, None) + one, want)
        print("one bf16 pass, errors over scale",
              {k: f"{e:.3e}" for k, e in err.items()})
        assert min(err.values()) > TOL_PHI, err


@pytest.mark.parametrize("mask", ["none", "causal", "local"])
@pytest.mark.parametrize("bias", ["none", "phi", "alibi"])
def test_kernel_at_every_mode(cuda, mask, bias):
    """GQA (4 heads over 2), 300 rows (a partial 128-row block and a
    partial streamed tile), window 37."""
    _check(*_run(2, 4, 2, 300, 300, 16, 9, mask, bias,
                 window=37 if mask == "local" else 0)[:3])


@pytest.mark.parametrize("d,r,bias", [(32, 0, "alibi"), (64, 4, "phi"),
                                      (96, 96, "phi"), (128, 0, "none"),
                                      (24, 40, "phi")])
def test_kernel_at_each_width(cuda, d, r, bias):
    """Each width the kernel is built for (D, R padded to 16, 32, 64, 96 or
    128), more queries than keys, causal (rows past the keys see a
    prefix)."""
    _check(*_run(1, 4, 1, 257, 190, d, r, "causal", bias)[:3])


def test_pde_training_step_launches_the_kernel_per_layer(cuda, monkeypatch):
    cfg = get_config("pde_solver")
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = init_params(cfg, gen, device="cuda")
    batch = {"coords": torch.rand((1, 8192, 3), generator=gen, device="cuda"),
             "targets": torch.randn((1, 8192, 4), generator=gen,
                                    device="cuda")}

    def refused(*args, **kw):
        raise AssertionError("the plain recompute ran")
    monkeypatch.setattr(ops, "_recompute_grads", refused)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    before = flashbias_attention_bwd.launches
    get_model(cfg).loss(params, batch).backward()
    torch.cuda.synchronize()
    assert flashbias_attention_bwd.launches - before == cfg.n_layers

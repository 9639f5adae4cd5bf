"""The port's dense LM against the JAX reference, on the CPU, float32.

The reference's parameters (``init_params`` from a fixed key) are carried
across with ``repro_torch.interop.params_from_numpy``; prompts and tokens
come from numpy. Prefill logits and caches must match the reference's at
1e-5 with ragged lengths, then six decode steps at 1e-4 with one slot
frozen at length 0 (whose cache must stay bit-identical). The reference
runs its XLA path (``attn_impl="xla"``); the port runs its plain path, which
is what its kernel wrappers run on CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke
from repro.kernels import ops as jops
from repro.models import get_model as jget_model
from repro.models import lm as jlm
from repro.models.common import init_params as jinit
from repro.models.common import is_pdef
from repro_torch.configs import get_config, smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flashbias_attn import flashbias_attention_torch
from repro_torch.models import get_model, init_params
from repro_torch.models.lm import cast_layers

ARCHS = ["gpt2_alibi_15b", "stablelm_12b"]
B, S, MAX_LEN = 3, 13, 24
LENGTHS = np.array([13, 5, 9], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _carried(arch):
    jcfg = jsmoke(arch).replace(attn_impl="xla")
    jparams = jinit(jget_model(jcfg).template(), jax.random.PRNGKey(0))
    cfg = smoke_config(arch)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    return jcfg, jparams, cfg, tparams


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_reference(arch):
    jcfg, jparams, cfg, tparams = _carried(arch)
    model = get_model(cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jl, jc = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                         max_len=MAX_LEN, lengths=jnp.asarray(LENGTHS))
    with torch.no_grad():
        tl, tc = model.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                               max_len=MAX_LEN,
                               lengths=torch.from_numpy(LENGTHS))
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=1e-5, atol=1e-5)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), _np(jc[key]), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(tc["length"].numpy(), LENGTHS)

    # freeze slot 1 (an idle lane): no writes, no length advance
    jc = {**jc, "length": jc["length"].at[1].set(0)}
    tc["length"][1] = 0
    frozen = tc["k"][:, 1].clone()
    active = np.array([True, False, True])
    for _ in range(6):
        nt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = jlm.decode_step(jparams, jc, jnp.asarray(nt), jcfg)
        with torch.no_grad():
            tl, tc = model.decode(tparams, tc, torch.from_numpy(nt))
        np.testing.assert_allclose(tl.numpy()[active], _np(jl)[active],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tc["length"].numpy(),
                                      np.asarray(jc["length"]))
        assert torch.isfinite(tl).all()
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy()[:, active],
                                   _np(jc[key])[:, active], rtol=1e-5,
                                   atol=1e-5)
    assert torch.equal(tc["k"][:, 1], frozen)


@pytest.mark.parametrize("arch", ARCHS)
def test_template_matches_reference_at_full_width(arch):
    """Same nested keys and stacked shapes as the reference template, for
    the full published config (shapes only, nothing is allocated)."""
    jt = jget_model(jget_config(arch)).template()
    want = jax.tree.map(lambda p: p.shape, jt, is_leaf=is_pdef)
    tt = get_model(get_config(arch)).template()

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tree.shape
    assert shapes(tt) == want


def test_init_params_laws():
    cfg = smoke_config("gpt2_alibi_15b").replace(tp=8)    # 4 heads pad to 8
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device="cpu")
    slopes = params["layers"]["attn"]["slopes"]
    assert slopes.shape == (cfg.n_layers, 8)
    np.testing.assert_allclose(slopes[0, :4].numpy(),
                               [0.25, 0.0625, 0.015625, 0.00390625],
                               rtol=1e-6)
    assert not slopes[:, 4:].any()                         # TP-pad heads
    assert not params["final_norm"].any()
    assert abs(float(params["embed"].std()) - 0.02) < 2e-3
    again = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["embed"], params["embed"])


def test_params_from_numpy_rejects_mismatches():
    cfg = smoke_config("gpt2_alibi_15b")
    tree = jax.tree.map(np.asarray, jinit(
        jget_model(jsmoke("gpt2_alibi_15b")).template(),
        jax.random.PRNGKey(1)))
    bad_shape = {**tree, "final_norm": np.zeros((3,), np.float32)}
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(bad_shape, cfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy({k: v for k, v in tree.items() if k != "embed"},
                          cfg, device="cpu")


def test_bf16_compute_casts_layers_once():
    cfg = smoke_config("gpt2_alibi_15b").replace(dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cast = cast_layers(params, cfg)
    assert cast["layers"]["mlp"]["wi"].dtype == torch.bfloat16
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["final_norm"].dtype == torch.float32       # kept as is
    toks = torch.randint(0, cfg.vocab, (2, 7), generator=torch.Generator())
    with torch.no_grad():
        a, _ = get_model(cfg).prefill(params, {"tokens": toks})
        b, _ = get_model(cfg).prefill(cast, {"tokens": toks})
    assert a.dtype == torch.bfloat16
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("bias", ["alibi", "phi"])
@pytest.mark.parametrize("mask", ["causal", "local"])
def test_attention_function_backward(bias, mask):
    """The autograd Function's backward (recompute through the plain path)
    matches differentiating the plain path directly, and the reference's
    gradients through its own custom VJP."""
    rng = np.random.default_rng(3)
    b, n, h, kvh, d, r = 2, 19, 4, 2, 8, 3
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            [(b, n, h, d), (b, n, kvh, d), (b, n, kvh, d), (b, n, h, r),
             (b, n, kvh, r), (b, n, h, d)]]
    q, k, v, pq, pk, w = arrs
    slopes = np.linspace(0.5, 0.05, h).astype(np.float32)
    kw = dict(mask_kind=mask, window=7)

    def torch_grads(fn):
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v, pq, pk)]
        extra = ({"phi_q": ts[3], "phi_k": ts[4]} if bias == "phi"
                 else {"slopes": torch.tensor(slopes)})
        out = fn(*ts[:3], **extra)
        (out * torch.tensor(w)).sum().backward()
        return [t.grad for t in (ts if bias == "phi" else ts[:3])]

    via_fn = torch_grads(lambda *a, **e: tops.flash_attention(
        *a, **e, **kw, impl="cuda"))

    def plain(q_, k_, v_, **e):
        if "phi_k" in e:
            e = {**e, "phi_q": e["phi_q"].transpose(1, 2),
                 "phi_k": e["phi_k"].transpose(1, 2).repeat_interleave(
                     h // kvh, dim=1)}
        o = flashbias_attention_torch(
            q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
            scale=d ** -0.5, **e, **kw)
        return o.transpose(1, 2)
    direct = torch_grads(plain)
    for got, want in zip(via_fn, direct):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)

    def jax_loss(*xs):
        extra = ({"phi_q": xs[3], "phi_k": xs[4]} if bias == "phi"
                 else {"slopes": jnp.asarray(slopes)})
        o = jops.flash_attention(*xs[:3], **extra, **kw, impl="xla")
        return jnp.sum(o * w)
    argnums = (0, 1, 2, 3, 4) if bias == "phi" else (0, 1, 2)
    want = jax.grad(jax_loss, argnums=argnums)(q, k, v, pq, pk)
    for got, ref in zip(via_fn, want):
        np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-4,
                                   atol=1e-4)

"""The Pairformer's training path in the port (``forward``,
``denoise_loss``, ``fit_factor_mlps``, ``Model.loss``) against the JAX
package's, on the CPU.

``pairformer_lite`` SMOKE (float32, 2 layers): the reference's parameters
and factor MLPs (``init_params`` from fixed keys; the MLPs scaled by 5 so
that their bias is not near zero) carried across with
``params_from_numpy`` / ``factors_from_numpy``, inputs from numpy with a
seed. The reference's ``forward`` cannot run at bfloat16 (its layer scan
rejects the carry whose ``z`` turns float32), so parity is at float32; a
bf16 case checks that the port's path runs and keeps the reference's
dtypes.

Tolerances: outputs and losses at rtol 1e-5 (summation order only); each
gradient leaf within ``1e-4 * max|g_ref| + 1e-6``; 10 Adam steps of
``fit_factor_mlps``: each step's loss at rtol 1e-4 and the fitted leaves
within 1e-4 of each leaf's scale (Adam's division by ``sqrt(n_hat)``
amplifies float32 roundings of near-zero gradients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import get_model as jget_model
from repro.models import pairformer as jpf
from repro.models.common import init_params as jinit
from repro.models.common import stack_layers as jstack
from repro_torch.configs import smoke_config
from repro_torch.interop import factors_from_numpy, params_from_numpy
from repro_torch.kernels import flashbias_attn, ops
from repro_torch.models import get_model
from repro_torch.models import pairformer as tpf
from repro_torch.models.common import tree_map

HIDDEN = 16
N_RES = 12


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def carried():
    """(ref cfg, port cfg, ref params, port params, ref factors, port
    factors) at SMOKE, flashbias mode."""
    jcfg = jsmoke("pairformer_lite").replace(attn_impl="xla")
    cfg = smoke_config("pairformer_lite")
    jp = jinit(jget_model(jcfg).template(), jax.random.PRNGKey(0))
    jf = jinit(jstack(jpf.factor_mlp_template(jcfg, hidden=HIDDEN),
                      jcfg.n_layers), jax.random.PRNGKey(2))
    jf = jax.tree.map(lambda x: 5.0 * x, jf)
    return (jcfg, cfg, jp, params_from_numpy(_np(jp), cfg, device="cpu"),
            jf, factors_from_numpy(_np(jf), cfg, HIDDEN, device="cpu"))


def _batch(seed=1, b=2, n=N_RES):
    rng = np.random.default_rng(seed)
    return {"feats": rng.standard_normal((b, n, 64)).astype(np.float32),
            "coords": rng.standard_normal((b, n, 3)).astype(np.float32)}


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_named(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _grads_close(got: dict, want: dict):
    got, want = _named(got), _named(_np(want))
    assert set(got) == set(want)
    for name, g in want.items():
        err = float(np.abs(got[name].numpy() - g).max())
        assert err <= 1e-4 * float(np.abs(g).max()) + 1e-6, (name, err)


def _leaves(tree):
    return tree_map(lambda p: p.detach().clone().requires_grad_(True), tree)


def _grad(t):
    """``t.grad``, zeros where the loss does not reach ``t`` (the pair-bias
    projection in flashbias mode with factor MLPs), as JAX reports it."""
    return torch.zeros_like(t) if t.grad is None else t.grad


@pytest.mark.parametrize("mode", ["dense", "flashbias", "flashbias-no-mlp",
                                  "dense_recompute"])
def test_forward_matches_reference(carried, mode):
    """Both bias modes; flashbias without factor MLPs (and the serve-only
    ``dense_recompute``) take the dense bias, as in the reference."""
    jcfg, cfg, jp, tp, jf, tf = carried
    bias_mode = mode.split("-")[0]
    use = mode == "flashbias"
    jcfg, cfg = (c.replace(bias_mode=bias_mode) for c in (jcfg, cfg))
    feats = _batch()["feats"]
    want = jpf.forward(jp, jnp.asarray(feats), jcfg, jf if use else None)
    got = tpf.forward(tp, torch.from_numpy(feats), cfg, tf if use else None)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, N_RES, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["dense", "flashbias"])
def test_denoise_loss_and_grads_match_reference(carried, mode):
    """The loss and the gradients of every trunk leaf and, in flashbias
    mode, of every factor-MLP leaf, against ``jax.value_and_grad``."""
    jcfg, cfg, jp, tp, jf, tf = carried
    jcfg, cfg = (c.replace(bias_mode=mode) for c in (jcfg, cfg))
    batch = _batch(seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    fb = mode == "flashbias"
    (jloss, (jgp, jgf)) = jax.value_and_grad(
        lambda p, f: jpf.denoise_loss(p, jb, jcfg, f if fb else None),
        argnums=(0, 1))(jp, jf)
    p, f = _leaves(tp), _leaves(tf)
    loss = tpf.denoise_loss(p, tb, cfg, f if fb else None)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _grads_close(tree_map(_grad, p), jgp)
    if fb:
        _grads_close(tree_map(_grad, f), jgf)
        assert all(float(g.abs().max()) > 0 for g in
                   _named(tree_map(lambda t: t.grad, f)).values())
    else:
        assert all(t.grad is None for t in _named(f).values())


def test_flashbias_mode_calls_kernel_1_once_per_layer(carried, monkeypatch):
    """With factor MLPs and ``attn_impl="cuda"`` each layer's attention
    goes through kernel 1's wrapper (on a CPU tensor its plain version),
    non-ragged, the factors float32; the backward recomputes through the
    plain path and launches nothing more. Without MLPs it is never called."""
    _, cfg, _, tp, _, tf = carried
    cfg = cfg.replace(attn_impl="cuda")
    calls = []
    orig = flashbias_attn.flashbias_attention_fwd

    def counted(q, k, v, phi_q=None, phi_k=None, slopes=None, **kw):
        calls.append((phi_q.dtype, phi_k.dtype, tuple(phi_q.shape)))
        return orig(q, k, v, phi_q, phi_k, slopes, **kw)
    monkeypatch.setattr(ops, "flashbias_attention_fwd", counted)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    p, f = _leaves(tp), _leaves(tf)
    tpf.denoise_loss(p, batch, cfg, f).backward()
    assert calls == [(torch.float32, torch.float32,
                      (2, cfg.n_heads, N_RES, cfg.bias_rank))] * cfg.n_layers
    calls.clear()
    tpf.denoise_loss(tp, batch, cfg)
    assert calls == []


def test_fit_factor_mlps_matches_reference(carried):
    """10 steps of Eq. 5 with the trunk frozen: every step's loss and the
    fitted factor MLPs; the trunk's parameters untouched."""
    jcfg, cfg, jp, tp, jf, tf = carried
    feats = _batch(seed=5)["feats"]
    jfit, jlosses = jpf.fit_factor_mlps(jax.random.PRNGKey(3), jp, jf,
                                        jnp.asarray(feats), jcfg, steps=10,
                                        lr=3e-3)
    before = _named(tree_map(torch.clone, tp))
    tfit, tlosses = tpf.fit_factor_mlps(tp, tf, torch.from_numpy(feats), cfg,
                                        steps=10, lr=3e-3)
    assert len(tlosses) == 10 and all(isinstance(x, float) for x in tlosses)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
    got, want = _named(tfit), _named(_np(jfit))
    assert set(got) == set(want)
    for name, w in want.items():
        err = float(np.abs(got[name].numpy() - w).max())
        assert err <= 1e-4 * max(1.0, float(np.abs(w).max())), (name, err)
    for name, t in _named(tp).items():
        assert torch.equal(t, before[name]), name


def test_model_loss_is_denoise_loss(carried):
    """``get_model(cfg).loss`` of the Pairformer is the reference's
    ``Model.loss``: ``denoise_loss`` without factor MLPs."""
    jcfg, cfg, jp, tp, _, _ = carried
    batch = _batch(seed=7)
    want = jget_model(jcfg).loss(jp, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    got = get_model(cfg).loss(tp, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_bf16_training_path_runs_in_the_reference_dtypes(carried):
    """At bf16 compute (the card's config) with float32 masters: the
    coordinates come out bf16, the loss and every gradient are finite and
    the gradients keep the masters' float32; the Eq. 5 fit runs, its loss
    falling. The loss stays within 5% of the float32 loss."""
    _, cfg, _, tp, _, tf = carried
    bf = cfg.replace(dtype="bfloat16")
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=9).items()}
    assert tpf.forward(tp, batch["feats"], bf, tf).dtype == torch.bfloat16
    p, f = _leaves(tp), _leaves(tf)
    loss = tpf.denoise_loss(p, batch, bf, f)
    loss.backward()
    ref = tpf.denoise_loss(tp, batch, cfg, tf)
    assert abs(float(loss.detach()) - float(ref)) <= 0.05 * float(ref)
    for name, t in list(_named(p).items()) + list(_named(f).items()):
        if t.grad is None:            # the projection factors replace
            assert "pair_bias" in name, name
            continue
        assert t.grad.dtype == torch.float32, name
        assert bool(torch.isfinite(t.grad).all()), name
    _, losses = tpf.fit_factor_mlps(tp, tf, batch["feats"], bf, steps=3,
                                    lr=3e-3)
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]

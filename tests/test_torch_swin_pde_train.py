"""The backward of the paper's vision (SwinV2) and PDE models in the port
against the JAX package's, on the CPU.

``swinv2_b`` and ``pde_solver`` SMOKE (float32): the reference's
parameters carried across with ``params_from_numpy``, inputs from numpy
with a seed. The gradients of ``classify_loss`` / ``regression_loss`` are
held against ``jax.value_and_grad`` of the reference's (``attn_impl``
"xla", whose backward is the XLA VJP):

- Swin with the dense tables (how the reference trains) and in flashbias
  mode with the reference's SVD factors carried across (kernel 1's path;
  the factors broadcast over the windows, their gradients summed back);
- the PDE in flashbias mode (kernel 1's path; the gradient reaches
  ``alpha_w`` / ``alpha_b`` through ``phi_q``) and in dense mode, with
  ``attn_impl`` "cuda" too, where a counting stand-in for kernel 1's
  wrapper (on a CPU tensor its plain version) sees one call per layer;
- the PDE's flashbias gradients equal its dense gradients (Table 5's
  claim, the reference's ``tests/test_system.py`` bound of 5e-4), also
  with the backward recomputed in forced small query blocks.

Tolerance: the loss at rtol 1e-5; each gradient leaf within ``1e-4 *
max|g_ref| + 1e-6`` (float32 sums in other orders through 2 layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import get_model as jget_model
from repro.models import pde as jpde
from repro.models import swin as jswin
from repro.models.common import init_params as jinit
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import pde, swin
from repro_torch.models.common import tree_map

N_WIN, N_PTS = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _carried(arch, **replace):
    jcfg = jsmoke(arch).replace(attn_impl="xla", **replace)
    jparams = jinit(jget_model(jcfg).template(), jax.random.PRNGKey(0))
    cfg = smoke_config(arch).replace(**replace)
    return jcfg, jparams, cfg, params_from_numpy(_np(jparams), cfg,
                                                 device="cpu")


def _batch(arch, cfg, seed=0):
    rng = np.random.default_rng(seed)
    if arch == "swinv2_b":
        return {"patches": rng.standard_normal(
                    (2, N_WIN, cfg.window, 48)).astype(np.float32),
                "labels": rng.integers(0, 1000, (2,)).astype(np.int32)}
    return {"coords": rng.uniform(0, 1, (2, N_PTS, cfg.coord_dim)).astype(
                np.float32),
            "targets": rng.standard_normal((2, N_PTS, 4)).astype(np.float32)}


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_named(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _leaves(tree):
    return tree_map(lambda p: p.detach().clone().requires_grad_(True), tree)


def _grad(t):
    """``t.grad``, zeros where the loss does not reach ``t`` (Swin's tables
    in flashbias mode), as JAX reports it."""
    return torch.zeros_like(t) if t.grad is None else t.grad


def _grads_close(got: dict, want: dict, tol=1e-4):
    got, want = _named(tree_map(_grad, got)), _named(_np(want))
    assert set(got) == set(want)
    for name, g in want.items():
        err = float(np.abs(got[name].numpy() - g).max())
        assert err <= tol * float(np.abs(g).max()) + 1e-6, (name, err)


def _port_loss(arch, params, batch, cfg, factors=None):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if arch == "swinv2_b":
        return swin.classify_loss(params, tb, cfg, factors)
    return pde.regression_loss(params, tb, cfg)


@pytest.mark.parametrize("mode", ["dense", "flashbias"])
def test_swin_grads_match_reference(mode):
    """Dense tables, and flashbias with the reference's SVD factors: the
    gradients of every parameter and, in flashbias mode, of the factors."""
    jcfg, jp, cfg, tp = _carried("swinv2_b", bias_mode=mode)
    batch = _batch("swinv2_b", cfg, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fb = mode == "flashbias"
    jf = jswin.svd_factorize(jp, cfg.bias_rank) if fb else None
    jloss, jg = jax.value_and_grad(
        lambda p, f: jswin.classify_loss(p, jb, jcfg, f),
        argnums=(0, 1) if fb else 0)(jp, jf)
    p = _leaves(tp)
    f = _leaves({k: torch.from_numpy(np.array(v)) for k, v in jf.items()}) \
        if fb else None
    loss = _port_loss("swinv2_b", p, batch, cfg, f)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    if fb:
        _grads_close(p, jg[0])
        _grads_close(f, jg[1])
        assert p["layers"]["bias_table"].grad is None
    else:
        _grads_close(p, jg)
        assert float(p["layers"]["bias_table"].grad.abs().max()) > 0


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("mode", ["dense", "flashbias"])
def test_pde_grads_match_reference(mode, impl, monkeypatch):
    jcfg, jp, cfg, tp = _carried("pde_solver", bias_mode=mode)
    cfg = cfg.replace(attn_impl=impl)
    calls = []
    orig = ops.flashbias_attention_fwd

    def counted(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)
    monkeypatch.setattr(ops, "flashbias_attention_fwd", counted)
    batch = _batch("pde_solver", cfg, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jg = jax.value_and_grad(
        lambda p: jpde.regression_loss(p, jb, jcfg))(jp)
    p = _leaves(tp)
    loss = _port_loss("pde_solver", p, batch, cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    _grads_close(p, jg)
    for leaf in ("alpha_w", "alpha_b"):
        assert float(p["layers"][leaf].grad.abs().max()) > 0, leaf
    want = cfg.n_layers if (mode, impl) == ("flashbias", "cuda") else 0
    assert len(calls) == want


@pytest.mark.parametrize("rows", [None, 5])
def test_pde_flashbias_grads_equal_dense_grads(rows, monkeypatch):
    """Table 5's claim on the port: the exact rank-9 factors train as the
    dense bias does, the backward recomputed whole or in 5-row blocks."""
    _, _, cfg, tp = _carried("pde_solver")
    batch = _batch("pde_solver", cfg, seed=3)
    if rows is not None:
        monkeypatch.setattr(ops, "BWD_SCORE_BYTES",
                            2 * cfg.n_heads * N_PTS * 4 * rows)
    grads = {}
    for mode in ("flashbias", "dense"):
        p = _leaves(tp)
        _port_loss("pde_solver", p, batch,
                   cfg.replace(bias_mode=mode)).backward()
        grads[mode] = _named(tree_map(_grad, p))
    for name, g in grads["dense"].items():
        err = float((grads["flashbias"][name] - g).abs().max())
        assert err <= 5e-4, (name, err)

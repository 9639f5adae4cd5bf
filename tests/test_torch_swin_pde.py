"""The paper's vision (SwinV2 window attention) and PDE models, and the LM's
dense-bias baseline, in the port against the JAX package, on the CPU.

``swinv2_b`` and ``pde_solver`` SMOKE (float32): the reference's parameters
(``init_params`` from a fixed key) carried across with
``params_from_numpy``, inputs from numpy with a seed. Each forward and loss
value is held against the JAX function in flashbias mode (the reference's
``attn_impl`` "xla" and "pallas_interpret"; the port's plain path, which is
what kernel 1's wrapper runs on CPU tensors) and in dense mode. Swin's SVD
factors are compared as products (``phi_q @ phi_k^T``: SVD signs are not
unique), and carried across as a dict of numpy arrays. On tables of exact
rank R, and always for the PDE's exact factors, flashbias equals dense.
The LM's ``bias_mode="dense"`` prefill is held against the reference's,
and engine greedy streams against the JAX engine's in that mode.

Tolerance: max abs error <= 1e-4 x max(1, max |ref|) (float32; the paths
differ in summation order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke
from repro.models import get_model as jget_model
from repro.models import lm as jlm
from repro.models import pde as jpde
from repro.models import swin as jswin
from repro.models.common import init_params as jinit
from repro.models.common import is_pdef
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import get_model, pde, swin
from repro_torch.serve import OK, ServeEngine

RTOL = 1e-4
ARCHS = ["swinv2_b", "pde_solver"]
N_WIN, N_PTS = 2, 24           # swin windows per image, pde points


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= RTOL * max(1.0, float(np.abs(want).max())), err


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _carried(arch, **replace):
    jcfg = jsmoke(arch).replace(**replace)
    jparams = jinit(jget_model(jcfg).template(), jax.random.PRNGKey(0))
    cfg = smoke_config(arch).replace(**replace)
    return jcfg, jparams, cfg, params_from_numpy(_np_tree(jparams), cfg,
                                                 device="cpu")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tree.shape


def _inputs(arch, cfg, seed=0):
    """(numpy batch for the loss, the forward's input array)."""
    rng = np.random.default_rng(seed)
    if arch == "swinv2_b":
        patches = rng.standard_normal((2, N_WIN, cfg.window, 48)).astype(
            np.float32)
        labels = rng.integers(0, 1000, (2,)).astype(np.int32)
        return {"patches": patches, "labels": labels}, patches
    coords = rng.uniform(0, 1, (2, N_PTS, cfg.coord_dim)).astype(np.float32)
    targets = rng.standard_normal((2, N_PTS, 4)).astype(np.float32)
    return {"coords": coords, "targets": targets}, coords


def _exact_rank_tables(params, cfg, seed=1):
    """The swin tables replaced by exact rank-R products of seeded factors
    (numpy, float32), scaled to the init law's 0.5 standard deviation."""
    rng = np.random.default_rng(seed)
    r = cfg.bias_rank
    shape = np.asarray(params["layers"]["bias_table"]).shape[:-1] + (r,)
    a, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    tables = (a @ np.swapaxes(b, -1, -2)) * np.float32(0.5 / np.sqrt(r))
    out = _np_tree(params)
    out["layers"]["bias_table"] = tables
    return out


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_template_matches_reference(arch, smoke):
    """Same nested keys and stacked shapes as the reference's template, at
    the published config (shapes only) and at SMOKE; init laws alike."""
    jcfg = jsmoke(arch) if smoke else jget_config(arch)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    jt = jget_model(jcfg).template()
    tt = get_model(cfg).template()
    assert _shapes(tt) == jax.tree.map(lambda p: p.shape, jt,
                                       is_leaf=is_pdef)
    laws = jax.tree.map(lambda p: p.init, jt, is_leaf=is_pdef)

    def port_laws(tree):
        if isinstance(tree, dict):
            return {k: port_laws(v) for k, v in tree.items()}
        return tree.init
    assert port_laws(tt) == laws


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_over(arch):
    """``params_from_numpy`` goes through the port's template: every leaf
    arrives equal, and a tree with a missing or misshapen leaf raises."""
    jcfg, jparams, cfg, tparams = _carried(arch)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in flat_j:
        node = tparams
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    bad = _np_tree(jparams)
    bad["layers"]["wo"] = bad["layers"]["wo"][..., :-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(bad, cfg, device="cpu")
    del bad["layers"]["wo"]
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(bad, cfg, device="cpu")


def test_swin_svd_factors_match_reference_and_carry_across():
    """The port's ``svd_factorize`` reconstructs each table as the
    reference's does (products compared); the reference's factors carry
    across as a dict of numpy arrays and give the same forward."""
    jcfg, jparams, cfg, tparams = _carried("swinv2_b")
    jf = jswin.svd_factorize(jparams, cfg.bias_rank)
    tf = swin.svd_factorize(tparams, cfg.bias_rank)
    assert tuple(tf["phi_q"].shape) == jf["phi_q"].shape == (
        cfg.n_layers, cfg.n_heads, cfg.window, cfg.bias_rank)
    _close(tf["phi_q"] @ tf["phi_k"].transpose(-1, -2),
           jf["phi_q"] @ jnp.swapaxes(jf["phi_k"], -1, -2))
    carried = {k: torch.from_numpy(np.array(v)) for k, v in jf.items()}
    _, x = _inputs("swinv2_b", cfg)
    with torch.no_grad():
        own = swin.forward(tparams, torch.from_numpy(x), cfg, tf)
        theirs = swin.forward(tparams, torch.from_numpy(x), cfg, carried)
    _close(own, theirs)


# (mode, reference attn_impl): flashbias through the reference's XLA path
# and its Pallas kernel in interpret mode, and the dense baseline
MODES = [("flashbias", "xla"), ("flashbias", "pallas_interpret"),
         ("dense", "xla")]


@pytest.mark.parametrize("mode,jimpl", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, mode, jimpl):
    jcfg, jparams, cfg, tparams = _carried(arch, bias_mode=mode)
    jcfg = jcfg.replace(attn_impl=jimpl)
    batch, x = _inputs(arch, cfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = get_model(cfg)
    with torch.no_grad():
        if arch == "swinv2_b":
            jf = jswin.svd_factorize(jparams, cfg.bias_rank)
            tf = {k: torch.from_numpy(np.array(v)) for k, v in jf.items()}
            got = swin.forward(tparams, tbatch["patches"], cfg, tf)
            want = jswin.forward(jparams, jbatch["patches"], jcfg, jf)
            got_loss = swin.classify_loss(tparams, tbatch, cfg, tf)
            want_loss = jswin.classify_loss(jparams, jbatch, jcfg, jf)
        else:
            got = pde.forward(tparams, tbatch["coords"], cfg)
            want = jpde.forward(jparams, jbatch["coords"], jcfg)
            got_loss = model.loss(tparams, tbatch)
            want_loss = jget_model(jcfg).loss(jparams, jbatch)
    assert torch.isfinite(got).all()
    _close(got, want)
    _close(got_loss, want_loss)
    if arch == "swinv2_b" and mode == "dense":
        # the Model's loss is the factor-free one (the dense table)
        with torch.no_grad():
            _close(model.loss(tparams, tbatch),
                   jget_model(jcfg).loss(jparams, jbatch))


@pytest.mark.parametrize("arch", ARCHS)
def test_flashbias_equals_dense_where_the_factors_are_exact(arch):
    """Swin on tables of exact rank R, with the port's own SVD factors, and
    the PDE with its exact rank-9 factors: the flashbias forward equals the
    dense-bias forward."""
    _, jparams, cfg, _ = _carried(arch)
    tree = (_exact_rank_tables(jparams, cfg) if arch == "swinv2_b"
            else _np_tree(jparams))
    params = params_from_numpy(tree, cfg, device="cpu")
    _, x = _inputs(arch, cfg, seed=2)
    x = torch.from_numpy(x)
    with torch.no_grad():
        if arch == "swinv2_b":
            factors = swin.svd_factorize(params, cfg.bias_rank)
            flash = swin.forward(params, x, cfg, factors)
            dense = swin.forward(params, x, cfg.replace(bias_mode="dense"))
        else:
            flash = pde.forward(params, x, cfg)
            dense = pde.forward(params, x, cfg.replace(bias_mode="dense"))
    _close(flash, dense.numpy())


def test_swin_flashbias_truncation_shows_on_full_rank_tables():
    """Control for the test above: on the init law's full-rank tables the
    rank-R factors truncate, and the forwards differ by more than the
    tolerance (so that test can tell an exact factorization from none)."""
    _, _, cfg, params = _carried("swinv2_b")
    _, x = _inputs("swinv2_b", cfg, seed=2)
    x = torch.from_numpy(x)
    with torch.no_grad():
        flash = swin.forward(params, x, cfg,
                             swin.svd_factorize(params, cfg.bias_rank))
        dense = swin.forward(params, x, cfg.replace(bias_mode="dense"))
    err = float((flash - dense).abs().max())
    assert err > RTOL * max(1.0, float(dense.abs().max())), err


LM_ARCHS = ["gpt2_alibi_15b", "stablelm_12b"]
B, S, MAX_LEN = 3, 13, 24
LENGTHS = np.array([13, 5, 9], np.int32)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_dense_baseline_prefill_matches_reference(arch):
    """``bias_mode="dense"`` prefill (the materialized ALiBi bias, plain
    chunked attention): logits and caches against the reference's in that
    mode, ragged; then decode steps (slopes, as in the reference) and the
    flashbias prefill, which the exact rank-2 factorization makes equal."""
    jcfg, jparams, cfg, tparams = _carried(arch, bias_mode="dense")
    jcfg = jcfg.replace(attn_impl="xla")
    model = get_model(cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jl, jc = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                         max_len=MAX_LEN, lengths=jnp.asarray(LENGTHS))
    with torch.no_grad():
        tl, tc = model.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                               max_len=MAX_LEN,
                               lengths=torch.from_numpy(LENGTHS))
        fl, _ = get_model(cfg.replace(bias_mode="flashbias")).prefill(
            tparams, {"tokens": torch.from_numpy(toks)}, max_len=MAX_LEN,
            lengths=torch.from_numpy(LENGTHS))
    _close(tl, jl)
    _close(fl, jl)
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    for _ in range(3):
        nt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = jlm.decode_step(jparams, jc, jnp.asarray(nt), jcfg)
        with torch.no_grad():
            tl, tc = model.decode(tparams, tc, torch.from_numpy(nt))
        _close(tl, jl)


def test_lm_dense_baseline_ignores_the_slopes_leaf():
    """As in the reference, the dense baseline's bias comes from the
    published slopes of the real heads, not the layer's ``slopes`` leaf:
    a changed leaf moves the flashbias prefill but not the dense one."""
    jcfg, jparams, cfg, _ = _carried("gpt2_alibi_15b", bias_mode="dense")
    tree = _np_tree(jparams)
    tree["layers"]["attn"]["slopes"] = tree["layers"]["attn"]["slopes"] * 2
    tparams = params_from_numpy(tree, cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 9))
    batch = {"tokens": torch.from_numpy(toks)}
    jl, _ = jlm.prefill(jax.tree.map(jnp.asarray, tree),
                        {"tokens": jnp.asarray(toks)},
                        jcfg.replace(attn_impl="xla"))
    with torch.no_grad():
        dense, _ = get_model(cfg).prefill(tparams, batch)
        flash, _ = get_model(cfg.replace(bias_mode="flashbias")).prefill(
            tparams, batch)
    _close(dense, jl)
    assert float((flash - dense).abs().max()) > 1e-3


def _prompts(vocab, lens, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def _staggered(eng, prompts, budgets):
    rids = [eng.submit(p, b) for p, b in zip(prompts[:2], budgets[:2])]
    eng.step()
    eng.step()
    rids += [eng.submit(p, b) for p, b in zip(prompts[2:], budgets[2:])]
    eng.run()
    return [eng.result(r) for r in rids]


@pytest.mark.parametrize("chunk", [None, 4])
def test_lm_dense_baseline_engine_streams_match_reference(chunk):
    """Greedy streams of the port's engine against the JAX engine's, both
    in ``bias_mode="dense"``, on gpt2_alibi_15b SMOKE, with whole-prompt
    admission waves and with chunked prefill."""
    _, jparams, cfg, tparams = _carried("gpt2_alibi_15b", bias_mode="dense")
    jmodel = jget_model(jsmoke("gpt2_alibi_15b").replace(
        bias_mode="dense", attn_impl="xla"))
    kw = {"max_len": 64, "n_slots": 2, "prefill_len": 12,
          "prefill_chunk": chunk}
    prompts = _prompts(cfg.vocab, (5, 9, 7, 12))
    budgets = [8, 5, 10, 6]
    want = _staggered(JServeEngine(jmodel, jparams, **kw), prompts, budgets)
    got = _staggered(ServeEngine(get_model(cfg), tparams, device="cpu", **kw),
                     prompts, budgets)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.status == OK and g.size == budgets[i]
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"req {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_models_are_not_served(arch):
    """The vision and PDE models have a template and a loss but no serve
    entries: the engine says so."""
    model = get_model(smoke_config(arch))
    assert model.template() and model.loss is not None
    assert model.prefill is None and model.decode is None
    with pytest.raises(ValueError, match="not served"):
        ServeEngine(model, {}, device="cpu")

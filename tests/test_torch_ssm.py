"""The port's SSM family (``mamba2_130m``) against the JAX reference, on the
CPU, float32, at SMOKE size (2 layers, d_model 64, 8 SSM heads x 16, state
16).

The reference's parameters (``init_params`` from a fixed key) are carried
across with ``params_from_numpy``; prompts and tokens come from numpy.

- Ragged prefill and six decode steps (one slot frozen at length 0): logits
  at ``atol = 1e-4`` (float32, summation order through 2 layers), caches at
  ``1e-5``, the frozen slot's state bit-identical;
- the template equals the reference's at full width (keys, shapes, init
  laws);
- ragged prefill equals an unpadded prefill of each prompt, and one decode
  step after it agrees (``tests/test_serve_engine.py:124``), at ``1e-4``;
- the cache is constant-size (``tests/test_models_smoke.py:73``);
- the staggered engine run gives the reference engine's greedy streams
  (``tests/test_serve_engine.py:73``), and a prompt longer than
  ``max_len`` is admitted with the reference's stream (``:159``);
- ``page_size`` is a no-op, with identical streams
  (``tests/test_paged_serve.py:91``);
- the launcher serves ``--arch mamba2_130m`` on the CPU.
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
from repro.models.common import init_params as jinit
from repro.models.common import is_pdef
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model, init_params
from repro_torch.serve import OK, ServeEngine

ARCH = "mamba2_130m"
B, S = 3, 13
LENGTHS = np.array([13, 5, 9], np.int32)
KW = {"max_len": 48, "n_slots": 2, "prefill_len": 11}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def carried():
    jcfg = jsmoke(ARCH)
    jmodel = jget_model(jcfg)
    jparams = jinit(jmodel.template(), jax.random.PRNGKey(0))
    cfg = smoke_config(ARCH)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    return jcfg, jmodel, jparams, get_model(cfg), tparams


def _np(x):
    return np.asarray(x, np.float32)


def _prompts(vocab, lens, seed=2):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def test_prefill_then_decode_match_reference(carried):
    jcfg, _, jparams, model, tparams = carried
    rng = np.random.default_rng(0)
    toks = rng.integers(0, model.cfg.vocab, (B, S)).astype(np.int32)
    jl, jc = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                         max_len=24, lengths=jnp.asarray(LENGTHS))
    with torch.no_grad():
        tl, tc = model.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                               max_len=24,
                               lengths=torch.from_numpy(LENGTHS))
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=1e-4, atol=1e-4)
    assert set(tc) == set(jc) == {"length", "ssm_h", "conv_x", "conv_bc"}
    for key in ("ssm_h", "conv_x", "conv_bc"):
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), _np(jc[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    assert tc["ssm_h"].dtype == torch.float32

    # freeze slot 1 (an idle lane): no state update, no length advance
    jc = {**jc, "length": jc["length"].at[1].set(0)}
    tc["length"][1] = 0
    frozen = {k: tc[k][:, 1].clone() for k in ("ssm_h", "conv_x", "conv_bc")}
    active = np.array([True, False, True])
    for _ in range(6):
        nt = rng.integers(0, model.cfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = jlm.decode_step(jparams, jc, jnp.asarray(nt), jcfg)
        with torch.no_grad():
            tl, tc = model.decode(tparams, tc, torch.from_numpy(nt))
        np.testing.assert_allclose(tl.numpy()[active], _np(jl)[active],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tc["length"].numpy(),
                                      np.asarray(jc["length"]))
    for key in ("ssm_h", "conv_x", "conv_bc"):
        np.testing.assert_allclose(tc[key].numpy()[:, active],
                                   _np(jc[key])[:, active], rtol=1e-4,
                                   atol=1e-4, err_msg=key)
        assert torch.equal(tc[key][:, 1], frozen[key]), key


def test_template_matches_reference_at_full_width():
    """Same nested keys, stacked shapes and init laws as the reference's
    template for the published config (nothing is allocated)."""
    jt = jget_model(jget_config(ARCH)).template()
    want = jax.tree.map(lambda p: (p.shape, p.init), jt, is_leaf=is_pdef)
    tt = get_model(get_config(ARCH)).template()

    def laws(tree):
        if isinstance(tree, dict):
            return {k: laws(v) for k, v in tree.items()}
        return tree.shape, tree.init
    assert laws(tt) == want
    assert tt["layers"]["ssm"]["d_skip"].init == ("ones",)
    assert set(tt["layers"]) == {"ln1", "ssm"}


def test_init_params_laws():
    cfg = smoke_config(ARCH)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    sp = params["layers"]["ssm"]
    assert torch.equal(sp["d_skip"], torch.ones_like(sp["d_skip"]))
    assert not sp["a_log"].any() and not sp["gate_norm"].any()
    assert abs(float(sp["conv_w"].std()) - 0.2) < 0.03


def test_ragged_prefill_matches_unpadded(carried):
    """The ragged machinery (last-valid logits gather, dt = 0 freeze,
    conv-tail gather) against an UNPADDED prefill of each prompt, then one
    decode step from each cache."""
    model, params = carried[3], carried[4]
    lens = [5, 13, 9]
    prompts = _prompts(model.cfg.vocab, lens, seed=5)
    padded = np.zeros((3, max(lens)), np.int64)
    for i, p in enumerate(prompts):
        padded[i, :p.size] = p
    with torch.no_grad():
        lg, cache = model.prefill(params,
                                  {"tokens": torch.from_numpy(padded)},
                                  max_len=48, lengths=torch.tensor(lens))
        for i, p in enumerate(prompts):
            lg1, c1 = model.prefill(
                params, {"tokens": torch.from_numpy(p[None].astype(np.int64))},
                max_len=48)
            np.testing.assert_allclose(lg[i:i + 1].numpy(), lg1.numpy(),
                                       atol=1e-4, err_msg=f"prefill row {i}")
            nxt = lg1[:, -1].argmax(-1)[:, None]
            d0, _ = model.decode(params, c1, nxt)
            ci = {k: (v[i:i + 1] if v.dim() == 1 else v[:, i:i + 1]).clone()
                  for k, v in cache.items()}
            d1, _ = model.decode(params, ci, nxt)
            np.testing.assert_allclose(d1.numpy(), d0.numpy(), atol=1e-4,
                                       err_msg=f"decode after row {i}")


def test_cache_is_constant_size():
    model = get_model(smoke_config(ARCH))
    c1 = model.init_cache(2, 64, device="cpu")
    c2 = model.init_cache(2, 4096, device="cpu")
    assert set(c1) == {"length", "ssm_h", "conv_x", "conv_bc"}
    for key in c1:
        assert c1[key].shape == c2[key].shape, key
    assert c1["ssm_h"].dtype == torch.float32
    assert model.init_paged_cache is None and model.insert_paged is None
    assert model.grow_page_table is None


def _staggered(eng, prompts, budgets):
    rids = [eng.submit(prompts[0], budgets[0]),
            eng.submit(prompts[1], budgets[1])]
    eng.step()
    eng.step()
    rids.append(eng.submit(prompts[2], budgets[2]))   # mid-flight arrival
    eng.run()
    return [eng.result(r) for r in rids]


def test_staggered_streams_match_reference_engine(carried):
    _, jmodel, jparams, model, params = carried
    prompts = _prompts(model.cfg.vocab, (4, 11, 7))
    budgets = [7, 4, 6]
    want = _staggered(JServeEngine(jmodel, jparams, **KW), prompts, budgets)
    got = _staggered(ServeEngine(model, params, device="cpu", **KW),
                     prompts, budgets)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.status == OK and g.size == budgets[i]
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"req {i}")


def test_prompt_longer_than_max_len_is_admitted(carried):
    _, jmodel, jparams, model, params = carried
    long_prompt = _prompts(model.cfg.vocab, (55,), seed=6)[0]
    jeng = JServeEngine(jmodel, jparams, max_len=40, n_slots=2)
    jrid = jeng.submit(long_prompt, 4)
    jeng.run()
    eng = ServeEngine(model, params, max_len=40, n_slots=2, device="cpu")
    rid = eng.submit(long_prompt, 4)
    eng.run()
    rec = eng.result(rid)
    assert rec.status == OK and rec.size == 4
    np.testing.assert_array_equal(rec, np.asarray(jeng.result(jrid)))


def test_page_size_is_a_no_op(carried):
    model, params = carried[3], carried[4]
    prompts = _prompts(model.cfg.vocab, (4, 11, 7))
    budgets = [7, 4, 6]
    contiguous = ServeEngine(model, params, device="cpu", **KW)
    paged = ServeEngine(model, params, device="cpu", page_size=16, **KW)
    assert not paged.backend.paged and not contiguous.backend.paged
    want = _staggered(contiguous, prompts, budgets)
    got = _staggered(paged, prompts, budgets)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"req {i}")
    assert paged.page_stats() == {}


def test_launcher_serves_mamba2_on_cpu():
    out = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--requests", "3", "--slots", "2",
                             "--prompt-len", "12", "--new-tokens", "4",
                             "--page-size", "16"])
    assert len(out) == 3 and all(r.status == OK and r.size == 4 for r in out)

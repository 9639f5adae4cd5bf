"""The port's sliding-window (ring) attention and the hybrid family against
the JAX reference, on the CPU, float32, at SMOKE size: ``hymba_15b`` (2
layers, d_model 128, 4 heads x 32 over 2 kv heads, window 32, SSM state 8)
and ``stablelm_12b`` with ``window=16`` (dense attention over a ring).

The reference's parameters are carried across with ``params_from_numpy``;
prompts and tokens come from numpy; the reference runs its XLA path.

- The template: the reference's keys, shapes and init laws at full width
  (the hybrid layer carries attention, SSM, both branch norms and the MLP);
  a frontend config's template is the plain one's (the frontends are
  served: ``tests/test_torch_frontends.py``; MoE: ``tests/test_torch_moe.py``).
- Ragged prefill with prompts shorter than, equal to and longer than the
  window: logits at ``atol 1e-5`` and every cache leaf (the ring padded or
  gathered, ``ssm_h`` / ``conv_x`` / ``conv_bc``) at ``1e-5``; then decode
  steps that carry every row past the window, at the same tolerances
  (float32 through 2 layers, summation order only).
- Decoding past the window from a ring equals a full prefill of the longer
  prompt (``tests/test_models_smoke.py::test_hymba_ring_cache_beyond_window``).
- ``lm.prefill_chunk`` on a ring: a prompt landing in three chunks that
  wrap the ring beside a whole short prompt and a frozen row, against the
  reference's, logits and caches at ``1e-5``, frozen rows bit-identical.
- The engine: greedy streams equal the JAX engine's (prompt lengths 5, 35,
  20, as ``tests/test_serve_engine.py:124-140``); a chunked engine (chunk
  clamped to the window) equals the whole-prompt engine and the JAX
  chunked engine; ``page_size`` is a no-op; ``prefix_cache`` is refused
  with the reference's error; a prompt longer than ``max_len`` is
  admitted.
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
from repro_torch.models import get_model, lm
from repro_torch.serve import OK, ServeEngine

ARCHS = {"hymba": ("hymba_15b", {}),
         "stablelm-window": ("stablelm_12b", {"window": 16})}
KW = {"max_len": 48, "n_slots": 2}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _carried(name):
    arch, replace = ARCHS[name]
    jcfg = jsmoke(arch).replace(attn_impl="xla", **replace)
    jmodel = jget_model(jcfg)
    jparams = jinit(jmodel.template(), jax.random.PRNGKey(0))
    cfg = smoke_config(arch).replace(**replace)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jmodel, jparams, get_model(cfg), params


@pytest.fixture(scope="module")
def hymba():
    return _carried("hymba")


def _prompts(vocab, lens, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def _close(got: dict, want: dict, tol: float, msg: str):
    assert set(got) == set(want), msg
    for key, val in got.items():
        g, w = val.numpy(), np.asarray(want[key], np.float32)
        assert g.shape == w.shape, f"{msg} {key}"
        np.testing.assert_allclose(g, w, atol=tol, rtol=0,
                                   err_msg=f"{msg} {key}")


# ---------------------------------------------------------------------------
# Template
# ---------------------------------------------------------------------------

def test_template_matches_reference_at_full_width():
    jt = jget_model(jget_config("hymba_15b")).template()
    want = jax.tree.map(lambda p: (p.shape, p.init), jt, is_leaf=is_pdef)
    tt = get_model(get_config("hymba_15b")).template()

    def laws(tree):
        if isinstance(tree, dict):
            return {k: laws(v) for k, v in tree.items()}
        return tree.shape, tree.init
    assert laws(tt) == want
    assert set(tt["layers"]) == {"ln1", "attn", "ssm", "branch_norm_attn",
                                 "branch_norm_ssm", "mlp", "ln2"}
    cfg = get_config("hymba_15b")
    assert (cfg.window, cfg.ssm_state, cfg.heads_padded,
            cfg.kv_heads_padded, cfg.resolved_head_dim) == (1024, 16, 48, 6,
                                                            64)


@pytest.mark.parametrize("replace", [{"frontend": "vision"},
                                     {"frontend": "audio"}])
def test_moe_and_frontends_are_refused(replace):
    # refused until the frontends were ported (tests/test_torch_frontends.py):
    # a frontend only adds prompt rows, so the template is the plain one's
    cfg = smoke_config("stablelm_12b")
    tmpl = lm.lm_template(cfg.replace(**replace, frontend_len=8))
    assert jax.tree.map(lambda p: p.shape, tmpl) == jax.tree.map(
        lambda p: p.shape, lm.lm_template(cfg))


# ---------------------------------------------------------------------------
# Prefill (ring padded / gathered) and decode past the window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fit", ["shorter", "equal", "longer"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_and_decode_match_reference(name, fit):
    jmodel, jparams, model, params = _carried(name)
    cfg, jcfg = model.cfg, jmodel.cfg
    w = cfg.window
    width = {"shorter": w - 7, "equal": w, "longer": w + 13}[fit]
    # row 1 is right-padded in its wave; row 2 sits at the window's edge
    lens = np.array([width, 5, min(width, w - 1)], np.int32)
    rng = np.random.default_rng(width)
    toks = rng.integers(0, cfg.vocab, (3, width)).astype(np.int32)
    jl, jc = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                         max_len=48, lengths=jnp.asarray(lens))
    with torch.no_grad():
        tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                               max_len=48, lengths=torch.from_numpy(lens))
    assert tc["k"].shape[3] == w                       # a ring, not full
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)
    _close(tc, jc, 1e-5, "prefill")
    jdecode = jax.jit(lambda p, c, t: jlm.decode_step(p, c, t, jcfg))
    for step in range(w + 3):                          # every row wraps
        nt = rng.integers(0, cfg.vocab, (3, 1)).astype(np.int32)
        jl, jc = jdecode(jparams, jc, jnp.asarray(nt))
        with torch.no_grad():
            tl, tc = model.decode(params, tc, torch.from_numpy(nt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=0, err_msg=f"decode {step}")
    _close(tc, jc, 1e-5, "after decode")


def test_ring_decode_beyond_window_equals_full_prefill(hymba):
    model, params = hymba[2], hymba[3]
    w = model.cfg.window
    t = w + 8
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab, (1, t + 1)))
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks[:, :t]},
                                 max_len=t + 4)
        assert cache["k"].shape[3] == w
        assert cache["k"].shape[2] == model.cfg.kv_heads_padded
        lg, _ = model.decode(params, cache, toks[:, t:t + 1])
        lg_ref, _ = model.prefill(params, {"tokens": toks}, max_len=t + 5)
    np.testing.assert_allclose(lg.numpy(), lg_ref.numpy(), atol=3e-3)


def test_frozen_rows_keep_their_ring_and_state(hymba):
    model, params = hymba[2], hymba[3]
    cache = model.init_cache(2, 48, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, model.cfg.vocab, (2, 40)))
    with torch.no_grad():
        _, wave = model.prefill(params, {"tokens": toks}, max_len=48,
                                lengths=torch.tensor([40, 9]))
        cache = model.insert_cache(cache, wave, np.array([0, 1]))
        cache["length"][1] = 0
        before = {k: v[:, 1].clone() for k, v in cache.items()
                  if k != "length"}
        for _ in range(3):
            _, cache = model.decode(params, cache, toks[:, :1])
    assert cache["length"].tolist() == [43, 0]
    for key, val in before.items():
        assert torch.equal(cache[key][:, 1], val), key


# ---------------------------------------------------------------------------
# prefill_chunk on a ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_chunk_on_ring_matches_reference(name):
    jmodel, jparams, model, params = _carried(name)
    cfg, jcfg = model.cfg, jmodel.cfg
    w, b = cfg.window, 3
    c = w // 2                     # three chunks of row 0 wrap the ring
    cache = model.init_cache(b, 48, device="cpu")
    jcache = jlm.init_cache(jcfg, b, 48)
    assert cache["k"].shape[3] == w
    rng = np.random.default_rng(11)
    n = 2 * c + c // 2 + 1
    prompt = rng.integers(0, cfg.vocab, (n,))
    calls = [(np.zeros(b, np.int64), np.array([c, 7, 0]),
              np.array([-1, 7, -1])),
             (np.array([c, 0, 0]), np.array([c, 0, 0]),
              np.array([-1, -1, -1])),
             (np.array([2 * c, 0, 0]), np.array([n - 2 * c, 0, 0]),
              np.array([n, -1, -1]))]
    for k, (offs, clens, flens) in enumerate(calls):
        toks = rng.integers(0, cfg.vocab, (b, c))
        toks[0, :clens[0]] = prompt[offs[0]:offs[0] + clens[0]]
        before = {key: v.clone() for key, v in cache.items()}
        with torch.no_grad():
            logits, cache = model.prefill_chunk(
                params, cache, torch.tensor(toks), offs, clens, flens)
        jlogits, jcache = jlm.prefill_chunk(
            jparams, jcache, jnp.asarray(toks, jnp.int32), jcfg,
            offsets=offs, chunk_lens=clens, final_lens=flens)
        done = flens >= 0
        np.testing.assert_allclose(logits.numpy()[done],
                                   np.asarray(jlogits)[done], atol=1e-5,
                                   rtol=0, err_msg=f"call {k}")
        _close(cache, jcache, 1e-5, f"call {k}")
        frozen = np.nonzero(clens == 0)[0]
        for key, val in cache.items():
            if key != "length":
                assert torch.equal(val[:, frozen], before[key][:, frozen])


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _staggered(eng, prompts, budgets):
    rids = [eng.submit(prompts[0], budgets[0]),
            eng.submit(prompts[1], budgets[1])]
    eng.step()
    eng.step()
    rids.append(eng.submit(prompts[2], budgets[2]))   # mid-flight arrival
    eng.run()
    return [eng.result(r) for r in rids]


@pytest.mark.parametrize("name", list(ARCHS))
def test_engine_streams_match_reference_engine(name):
    jmodel, jparams, model, params = _carried(name)
    w = model.cfg.window
    prompts = _prompts(model.cfg.vocab, (5, w + 3, 20))   # one > window
    budgets = [7, 9, 6]
    want = _staggered(JServeEngine(jmodel, jparams, **KW), prompts, budgets)
    eng = ServeEngine(model, params, device="cpu", **KW)
    got = _staggered(eng, prompts, budgets)
    assert eng.backend.ring and not eng.backend.paged
    for i, (g, wnt) in enumerate(zip(got, want)):
        assert g.status == OK and g.size == budgets[i]
        np.testing.assert_array_equal(g, np.asarray(wnt), err_msg=f"req {i}")


def _traffic(engine, prompts, budget=6):
    rids = [engine.submit(p, budget) for p in prompts[:2]]
    engine.step()
    rids.append(engine.submit(prompts[2], budget))
    engine.run()
    return [engine.result(r) for r in rids]


def test_chunked_engine_matches_whole_and_reference(hymba):
    """Chunk 100 clamps to the window (32); a 60-token prompt wraps the
    ring mid-prefill."""
    jmodel, jparams, model, params = hymba
    prompts = _prompts(model.cfg.vocab, (60, 10, 21))
    whole = _traffic(ServeEngine(model, params, device="cpu", **KW),
                     prompts)
    eng = ServeEngine(model, params, device="cpu", prefill_chunk=100, **KW)
    jeng = JServeEngine(jmodel, jparams, prefill_chunk=100, **KW)
    assert eng.backend.chunk_size == jeng.backend.chunk_size == \
        model.cfg.window
    chunked = _traffic(eng, prompts)
    want = _traffic(jeng, prompts)
    assert eng.backend.n_chunk_steps > 2
    for i, (a, b, c) in enumerate(zip(whole, chunked, want)):
        assert b.status == OK
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
        np.testing.assert_array_equal(b, np.asarray(c), err_msg=f"req {i}")


def test_page_size_is_a_no_op_and_long_prompts_admit(hymba):
    model, params = hymba[2], hymba[3]
    prompts = _prompts(model.cfg.vocab, (4, 11, 60))      # 60 > max_len
    budgets = [7, 4, 6]
    out = _staggered(ServeEngine(model, params, device="cpu", **KW),
                     prompts, budgets)
    eng = ServeEngine(model, params, device="cpu", page_size=16, **KW)
    paged = _staggered(eng, prompts, budgets)
    assert not eng.backend.paged and eng.page_stats() == {}
    for i, (a, b) in enumerate(zip(out, paged)):
        assert b.status == OK
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")


def test_prefix_cache_is_refused(hymba):
    model, params = hymba[2], hymba[3]
    kw = dict(page_size=4, prefill_chunk=8, prefix_cache=True, **KW)
    with pytest.raises(ValueError, match="prefix_cache needs paged KV"):
        ServeEngine(model, params, device="cpu", **kw)
    with pytest.raises(ValueError, match="prefix_cache needs paged KV"):
        JServeEngine(hymba[0], hymba[1], **kw)

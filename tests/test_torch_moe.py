"""The port's MoE family against the JAX reference, on the CPU, float32, at
SMOKE size: ``granite_moe_3b_a800m`` (2 layers, d_model 64, 5 experts top
2, 4 heads over 2 kv heads) and ``llama4_scout_17b_a16e`` (4 experts top
1).

The reference's parameters are carried across with ``params_from_numpy``;
inputs come from numpy; the reference runs its XLA path. Tolerance 1e-5
(float32, summation order only).

- ``_moe_capacity`` and ``_moe_ffn``: y and the aux value, with and without
  ``valid``, at a ``capacity_factor`` low enough that entries overflow and
  are dropped (and at the config's own); the twins of
  ``tests/test_models_smoke.py``'s padded-experts test (``tp=4`` pads 5
  experts to 8: with NaN weights in the padded experts y stays finite and
  equal to the reference's) and top-1 over one expert (the dense SwiGLU).
- The template and ``params_from_numpy``: the reference's keys, shapes and
  init laws at full width, and a carried tree that round-trips to numpy.
- ``prefill`` (ragged), ``decode_step`` and ``prefill_chunk`` logits and
  caches against the JAX functions.
- The engine: paged streams equal to contiguous streams (the twin of
  ``tests/test_paged_serve.py::test_moe_paged_matches_contiguous``), and
  the port's streams and statuses equal to the JAX engine's, contiguous,
  paged with a pool that preempts, and chunked.
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
from repro_torch.models.common import swiglu, tree_map
from repro_torch.serve import OK, ServeEngine

ARCHS = ["granite_moe_3b_a800m", "llama4_scout_17b_a16e"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _carried(arch, **replace):
    jcfg = jsmoke(arch).replace(attn_impl="xla", **replace)
    jmodel = jget_model(jcfg)
    jparams = jinit(jmodel.template(), jax.random.PRNGKey(0))
    cfg = smoke_config(arch).replace(**replace)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jmodel, jparams, get_model(cfg), params


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    return _carried(request.param)


def _expert_params(cfg, seed=0):
    """One layer's MoE leaves from the reference's template and init, and
    the same as port tensors."""
    jmp = jinit(jlm._moe_template(cfg), jax.random.PRNGKey(seed))
    return jmp, {k: torch.from_numpy(np.array(v)) for k, v in jmp.items()}


# ---------------------------------------------------------------------------
# The MoE FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.5, None], ids=["overflow", "config"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, masked, cf):
    cfg = smoke_config(arch)
    if cf is not None:
        cfg = cfg.replace(capacity_factor=cf)
    jcfg = jsmoke(arch).replace(capacity_factor=cfg.capacity_factor)
    jmp, mp = _expert_params(cfg)
    rng = np.random.RandomState(1)
    x = rng.standard_normal((3, 16, cfg.d_model)).astype(np.float32)
    valid = None
    if masked:
        valid = np.arange(16)[None, :] < np.array([16, 9, 0])[:, None]
    assert lm._moe_capacity(cfg, 16) == jlm._moe_capacity(jcfg, 16)
    y, aux = lm._moe_ffn(mp, torch.from_numpy(x), cfg,
                         None if valid is None else torch.from_numpy(valid))
    jy, jaux = jlm._moe_ffn(jmp, jnp.asarray(x), jcfg,
                            None if valid is None else jnp.asarray(valid))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5, rtol=1e-5)
    if masked:
        assert not y[2].any() and not y[1, 9:].any()
    if cf is not None:          # fewer slots than entries: some dropped
        assert lm._moe_capacity(cfg, 16) * cfg.experts_padded < 16 * cfg.top_k


def test_padded_experts_never_selected():
    """The twin of ``test_moe_padded_experts_never_selected``: tp=4 pads 5
    experts to 8; NaN weights in the padded ones leave y finite."""
    cfg = smoke_config("granite_moe_3b_a800m").replace(tp=4)
    jcfg = jsmoke("granite_moe_3b_a800m").replace(tp=4)
    assert cfg.experts_padded == 8 and cfg.n_experts == 5
    jmp, mp = _expert_params(cfg)
    x = np.random.RandomState(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    poisoned = dict(mp)
    for key in ("wi", "wo"):
        poisoned[key] = mp[key].clone()
        poisoned[key][cfg.n_experts:] = float("nan")
    y, aux = lm._moe_ffn(poisoned, torch.from_numpy(x), cfg)
    assert torch.isfinite(y).all() and torch.isfinite(aux)
    jy, jaux = jlm._moe_ffn(jmp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5, rtol=1e-5)


def test_top1_over_one_expert_is_the_dense_expert():
    cfg = smoke_config("llama4_scout_17b_a16e").replace(
        n_experts=1, top_k=1, capacity_factor=4.0, tp=1)
    _, mp = _expert_params(cfg)
    x = torch.from_numpy(np.random.RandomState(3).standard_normal(
        (1, 8, cfg.d_model)).astype(np.float32))
    y, _ = lm._moe_ffn(mp, x, cfg)
    torch.testing.assert_close(y, swiglu(x, mp["wi"][0], mp["wo"][0]),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# Template and carried parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_template_matches_reference_at_full_width(arch):
    jt = jget_model(jget_config(arch)).template()
    want = jax.tree.map(lambda p: (p.shape, p.init), jt, is_leaf=is_pdef)

    def laws(tree):
        if isinstance(tree, dict):
            return {k: laws(v) for k, v in tree.items()}
        return tree.shape, tree.init
    tt = get_model(get_config(arch)).template()
    assert laws(tt) == want
    assert set(tt["layers"]) == {"ln1", "attn", "moe", "ln2"}


def test_params_from_numpy_round_trips_the_moe_template(carried):
    jmodel, jparams, model, params = carried
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert any("router" in jax.tree_util.keystr(p) for p, _ in flat)
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    again = params_from_numpy(tree_map(lambda t: t.numpy(), params),
                              model.cfg, device="cpu")
    for key in ("router", "wi", "wo"):
        assert torch.equal(again["layers"]["moe"][key],
                           params["layers"]["moe"][key])


# ---------------------------------------------------------------------------
# Model entry points against the reference's
# ---------------------------------------------------------------------------

def _close(got: dict, want: dict, msg: str):
    assert set(got) == set(want), msg
    for key, val in got.items():
        np.testing.assert_allclose(val.numpy().astype(np.float64),
                                   np.asarray(want[key], np.float64),
                                   atol=1e-5, rtol=0, err_msg=f"{msg} {key}")


def test_prefill_and_decode_match_reference(carried):
    jmodel, jparams, model, params = carried
    rng = np.random.RandomState(5)
    toks = rng.randint(0, model.cfg.vocab, (3, 12)).astype(np.int32)
    lens = np.array([12, 7, 1], np.int32)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(
            toks)}, max_len=20, lengths=torch.from_numpy(lens))
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                     max_len=20, lengths=jnp.asarray(lens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)
    _close(cache, jcache, "prefill")
    for step in range(4):
        nxt = rng.randint(0, model.cfg.vocab, (3, 1)).astype(np.int32)
        with torch.no_grad():
            logits, cache = model.decode(params, cache, torch.from_numpy(nxt))
        jlogits, jcache = jmodel.decode(jparams, jcache, jnp.asarray(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-5, rtol=0, err_msg=f"step {step}")
        _close(cache, jcache, f"step {step}")


def test_prefill_chunk_matches_reference(carried):
    """Chunks of 4 on a contiguous cache: a 10-token prompt on row 0 over
    three chunks (the last partial, so MoE capacity sees padding), row 1
    frozen at its prefilled length."""
    jmodel, jparams, model, params = carried
    rng = np.random.RandomState(6)
    first = rng.randint(0, model.cfg.vocab, (2, 5)).astype(np.int32)
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": torch.from_numpy(first)},
                                 max_len=16)
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(first)},
                               max_len=16)
    prompt = rng.randint(0, model.cfg.vocab, (10,))
    for off in (0, 4, 8):
        n = min(4, 10 - off)
        toks = np.zeros((2, 4), np.int32)
        toks[0, :n] = prompt[off:off + n]
        kw = dict(offsets=np.array([off, 0]), chunk_lens=np.array([n, 0]),
                  final_lens=np.array([10 if off == 8 else -1, -1]))
        with torch.no_grad():
            logits, cache = model.prefill_chunk(
                params, cache, torch.from_numpy(toks), **kw)
        jlogits, jcache = jmodel.prefill_chunk(
            jparams, jcache, jnp.asarray(toks),
            **{k: jnp.asarray(v, jnp.int32) for k, v in kw.items()})
        np.testing.assert_allclose(logits.numpy()[0], np.asarray(jlogits)[0],
                                   atol=1e-5, rtol=0, err_msg=f"chunk {off}")
        _close(cache, jcache, f"chunk {off}")
    assert cache["length"].tolist() == [10, 5]


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _prompts(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def test_paged_matches_contiguous():
    _, _, model, params = _carried("granite_moe_3b_a800m")
    kw = {"max_len": 32, "n_slots": 2, "prefill_len": 8}
    prompts = _prompts(model.cfg.vocab, (5, 8), seed=3)
    streams = []
    for extra in ({}, {"page_size": 8}):
        eng = ServeEngine(model, params, device="cpu", **kw, **extra)
        assert eng.backend.paged == bool(extra)
        rids = [eng.submit(p, 4) for p in prompts]
        eng.run()
        streams.append([np.asarray(eng.result(r)) for r in rids])
    for a, b in zip(*streams):
        np.testing.assert_array_equal(a, b)


ENGINES = {
    "contiguous": {},
    "paged pool that preempts": {"page_size": 4, "n_pages": 7},
    "chunked paged": {"page_size": 4, "prefill_chunk": 4},
}


@pytest.mark.parametrize("setup", list(ENGINES))
def test_engine_matches_reference_engine(carried, setup):
    jmodel, jparams, model, params = carried
    prompts = _prompts(model.cfg.vocab, (9, 5, 12, 3, 7), seed=7)
    kw = {"max_len": 24, "n_slots": 2, **ENGINES[setup]}
    out = {}
    for name, eng in (("port", ServeEngine(model, params, device="cpu",
                                           **kw)),
                      ("reference", JServeEngine(jmodel, jparams, **kw))):
        rids = [eng.submit(p, 8) for p in prompts]
        eng.run()
        out[name] = ([eng.result(r).status for r in rids],
                     [np.asarray(eng.result(r)).tolist() for r in rids],
                     eng.page_stats())
    assert out["port"] == out["reference"]
    assert set(out["port"][0]) == {OK}
    if setup == "paged pool that preempts":
        assert out["port"][2]["preemptions"] >= 1

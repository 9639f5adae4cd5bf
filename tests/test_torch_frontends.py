"""The frontend configs (``musicgen_medium``: audio, 64 frontend rows;
``phi3_vision_42b``: vision, 576 rows) against the JAX reference, on the
CPU, float32, at SMOKE size (8 and 16 rows).

- Every dataclass field of CONFIG and SMOKE equals the reference's, and so
  does ``param_count``; the padded shapes the kernels see on the card
  (musicgen 24 heads padded to 32 x 64, phi-3-vision 32 x 96).
- ``lm.prefill`` with a frontend batch (ragged lengths counting the
  frontend rows): logits and cache leaves at 1e-5, then decode steps.
- The port's and the JAX engines on the same frontend traffic, contiguous
  and paged (a pool that grows and preempts): statuses, greedy streams and
  ``page_stats()`` equal.
- A chunked engine refuses a frontend request as the reference's does, and
  a wave that mixes requests with and without frontend rows fails with the
  reference's assertion.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke
from repro.models import get_model as jget_model
from repro.models.common import init_params as jinit
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import get_model
from repro_torch.serve import OK, AdmissionRejected, ServeEngine

ARCHS = ["musicgen_medium", "phi3_vision_42b"]
# (heads_padded, head dim, frontend rows, frontend kind) at CONFIG
SHAPES = {"musicgen_medium": (32, 64, 64, "audio"),
          "phi3_vision_42b": (32, 96, 576, "vision")}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    arch = request.param
    jcfg = jsmoke(arch).replace(attn_impl="xla")
    jmodel = jget_model(jcfg)
    jparams = jinit(jmodel.template(), jax.random.PRNGKey(0))
    cfg = smoke_config(arch)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jmodel, jparams, get_model(cfg), params


def _traffic(cfg, seed: int, lens):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in lens]
    fronts = [rng.standard_normal((cfg.frontend_len, cfg.d_model))
              .astype(np.float32) for _ in lens]
    return prompts, fronts


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_the_reference(arch, which):
    get, jget = ((get_config, jget_config) if which == "CONFIG"
                 else (smoke_config, jsmoke))
    assert arch in ARCH_IDS
    assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))
    if which == "CONFIG":
        cfg = get(arch)
        assert (cfg.heads_padded, cfg.resolved_head_dim, cfg.frontend_len,
                cfg.frontend) == SHAPES[arch]
        assert cfg.param_count() == jget(arch).param_count()


def test_prefill_with_frontend_matches_reference(carried):
    jmodel, jparams, model, params = carried
    cfg = model.cfg
    f = cfg.frontend_len
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (3, 10)).astype(np.int32)
    front = rng.standard_normal((3, f, cfg.d_model)).astype(np.float32)
    lens = np.array([10, 6, 1], np.int32) + f        # frontend rows count
    max_len = f + 16
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(toks),
                     "frontend": torch.from_numpy(front)},
            max_len=max_len, lengths=torch.from_numpy(lens))
    jlogits, jcache = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(toks),
                  "frontend": jnp.asarray(front)},
        max_len=max_len, lengths=jnp.asarray(lens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)
    for step in range(3):
        nxt = rng.integers(0, cfg.vocab, (3, 1)).astype(np.int32)
        with torch.no_grad():
            logits, cache = model.decode(params, cache, torch.from_numpy(nxt))
        jlogits, jcache = jmodel.decode(jparams, jcache, jnp.asarray(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-5, rtol=0, err_msg=f"step {step}")
    for key in ("k", "v", "length"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                   atol=1e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_engine_matches_reference_engine(carried, paged):
    jmodel, jparams, model, params = carried
    cfg = model.cfg
    prompts, fronts = _traffic(cfg, 7, (10, 6, 3, 12, 5))
    kw = {"max_len": cfg.frontend_len + 24, "n_slots": 2}
    if paged:
        kw.update(page_size=4, n_pages=(cfg.frontend_len + 12) // 4 + 6)
    out = {}
    for name, eng in (("port", ServeEngine(model, params, device="cpu",
                                           **kw)),
                      ("reference", JServeEngine(jmodel, jparams, **kw))):
        rids = [eng.submit(p, 8, frontend=f) for p, f in zip(prompts, fronts)]
        eng.run()
        out[name] = ([eng.result(r).status for r in rids],
                     [np.asarray(eng.result(r)).tolist() for r in rids],
                     eng.page_stats())
    assert out["port"] == out["reference"]
    assert set(out["port"][0]) == {OK}
    if paged:
        stats = out["port"][2]
        assert stats["grown"] >= 1 and stats["preemptions"] >= 1
        assert stats["n_free"] == stats["n_pages"]


def test_generate_with_frontend_matches_reference(carried):
    jmodel, jparams, model, params = carried
    prompts, fronts = _traffic(model.cfg, 9, (7, 7))
    kw = {"max_len": model.cfg.frontend_len + 16, "n_slots": 2}
    got = ServeEngine(model, params, device="cpu", **kw).generate(
        prompts, 5, frontend=fronts)
    want = JServeEngine(jmodel, jparams, **kw).generate(prompts, 5,
                                                        frontend=fronts)
    np.testing.assert_array_equal(got, want)


def test_chunked_refusal_and_mixed_wave_match_reference(carried):
    jmodel, jparams, model, params = carried
    prompts, fronts = _traffic(model.cfg, 11, (6, 5))
    kw = {"max_len": model.cfg.frontend_len + 16, "n_slots": 2}
    for eng in (ServeEngine(model, params, device="cpu", prefill_chunk=4,
                            **kw),
                JServeEngine(jmodel, jparams, prefill_chunk=4, **kw)):
        with pytest.raises(Exception, match="chunked prefill takes token "
                                            "prompts only") as err:
            eng.submit(prompts[0], 4, frontend=fronts[0])
        assert type(err.value).__name__ == AdmissionRejected.__name__
        rid = eng.submit(prompts[0], 4, frontend=fronts[0], strict=False)
        assert eng.result(rid).status == "REJECTED"
    for eng in (ServeEngine(model, params, device="cpu", **kw),
                JServeEngine(jmodel, jparams, **kw)):
        eng.submit(prompts[0], 4, frontend=fronts[0])
        eng.submit(prompts[1], 4)
        with pytest.raises(AssertionError, match="wave mixes frontend/"
                                                 "frontend-less requests"):
            eng.run()

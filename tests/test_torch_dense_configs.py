"""The three plain dense ALiBi configs the port copies from the reference
(``codeqwen15_7b``: MHA 32 x 128; ``minicpm_2b``: 36 heads padded to 48 x
64; ``command_r_plus_104b``: 96 heads over 8 kv heads, 12 per group, x
128), on the CPU, float32, at SMOKE size.

- Every dataclass field of CONFIG and SMOKE equals the reference's, and the
  padded shapes the port derives are the ones the kernels see on the card.
- SMOKE ragged prefill and decode logits against the JAX functions at 1e-5
  (the reference's parameters carried across with ``params_from_numpy``).
- Greedy engine streams and statuses equal to the JAX engine's, contiguous
  and paged.
- ``cache_layout="legacy"`` (the reference's TPU layout A/B baseline) is
  refused by name, not ignored.
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
from repro_torch.models import get_model, lm
from repro_torch.serve import OK, ServeEngine

ARCHS = ["codeqwen15_7b", "minicpm_2b", "command_r_plus_104b"]
# (heads_padded, kv_heads_padded, head dim, q heads per kv head) at CONFIG
SHAPES = {"codeqwen15_7b": (32, 32, 128, 1), "minicpm_2b": (48, 48, 64, 1),
          "command_r_plus_104b": (96, 8, 128, 12)}


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


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_the_reference(arch, which):
    get, jget = ((get_config, jget_config) if which == "CONFIG"
                 else (smoke_config, jsmoke))
    assert arch in ARCH_IDS
    assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))
    if which == "CONFIG":
        cfg = get(arch)
        assert (cfg.heads_padded, cfg.kv_heads_padded, cfg.resolved_head_dim,
                cfg.kv_groups) == SHAPES[arch]


def test_arch_ids_hold_twelve_of_the_reference_configs():
    # twelve until the frontend configs were ported; every one of the
    # reference's 14 since (tests/test_torch_frontends.py covers the two)
    from repro.configs.base import list_archs
    reference = set(list_archs(include_paper=True))
    assert set(ARCH_IDS) == reference and len(ARCH_IDS) == 14


def test_prefill_and_decode_match_reference(carried):
    jmodel, jparams, model, params = carried
    rng = np.random.RandomState(5)
    toks = rng.randint(0, model.cfg.vocab, (3, 10)).astype(np.int32)
    lens = np.array([10, 6, 1], np.int32)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(
            toks)}, max_len=16, lengths=torch.from_numpy(lens))
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                     max_len=16, lengths=jnp.asarray(lens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)
    for step in range(3):
        nxt = rng.randint(0, model.cfg.vocab, (3, 1)).astype(np.int32)
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
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, model.cfg.vocab, (n,)).astype(np.int32)
               for n in (9, 5, 12, 3)]
    kw = {"max_len": 24, "n_slots": 2}
    if paged:
        kw.update(page_size=4, n_pages=8)
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


@pytest.mark.parametrize("arch", ["gpt2_alibi_15b", "granite_moe_3b_a800m",
                                  "hymba_15b"])
def test_legacy_cache_layout_is_refused_by_name(arch):
    cfg = smoke_config(arch).replace(cache_layout="legacy")
    for call in (lambda: lm.lm_template(cfg),
                 lambda: lm.init_cache(cfg, 2, 8, device="cpu"),
                 lambda: lm.init_paged_cache(cfg, 2, 4, 4, device="cpu")):
        with pytest.raises(ValueError, match="legacy.*TPU layout A/B "
                                             "baseline and is not ported"):
            call()

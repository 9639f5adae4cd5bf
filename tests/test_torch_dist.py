"""The port's sharding layer against the JAX package, in one process (the
multi-process runs are in ``test_torch_sharded_serve.py``):

- ``Rules``: defaults, overrides (a name, a tuple, ``None``, new
  vocabulary), immutability and equality, against ``repro.dist.Rules``;
- ``spec_for`` against the JAX ``spec_for`` on 1-D, 2-D and 3-D meshes and
  under the sequence-parallel override, the JAX entries normalised to
  tuples (a duck-typed mesh serves both: each reads only axis names and
  sizes);
- ``batch_axes_for`` and the replication rule of ``shard_put``
  (``degraded_spec``) against the contract of ``src/repro/dist/README.md``
  (the JAX functions index a jax 0.9 ``PartitionSpec`` entry that is a
  bare string and fail here; ROADMAP.md Queue C);
- every template's logical axes, leaf for leaf, against the JAX
  template's, for every config of ``ARCH_IDS`` and ``PAPER_IDS`` (GPT-2
  ALiBi, ``pairformer_lite``, ``swinv2_b``, ``pde_solver``);
- the token backend's ``_state_axes()`` against the JAX backend's (dense
  contiguous and paged, SSM, hybrid ring and paged);
- ``serve_rules``, ``placements_for``, ``make_production_mesh``'s shape
  check, the ``mesh_rules`` checks on handmade inputs, and the unsharded
  engine creating no DTensor and issuing no collective.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.configs.base import ARCH_IDS, PAPER_IDS
from repro.dist import sharding as jshard
from repro.models import get_model as jget_model
from repro.models.common import init_params as jinit
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import smoke_config
from repro_torch.dist import (DEFAULT_RULES, Rules, batch_axes_for,
                              degraded_spec, get_active_mesh,
                              placements_for, spec_for, use_mesh_rules)
from repro_torch.launch import mesh as tmesh
from repro_torch.models import get_model, init_params
from repro_torch.models.common import PDef, param_specs, tree_leaves
from repro_torch.serve import ServeEngine
from repro_torch.serve.backend import serve_rules
from repro_torch.statcheck import (check_collectives,
                                   check_shard_divisibility,
                                   check_state_axes, shard_degradations)


class DuckMesh:
    """Axis names and sizes: all either package's spec functions read."""

    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


MESHES = {"1d": DuckMesh(model=4), "2d": DuckMesh(data=2, model=4),
          "3d": DuckMesh(pod=2, data=2, model=2)}
AXES = [("batch", "seq", None), ("fsdp", "heads", None),
        ("heads", None, "fsdp"), ("layers", "batch", "kv_heads", None, None),
        ("vocab", "fsdp"), ("expert", "fsdp", None, None),
        ("batch", "seq", "mlp"), ("seq", "heads"), ("kv_seq", "batch"),
        ("unknown_axis", "heads"), (None,)]
OVERRIDES = [None, {"seq": ("model",)}, {"seq": "model", "heads": None},
             {"kv_seq": ("data", "model"), "batch": "data"}]


def _jax_entries(spec) -> tuple:
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def test_rules_match_the_reference():
    assert DEFAULT_RULES == jshard.DEFAULT_RULES
    for ov in OVERRIDES:
        port, ref = Rules.make(ov), jshard.Rules.make(ov)
        assert port.table == ref.table
        for logical in list(DEFAULT_RULES) + ["unknown_axis", None]:
            assert port.mesh_axes(logical) == ref.mesh_axes(logical)
    assert Rules() == Rules.make({}) and hash(Rules()) == hash(Rules.make())
    assert Rules.make({"seq": "model"}) != Rules()
    with pytest.raises(AttributeError, match="immutable"):
        Rules().x = 1


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("ov", range(len(OVERRIDES)))
def test_spec_for_matches_the_reference(mesh, ov):
    m = MESHES[mesh]
    port, ref = Rules.make(OVERRIDES[ov]), jshard.Rules.make(OVERRIDES[ov])
    for axes in AXES:
        got = spec_for(axes, m, port)
        assert got == _jax_entries(jshard.spec_for(axes, m, ref)), axes
        assert all(e is None or isinstance(e, tuple) for e in got)


def test_batch_axes_and_replication_follow_the_contract():
    """README: ``batch_axes_for`` is the DP spec of a batch dim that divides
    the DP product, ``(None,)`` otherwise; ``shard_put`` replicates a
    ``batch`` dim, or any sharded dim, that does not divide its mesh
    product, with no error."""
    m2, m3 = MESHES["2d"], MESHES["3d"]
    assert batch_axes_for(8, m2, Rules()) == (("data",),)
    assert batch_axes_for(3, m2, Rules()) == (None,)
    assert batch_axes_for(8, m3, Rules()) == (("pod", "data"),)
    assert batch_axes_for(6, m3, Rules()) == (None,)           # 6 % 4
    assert batch_axes_for(8, MESHES["1d"], Rules()) == (None,)  # no DP axis
    assert degraded_spec((4, 8, 3), ("batch", "heads", None), m2,
                         Rules()) == (("data",), ("model",), None)
    assert degraded_spec((3, 8, 3), ("batch", "heads", None), m2,
                         Rules()) == (None, ("model",), None)
    assert degraded_spec((4, 6), ("batch", "mlp"), m2,
                         Rules()) == (("data",), None)
    with pytest.raises(ValueError, match="axes for rank"):
        degraded_spec((4,), ("batch", None), m2, Rules())


def _pdefs(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pdefs(tree[k], path + (k,))
    else:
        yield path, tree


TEMPLATED = sorted(ARCH_IDS + PAPER_IDS)


@pytest.mark.parametrize("arch", TEMPLATED)
def test_template_axes_match_the_reference(arch):
    port = dict(_pdefs(get_model(smoke_config(arch)).template()))
    ref = dict(_pdefs(jget_model(jsmoke(arch)).template()))
    assert port.keys() == ref.keys()
    for path, p in port.items():
        assert (p.shape, p.axes) == (tuple(ref[path].shape),
                                     tuple(ref[path].axes)), path


def test_param_specs_resolve_every_leaf():
    tmpl = get_model(smoke_config("granite_moe_3b_a800m")).template()
    specs = param_specs(tmpl, MESHES["2d"], Rules())
    assert specs["layers"]["attn"]["wq"] == (None, ("data",), ("model",),
                                             None)
    assert specs["layers"]["moe"]["wi"] == (None, ("model",), ("data",),
                                            None, None)
    assert specs["embed"] == (("model",), ("data",))
    with pytest.raises(ValueError, match="axes"):
        PDef((2, 3), ("heads",))


STATE_CASES = {
    "dense_contiguous": ("stablelm_12b", {}),
    "dense_paged": ("stablelm_12b", {"page_size": 4}),
    "ssm": ("mamba2_130m", {}),
    "hybrid_ring": ("hymba_15b", {"max_len": 48}),
    "hybrid_paged": ("hymba_15b", {"page_size": 4}),
}


@pytest.mark.parametrize("case", list(STATE_CASES))
def test_state_axes_match_the_reference(case):
    arch, kw = STATE_CASES[case]
    kw = {"max_len": 32, "n_slots": 2, **kw}
    jmodel = jget_model(jsmoke(arch).replace(attn_impl="xla"))
    jeng = JServeEngine(jmodel, jinit(jmodel.template(),
                                      jax.random.PRNGKey(0)), **kw)
    cfg = smoke_config(arch)
    eng = ServeEngine(get_model(cfg), init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), device="cpu",
        **kw)
    assert eng.backend.paged == jeng.backend.paged
    assert eng.backend._state_axes() == jeng.backend._state_axes()
    assert not check_state_axes(eng.backend._state_axes(), Rules(),
                                program=case)


def test_serve_rules_replicate_what_does_not_split():
    """granite SMOKE: 5 experts do not split over 2 ranks, so ``expert``
    replicates for every leaf; 3 slots do not split over 2 data ranks;
    kv heads that do not split take the q heads with them."""
    tmpl = get_model(smoke_config("granite_moe_3b_a800m")).template()
    rules = serve_rules(tmpl, DuckMesh(data=2, model=2), Rules(), 3)
    assert rules.mesh_axes("expert") is None
    assert rules.mesh_axes("batch") is None
    assert rules.mesh_axes("heads") == ("model",)
    assert rules.mesh_axes("vocab") == ("model",)
    rules = serve_rules(tmpl, DuckMesh(data=1, model=4), Rules(), 4)
    assert rules.mesh_axes("kv_heads") is None     # 2 kv heads, 4 ranks
    assert rules.mesh_axes("heads") is None
    assert rules.mesh_axes("batch") == ("pod", "data")


def test_placements_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    class Names:
        mesh_dim_names = ("pod", "data", "model")
    got = placements_for((("pod", "data"), None, ("model",)), Names())
    assert got == (Shard(0), Shard(0), Shard(2))
    assert placements_for((None,), Names()) == (Replicate(),) * 3


def test_mesh_context_nests():
    assert get_active_mesh() is None
    with use_mesh_rules("outer", Rules()):
        with use_mesh_rules("inner", Rules.make({"seq": "model"})):
            assert get_active_mesh()[0] == "inner"
        assert get_active_mesh()[0] == "outer"
    assert get_active_mesh() is None


def test_production_mesh_shape_check(monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(dist, "get_world_size", lambda: 12)
    with pytest.raises(ValueError, match="8-card nodes"):
        tmesh.make_production_mesh()
    monkeypatch.setattr(dist, "get_world_size", lambda: 24)
    with pytest.raises(ValueError, match="2 pod"):
        tmesh.make_production_mesh(multi_pod=True)


def test_mesh_rules_on_handmade_inputs():
    m = MESHES["2d"]
    assert check_state_axes({"k": ("layers", "kv_head")}, Rules(),
                            program="p")[0].rule == "state-axes-vocab"
    shapes = {"length": (3,), "pages_k": (2, 6, 8, 4, 16)}
    axes = {"length": ("batch",),
            "pages_k": ("layers", "kv_heads", None, None, None)}
    assert shard_degradations(shapes, axes, m, Rules()) == [
        ("length", 0, "batch"), ("pages_k", 1, "kv_heads")]
    found = check_shard_divisibility(shapes, axes, m, Rules(), program="p")
    assert [f.rule for f in found] == ["shard-divisibility"]
    assert "pages_k" in found[0].message
    assert not check_collectives({"all_reduce": 3}, program="p",
                                 expect_all=("all_reduce",))
    assert len(check_collectives({}, program="p",
                                 expect_all=("all_reduce",))) == 2
    assert check_collectives({"all_reduce": 1}, program="p",
                             forbid=("all_reduce",))[0].rule == \
        "mesh-collectives"


def test_unsharded_engine_makes_no_dtensor_nor_collective():
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    cfg = smoke_config("stablelm_12b")
    eng = ServeEngine(get_model(cfg), init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), max_len=32,
        n_slots=2, page_size=4, prefill_chunk=4, device="cpu")
    rng = np.random.default_rng(0)
    with CommDebugMode() as comm:
        rids = [eng.submit(rng.integers(0, cfg.vocab, (n,)).astype(np.int32),
                           4) for n in (5, 9, 3)]
        eng.run()
    assert comm.get_total_counts() == 0
    assert all(eng.result(r).status == "OK" for r in rids)
    assert eng.backend.dparams is None and eng.backend.mesh is None
    leaves = tree_leaves(eng.backend.params) + list(
        eng.backend._cache.values())
    assert not any(isinstance(t, DTensor) for t in leaves)


def test_pairformer_engine_refuses_a_mesh():
    cfg = smoke_config("pairformer_lite")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="mesh sharding are token-backend"):
        ServeEngine(get_model(cfg), params, max_len=16, n_slots=2,
                    device="cpu", mesh=object())

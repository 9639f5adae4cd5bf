"""The port's cost model arithmetic against the JAX package's:

- the shape registry (``SHAPES``, ``PAPER_IDS``, ``list_archs``,
  ``cells``) equal to ``repro.configs.base``'s, the port's own 14-id
  ``ARCH_IDS`` kept for ``get_config``;
- ``active_params``, ``model_flops``, ``attention_kernel_flops`` and
  ``attention_kv_reread_bytes`` equal to ``repro.analysis.roofline``'s,
  float for float, on the 14 configs (the reference's ``ARCH_IDS`` and
  ``PAPER_IDS``) x the 4 shapes, the attention terms over ``n_data`` in
  {1, 2, 16} x ``n_model`` in {1, 8, 16};
- ``_wire_bytes`` on 5 ops x group sizes {1, 2, 8, 16}, and
  ``collective_bytes`` on records against it;
- ``roofline_report(..., chip=spec)`` equal to the reference's report key
  for key where ``spec`` is built at test time from ``repro.hw.TPU_V5E``'s
  fields (the port's source holds no TPU figure), and the H100's split of
  the collective term by mesh axis;
- ``hw.H100_SXM`` at its data-sheet figures, and ``make_production_mesh``
  on a fake process group: ``(32, 8)`` and ``(2, 32, 8)`` with their axis
  names.
"""
import dataclasses

import pytest

from repro import hw as jhw
from repro.analysis import roofline as jroof
from repro.configs import base as jbase
from repro_torch.analysis import roofline as troof
from repro_torch.configs import base as tbase
from repro_torch.hw import H100_SXM, ChipSpec

CONFIGS = jbase.ARCH_IDS + jbase.PAPER_IDS


def test_shape_registry_equals_reference():
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert tbase.PAPER_IDS == jbase.PAPER_IDS
    assert tbase.REFERENCE_ARCH_IDS == jbase.ARCH_IDS
    assert tbase.list_archs() == jbase.list_archs()
    assert tbase.list_archs(True) == jbase.list_archs(True)
    assert tbase.cells() == jbase.cells()
    # the port's registry still loads every config it serves
    assert set(tbase.list_archs(True)) == set(tbase.ARCH_IDS)


@pytest.mark.parametrize("arch", CONFIGS)
def test_model_flops_equal_reference(arch):
    cfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    assert troof.active_params(cfg) == jroof.active_params(jcfg)
    for name in tbase.SHAPES:
        assert troof.model_flops(cfg, tbase.SHAPES[name]) == \
            jroof.model_flops(jcfg, jbase.SHAPES[name])


@pytest.mark.parametrize("arch", CONFIGS)
def test_attention_terms_equal_reference(arch):
    cfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    for name in tbase.SHAPES:
        s, js = tbase.SHAPES[name], jbase.SHAPES[name]
        for n_data in (1, 2, 16):
            assert troof.attention_kv_reread_bytes(cfg, s, n_data) == \
                jroof.attention_kv_reread_bytes(jcfg, js, n_data)
            assert troof.attention_kv_reread_bytes(cfg, s, n_data,
                                                   block=64) == \
                jroof.attention_kv_reread_bytes(jcfg, js, n_data, block=64)
            for n_model in (1, 8, 16):
                assert troof.attention_kernel_flops(
                    cfg, s, n_data, n_model) == \
                    jroof.attention_kernel_flops(jcfg, js, n_data, n_model)


@pytest.mark.parametrize("op", ["all-gather", "all-reduce", "reduce-scatter",
                                "all-to-all", "collective-permute"])
def test_wire_bytes_equal_reference(op):
    for g in (1, 2, 8, 16):
        for rb in (0, 4096, 3 * 10**9 + 7):
            assert troof._wire_bytes(op, rb, g) == jroof._wire_bytes(op, rb,
                                                                     g)


def test_collective_bytes_from_records():
    recs = [("all-gather", 1000, 8, ("model",)),
            ("all-reduce", 400, 8, ("model",)),
            ("reduce-scatter", 100, 32, ("data",)),
            ("all-gather", 1000, 64, ("pod", "data")),
            ("all-reduce", 50, 1, None)]
    out = troof.collective_bytes(recs)
    want = [jroof._wire_bytes(op, rb, g) for op, rb, g, _ in recs]
    assert out["all-gather"] == want[0] + want[3]
    assert out["total"] == sum(want)
    assert out["counts"] == {"all-gather": 2, "all-reduce": 2,
                             "reduce-scatter": 1, "all-to-all": 0,
                             "collective-permute": 0}
    assert out["by_axis"] == {"model": want[0] + want[1], "data": want[2],
                              "pod,data": want[3], "": want[4]}


def _tpu_spec() -> ChipSpec:
    t = jhw.TPU_V5E
    return ChipSpec(name=t.name, peak_flops_bf16=t.peak_flops_bf16,
                    hbm_bandwidth=t.hbm_bandwidth, hbm_bytes=t.hbm_bytes,
                    nvlink_bandwidth=t.ici_link_bandwidth,
                    network_bandwidth=t.ici_link_bandwidth,
                    smem_per_sm=t.vmem_bytes, n_sms=1)


@pytest.mark.parametrize("arch,shape", [
    ("command_r_plus_104b", "train_4k"), ("mamba2_130m", "decode_32k"),
    ("hymba_15b", "long_500k"), ("gpt2_alibi_15b", "prefill_32k")])
@pytest.mark.parametrize("adjusted", [False, True])
def test_roofline_report_equals_reference(arch, shape, adjusted):
    kw = dict(flops_per_device=3.1e14, bytes_per_device=7.7e11,
              coll_bytes_per_device=2.5e10, n_devices=256,
              coll_detail={"all-gather": 1.0})
    if adjusted:
        kw.update(adjusted_bytes_per_device=1.3e11,
                  adjusted_flops_per_device=2.2e14)
    got = troof.roofline_report(cfg=tbase.get_config(arch),
                                shape=tbase.SHAPES[shape], chip=_tpu_spec(),
                                **kw)
    want = jroof.roofline_report(cfg=jbase.get_config(arch),
                                 shape=jbase.SHAPES[shape], **kw)
    assert {k: got[k] for k in want} == want
    # split by axis on equal links: the same collective term
    split = troof.roofline_report(
        cfg=tbase.get_config(arch), shape=tbase.SHAPES[shape],
        chip=_tpu_spec(), coll_bytes_by_axis={"model": 2.5e10}, **kw)
    assert split["collective_s"] == want["collective_s"]


def test_h100_spec_and_link_split():
    assert (H100_SXM.peak_flops_bf16, H100_SXM.hbm_bandwidth,
            H100_SXM.hbm_bytes, H100_SXM.smem_per_sm, H100_SXM.n_sms) == \
        (989e12, 3.35e12, 80 * 10**9, 228 * 1024, 132)
    assert H100_SXM.arithmetic_intensity_knee == 989e12 / 3.35e12
    assert H100_SXM.link_bandwidth(("model",)) == 450e9
    for axes in (("data",), ("pod", "data"), ("data", "model"), ()):
        assert H100_SXM.link_bandwidth(axes) == 50e9
    rep = troof.roofline_report(
        flops_per_device=1e12, bytes_per_device=1e9,
        coll_bytes_per_device=3e9, cfg=tbase.get_config("stablelm_12b"),
        shape=tbase.SHAPES["train_4k"], n_devices=256,
        coll_bytes_by_axis={"model": 1e9, "data": 2e9})
    assert rep["collective_s"] == 1e9 / 450e9 + 2e9 / 50e9
    assert rep["collective_s_by_axis"] == {"model": 1e9 / 450e9,
                                           "data": 2e9 / 50e9}
    assert rep["chip"] == "h100-sxm"


@pytest.fixture
def fake_world():
    from repro_torch.launch import dryrun
    yield dryrun.fake_world
    dryrun.release_world()


def test_production_mesh_on_a_fake_group(fake_world):
    from repro_torch.launch.mesh import make_production_mesh
    fake_world(256)
    mesh = make_production_mesh(device_type="cpu")
    assert (tuple(mesh.shape), mesh.mesh_dim_names) == ((32, 8),
                                                        ("data", "model"))
    assert mesh.device_type == "cpu"
    fake_world(512)
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    assert (tuple(mesh.shape), mesh.mesh_dim_names) == (
        (2, 32, 8), ("pod", "data", "model"))

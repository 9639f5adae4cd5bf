"""Batched Pairformer serving in the port, on the CPU: a mirror of
``tests/test_pair_serve.py`` held to the reference engine.

A request is one complex, admission caches its pair-bias factors per slot,
every step is one refinement iteration over the padded slot batch. The
contracts under test:

- the port's engine gives the reference engine's results on the same
  staggered schedule, at float32 tolerance (``rtol = atol = 1e-5``; the
  two packages sum in different orders and take their SVDs from different
  LAPACKs);
- batched == alone BITWISE at the same slot count: per-slot computation is
  batch-row independent and padding is pinned at ``max_len``. Across slot
  counts the batch shapes differ, so CPU kernels may sum in another order:
  there the results agree at tolerance only (the reference's own
  batched == solo tests assert bitwise equality across slot counts and
  fail by ~1.5e-7 on this JAX; the port does not copy that assertion);
- the factor cache is admission-frozen; the cached-dense and recompute
  dataflows are the same math; full-rank SVD reproduces dense serving;
- priority classes order admission and pick preemption victims.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import get_model as ref_get_model
from repro.models import pairformer as ref_pf
from repro.models.common import init_params as ref_init_params
from repro.models.common import stack_layers as ref_stack_layers
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import smoke_config
from repro_torch.interop import factors_from_numpy, params_from_numpy
from repro_torch.models import get_model
from repro_torch.serve import (
    FAILED,
    OK,
    FIFOScheduler,
    PairBatchBackend,
    Request,
    ServeEngine,
)
from repro_torch.serve.lifecycle import AdmissionRejected

MAX_LEN = 16      # pinned residue padding
TOL = {"rtol": 1e-5, "atol": 1e-5}
HIDDEN = 16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _models(**overrides):
    """(reference model, reference params, port model, port params)."""
    rcfg = ref_smoke_config("pairformer_lite").replace(**overrides)
    tcfg = smoke_config("pairformer_lite").replace(**overrides)
    rmodel = ref_get_model(rcfg)
    rp = ref_init_params(rmodel.template(), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, rp), tcfg, device="cpu")
    return rmodel, rp, get_model(tcfg), tp


def _factors(cfg_ref, cfg_port):
    rf = ref_init_params(ref_stack_layers(
        ref_pf.factor_mlp_template(cfg_ref, hidden=HIDDEN),
        cfg_ref.n_layers), jax.random.PRNGKey(5))
    rf = jax.tree.map(lambda x: 5.0 * x, rf)     # a bias the test can see
    return rf, factors_from_numpy(jax.tree.map(np.asarray, rf), cfg_port,
                                  HIDDEN, device="cpu")


def _complexes(lens, f=64, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((n, f)).astype(np.float32) for n in lens]


def _engine(model, params, n_slots, **kw):
    return ServeEngine(model, params, max_len=MAX_LEN, n_slots=n_slots,
                       device="cpu", **kw)


def _alone(model, params, feats, budget, n_slots=1, **kw):
    eng = _engine(model, params, n_slots, **kw)
    rid = eng.submit(feats, budget)
    eng.run()
    return eng.result(rid)


COMPLEXES = (12, 7, 16, 9, 5)
BUDGETS = [3, 5, 2, 4, 3]


def _staggered(eng, complexes):
    """5 variable-length complexes through the engine's slots, arriving
    mid-flight and finishing at different steps (budgets differ)."""
    rids = [eng.submit(complexes[0], BUDGETS[0]),
            eng.submit(complexes[1], BUDGETS[1])]
    eng.step()
    rids.append(eng.submit(complexes[2], BUDGETS[2]))
    eng.step()
    rids += [eng.submit(complexes[3], BUDGETS[3]),
             eng.submit(complexes[4], BUDGETS[4])]
    eng.run()
    return rids


@pytest.mark.parametrize("mode", ["svd", "mlp"])
def test_engine_matches_reference_engine(mode):
    """The port's engine against the reference's on the same staggered
    schedule, in SVD mode and in factor-MLP mode."""
    rmodel, rp, tmodel, tp = _models()
    kw_r = kw_t = {}
    if mode == "mlp":
        rf, tf = _factors(rmodel.cfg, tmodel.cfg)
        kw_r, kw_t = {"factors": rf}, {"factors": tf}
    complexes = _complexes(COMPLEXES)
    ref = RefEngine(rmodel, rp, max_len=MAX_LEN, n_slots=2, **kw_r)
    port = _engine(tmodel, tp, 2, **kw_t)
    rids_r = _staggered(ref, complexes)
    rids_t = _staggered(port, complexes)
    assert port.occupancy == 0 and port.page_stats() == {}
    assert port.stats()["prefill_waves"] >= 3
    for c, rr, rt in zip(complexes, rids_r, rids_t):
        got, want = port.result(rt), ref.result(rr)
        assert got.status == want.status == OK
        assert got.shape == want.shape == (c.shape[0], tmodel.cfg.d_model)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", ["svd", "mlp"])
def test_batched_matches_alone_at_same_slot_count(mode):
    """Every result of the staggered batch is bit-equal to the same complex
    served alone through an engine with the same number of slots."""
    rmodel, _, tmodel, tp = _models()
    kw = {}
    if mode == "mlp":
        kw["factors"] = _factors(rmodel.cfg, tmodel.cfg)[1]
    complexes = _complexes(COMPLEXES)
    eng = _engine(tmodel, tp, 2, **kw)
    rids = _staggered(eng, complexes)
    for i, rid in enumerate(rids):
        assert eng.is_done(rid)
        np.testing.assert_array_equal(
            eng.result(rid),
            _alone(tmodel, tp, complexes[i], BUDGETS[i], n_slots=2, **kw))


def test_reference_batched_matches_alone_at_same_slot_count():
    """The reference engine keeps the same-slot-count contract bitwise too:
    its own batched == solo tests compare a 2-slot batch with 1-slot solo
    runs, and differ there by float32 summation order only."""
    rmodel, rp, _, _ = _models()
    complexes = _complexes(COMPLEXES)
    eng = RefEngine(rmodel, rp, max_len=MAX_LEN, n_slots=2)
    rids = _staggered(eng, complexes)
    for i in (0, 2):
        solo = RefEngine(rmodel, rp, max_len=MAX_LEN, n_slots=2)
        rid = solo.submit(complexes[i], BUDGETS[i])
        solo.run()
        np.testing.assert_array_equal(eng.result(rids[i]), solo.result(rid))


def test_batched_matches_alone_across_slot_counts_at_tolerance():
    """Across slot counts (2 against 1) the batch shapes differ: equal at
    float32 tolerance, not bitwise."""
    _, _, tmodel, tp = _models()
    complexes = _complexes(COMPLEXES)
    eng = _engine(tmodel, tp, 2)
    rids = _staggered(eng, complexes)
    for i, rid in enumerate(rids):
        np.testing.assert_allclose(
            eng.result(rid),
            _alone(tmodel, tp, complexes[i], BUDGETS[i], n_slots=1), **TOL)


def test_result_returns_the_float_single_rep():
    """``result`` hands back the backend's float32 (n_res, d_model) array,
    not int32 ids: a pair result is not truncated."""
    _, _, tmodel, tp = _models()
    feats = _complexes((9,), seed=2)[0]
    eng = _engine(tmodel, tp, 2)
    rid = eng.submit(feats, 2)
    eng.run()
    got = eng.result(rid)
    assert got.dtype == np.float32 and got.status == OK
    assert got.shape == (9, tmodel.cfg.d_model)
    assert not np.array_equal(got, np.round(got))      # not integers
    np.testing.assert_array_equal(
        got, eng.backend._cache["s"][0, :9].numpy())


def test_factor_cache_frozen_across_steps():
    """Admission writes the per-layer SVD factors once; refinement steps
    reuse them bitwise-untouched while the single rep advances."""
    _, _, tmodel, tp = _models()
    eng = _engine(tmodel, tp, 2)
    for c in _complexes((11, 8)):
        eng.submit(c, 6)
    eng.admit()
    cache = eng.backend._cache
    assert "phi_q" in cache and "phi_k" in cache      # svd factor mode
    phi_q0, phi_k0 = cache["phi_q"].clone(), cache["phi_k"].clone()
    s_prev = cache["s"].clone()
    for _ in range(3):
        eng.decode()
        cache = eng.backend._cache
        assert torch.equal(cache["phi_q"], phi_q0)
        assert torch.equal(cache["phi_k"], phi_k0)
        assert torch.isfinite(cache["s"]).all()
        assert not torch.equal(cache["s"], s_prev)    # rep is refined
        s_prev = cache["s"].clone()


def test_dense_cached_and_recompute_paths_agree():
    """``bias_mode="dense"`` (bias cached at admission) and
    ``"dense_recompute"`` (z cached, bias re-projected per step) are the
    same math in a different place."""
    _, _, model_c, tp = _models(bias_mode="dense")
    _, _, model_r, _ = _models(bias_mode="dense_recompute")
    feats = _complexes((13,), seed=3)[0]
    got_c = _alone(model_c, tp, feats, 4)
    got_r = _alone(model_r, tp, feats, 4)
    np.testing.assert_array_equal(got_c, got_r)


def test_full_rank_svd_matches_dense_serve():
    """Sec. 4.3: with rank >= n_res the truncated SVD is exact, so the
    factored serve path reproduces the dense-bias serve path."""
    _, _, model_f, tp = _models()                     # svd, bias_rank=8
    _, _, model_d, _ = _models(bias_mode="dense")
    feats = _complexes((7,), seed=4)[0]               # n_res 7 < rank 8
    np.testing.assert_allclose(_alone(model_f, tp, feats, 3),
                               _alone(model_d, tp, feats, 3), atol=1e-4)


def test_factor_mlp_cache_serves_batched():
    """Eq. 5 factor-MLP mode: the factor MLPs ride ``factors=`` into the
    engine (carried across with ``factors_from_numpy``); the cache holds
    factors at the full configured rank."""
    rmodel, _, tmodel, tp = _models()
    _, tf = _factors(rmodel.cfg, tmodel.cfg)
    complexes = _complexes((10, 6), seed=6)
    eng = _engine(tmodel, tp, 2, factors=tf)
    rids = [eng.submit(c, 3) for c in complexes]
    eng.run()
    assert eng.backend._cache["phi_q"].shape[-1] == tmodel.cfg.bias_rank
    for c, rid in zip(complexes, rids):
        np.testing.assert_array_equal(
            eng.result(rid), _alone(tmodel, tp, c, 3, n_slots=2, factors=tf))


def test_pair_request_validation():
    _, _, tmodel, tp = _models()
    eng = _engine(tmodel, tp, 2)
    with pytest.raises(AdmissionRejected):           # int prompt payload
        eng.submit(np.arange(5, dtype=np.int32), 3)
    with pytest.raises(AdmissionRejected):           # exceeds max_len
        eng.submit(np.zeros((MAX_LEN + 1, 64), np.float32), 3)
    with pytest.raises(TypeError):                   # token-emitting API
        eng.generate([np.zeros((4, 64), np.float32)], 3)
    assert isinstance(eng.backend, PairBatchBackend)


def test_on_token_streams_per_refinement_step():
    """The pair backend emits no tokens, so ``submit(on_token=...)`` gets
    the per-step (n_res, d_model) state instead: one callback per
    refinement iteration, and the final state IS the result."""
    _, _, tmodel, tp = _models()
    feats = _complexes((9,), seed=9)[0]
    eng = _engine(tmodel, tp, 1)
    steps = []
    rid = eng.submit(feats, 4, on_token=steps.append)
    eng.run()
    assert len(steps) == 4                            # one per iteration
    assert all(s.shape == (9, tmodel.cfg.d_model) for s in steps)
    assert not np.array_equal(steps[0], steps[-1])    # rep is refined
    np.testing.assert_array_equal(steps[-1], eng.result(rid))


@pytest.mark.parametrize("n_slots", [2, 3])
def test_admission_guard_matches_reference(n_slots):
    """A complex whose features are not finite trips the admission guard
    and ends FAILED after its retry, with the reference engine's statuses
    and quarantine count. The guard checks the leaves the reference's
    does: floating leaves whose leading axis has ``n_slots`` entries. At
    3 slots that is the single rep alone, and the wave-mate ends OK; at 2
    slots (= the 2 layers of SMOKE) the layer-major factor caches are
    checked too, per LAYER, so the NaN row flags its wave-mate as well."""
    rmodel, rp, tmodel, tp = _models()
    good, bad = _complexes((8, 6), seed=10)
    bad = bad.copy()
    bad[2, 5] = np.nan
    seen = []
    for eng in (RefEngine(rmodel, rp, max_len=MAX_LEN, n_slots=n_slots),
                _engine(tmodel, tp, n_slots)):
        rids = [eng.submit(good, 3), eng.submit(bad, 3)]
        eng.run()
        seen.append(([eng.result(r).status for r in rids],
                     eng.n_quarantines))
    assert seen[0] == seen[1]
    assert seen[1][0][1] == FAILED
    if n_slots == 3:
        assert seen[1] == ([OK, FAILED], 2)


def test_priority_classes_order_admission():
    """Higher class admits first regardless of arrival; within a class the
    policy is FIFO — and with all-default priorities plain FIFO."""
    sched = FIFOScheduler()
    feats = np.zeros((4, 8), np.float32)
    for rid, pri in enumerate((0, 5, 0, 5, -1)):
        sched.add(Request(rid, feats, 1, priority=pri))
    assert [r.rid for r in sched.take(5)] == [1, 3, 0, 2, 4]

    sched = FIFOScheduler()                           # all-default: FIFO
    for rid in range(4):
        sched.add(Request(rid, feats, 1))
    assert [r.rid for r in sched.take(4)] == [0, 1, 2, 3]

    sched = FIFOScheduler(policy="spf")               # class outranks length
    sched.add(Request(0, np.zeros((2, 8), np.float32), 1, priority=0))
    sched.add(Request(1, np.zeros((9, 8), np.float32), 1, priority=1))
    sched.add(Request(2, np.zeros((4, 8), np.float32), 1, priority=1))
    assert [r.rid for r in sched.take(3)] == [2, 1, 0]


def test_add_front_orders_resumed_requests_by_class():
    """Preempted requests resume ahead of every arrival; within the front
    queue higher classes stay ahead and earlier rids break ties."""
    sched = FIFOScheduler()
    feats = np.zeros((4, 8), np.float32)
    sched.add(Request(9, feats, 1, priority=7))       # queued arrival
    sched.add_front(Request(2, feats, 1, priority=0))
    sched.add_front(Request(1, feats, 1, priority=3))
    sched.add_front(Request(3, feats, 1, priority=3))
    assert [r.rid for r in sched.take(4)] == [1, 3, 2, 9]


def test_preemption_victim_is_lowest_class_then_latest():
    """The engine evicts the lowest class first, latest arrival within it;
    the preempted complex restarts with its full budget and its final
    result still matches the alone run at the same slot count."""
    _, _, tmodel, tp = _models()
    complexes = _complexes((9, 11, 6), seed=7)
    eng = _engine(tmodel, tp, 3)
    rids = [eng.submit(c, 4, priority=p)
            for c, p in zip(complexes, (2, 0, 1))]
    eng.admit()
    eng.decode()
    assert eng.preempt() == rids[1]                   # class 0 evicts first
    assert eng.preempt() == rids[2]                   # then class 1
    assert eng.n_preemptions == 2 and eng.occupancy == 1
    eng.run()
    for c, rid in zip(complexes, rids):
        np.testing.assert_array_equal(eng.result(rid),
                                      _alone(tmodel, tp, c, 4, n_slots=3))


def test_default_priority_victim_matches_pre_class_engine():
    """All-default priorities: the victim is the latest-arrived live
    request."""
    _, _, tmodel, tp = _models()
    eng = _engine(tmodel, tp, 2)
    rids = [eng.submit(c, 3) for c in _complexes((8, 5), seed=8)]
    eng.admit()
    assert eng.preempt() == rids[1]

"""The port's Pairformer serve path against the JAX reference, on the CPU.

Parameters come from the reference's ``init_params`` and cross as numpy
arrays; inputs are made with numpy from a seed. At ``SMOKE`` (float32) every
piece is held to its reference twin at ``rtol = atol = 1e-5`` (summation
order only), except where a test states otherwise. SVD factors are unique
only up to sign (and rotation inside near-tied singular values), so they
are compared through their product ``phi_q @ phi_k^T``.

A ``SMOKE.replace(dtype="bfloat16")`` case holds the dtype promotion rules
(``s`` in bf16, ``z`` promoted to float32 by the first triangle update, the
factor-MLP inputs in float32, the ``"pair"`` cache in bf16). The
reference's ``serve_prefill`` cannot run at bfloat16 (its ``lax.scan``
rejects the carry whose ``z`` turns float32), so that case unrolls the
reference's own layer functions in a Python loop.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.core import decomp as ref_decomp
from repro.models import common as ref_common
from repro.models import get_model as ref_get_model
from repro.models import pairformer as ref_pf
from repro_torch.configs import smoke_config
from repro_torch.core.decomp import svd_factors
from repro_torch.interop import factors_from_numpy, params_from_numpy
from repro_torch.models import common as tcommon
from repro_torch.models import get_model
from repro_torch.models import pairformer as tpf
from repro_torch.models.common import PDef

TOL = {"rtol": 1e-5, "atol": 1e-5}
MAX_LEN = 16
LENGTHS = [12, 7, 0]          # a row past the SVD rank, one under it, padding
MODES = {"svd": "flashbias", "mlp": "flashbias", "dense": "dense",
         "pair": "dense_recompute"}
HIDDEN = 16


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(mode="svd", dtype=None):
    """(ref cfg, port cfg, ref params, port params, ref factors or None,
    port factors or None) for a serve mode."""
    over = {"bias_mode": MODES[mode]}
    if dtype:
        over["dtype"] = dtype
    rcfg = ref_smoke_config("pairformer_lite").replace(**over)
    tcfg = smoke_config("pairformer_lite").replace(**over)
    rp = ref_common.init_params(ref_get_model(rcfg).template(),
                                jax.random.PRNGKey(0))
    tp = params_from_numpy(_np(rp), tcfg, device="cpu")
    rf = tf = None
    if mode == "mlp":
        rf = ref_common.init_params(ref_common.stack_layers(
            ref_pf.factor_mlp_template(rcfg, hidden=HIDDEN), rcfg.n_layers),
            jax.random.PRNGKey(5))
        # random factor MLPs with 0.02 weights give a near-zero bias: scale
        # them so the factor cache carries a bias the test can see, while
        # each layer's gain stays near 1 (sqrt(fan_in) * 0.1), so a bf16
        # ulp of the inputs is not amplified into many in the factors
        rf = jax.tree.map(lambda x: 5.0 * x, rf)
        tf = factors_from_numpy(_np(rf), tcfg, HIDDEN, device="cpu")
    return rcfg, tcfg, rp, tp, rf, tf


def _feats(lengths, seed=1, n=MAX_LEN):
    rng = np.random.default_rng(seed)
    feats = np.zeros((len(lengths), n, 64), np.float32)
    for i, m in enumerate(lengths):
        feats[i, :m] = rng.standard_normal((m, 64))
    return feats


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _layer0(tree):
    return jax.tree.map(lambda x: x[0], tree)


def _product(cache, key_q="phi_q", key_k="phi_k"):
    return np.einsum("lbnhr,lbmhr->lbhnm", np.asarray(cache[key_q]),
                     np.asarray(cache[key_k]))


def _swap_factor_axes(cache):
    """A torch cache with the factors' head and residue axes swapped: the
    port keeps ``phi_q``/``phi_k`` head-major ``(L, B, H, N, R)``, the
    reference residue-major ``(L, B, N, H, R)``; the swap maps either to
    the other."""
    return {k: (v.transpose(2, 3).contiguous() if k in ("phi_q", "phi_k")
                else v) for k, v in cache.items()}


def test_templates_match_reference():
    rcfg, tcfg = (ref_smoke_config("pairformer_lite"),
                  smoke_config("pairformer_lite"))
    for ref_t, port_t in (
            (ref_pf.pairformer_template(rcfg), tpf.pairformer_template(tcfg)),
            (ref_pf.factor_mlp_template(rcfg, 24),
             tpf.factor_mlp_template(tcfg, 24))):
        want = jax.tree.map(lambda p: p.shape, ref_t,
                            is_leaf=ref_common.is_pdef)
        got = tcommon.tree_map(lambda p: p.shape, port_t)
        assert got == want
        inits = jax.tree.map(lambda p: p.init, ref_t,
                             is_leaf=ref_common.is_pdef)
        assert tcommon.tree_map(lambda p: p.init, port_t) == inits
    assert isinstance(tpf.pairformer_template(tcfg)["single_in"], PDef)


def test_layer_functions_match_reference():
    """_triangle_update, _pair_bias, _factor_inputs, _factor_apply and
    gelu_mlp (tanh approximation) on the same float32 inputs."""
    rcfg, tcfg, rp, tp, rf, tf = _setup("mlp")
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 9, 9, rcfg.d_pair)).astype(np.float32)
    s = rng.standard_normal((2, 9, rcfg.d_model)).astype(np.float32)
    rl, tl = _layer0(rp["layers"]), tcommon.tree_map(lambda x: x[0],
                                                     tp["layers"])
    zt, st = torch.from_numpy(z), torch.from_numpy(s)
    _close(tpf._triangle_update(tl, zt), ref_pf._triangle_update(rl, z))
    _close(tpf._pair_bias(tl, zt), ref_pf._pair_bias(rl, z, rcfg.n_heads))
    fx = ref_pf._factor_inputs(z, s)
    _close(tpf._factor_inputs(zt, st), fx)
    rfl, tfl = _layer0(rf), tcommon.tree_map(lambda x: x[0], tf)
    _close(tpf._factor_apply(tfl["q"], torch.from_numpy(np.array(fx)),
                             rcfg.n_heads, rcfg.bias_rank),
           ref_pf._factor_apply(rfl["q"], fx, rcfg.n_heads, rcfg.bias_rank))
    x = 3.0 * rng.standard_normal((5, 16)).astype(np.float32)
    wi = rng.standard_normal((16, 24)).astype(np.float32)
    wo = rng.standard_normal((24, 16)).astype(np.float32)
    _close(tcommon.gelu_mlp(*map(torch.from_numpy, (x, wi, wo))),
           ref_common.gelu_mlp(x, wi, wo), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rank", [3, 8])
def test_svd_factors_product_matches_reference(rank):
    """The rank-R product against the reference's. The gap between
    sigma_R and sigma_{R+1} of the input is asserted and reported: a
    near-tied cut would make the truncated product ill-defined, which would
    read as a port fault without it."""
    rng = np.random.default_rng(3)
    table = rng.standard_normal((2, 3, 12, 10)).astype(np.float32)
    sig = np.linalg.svd(table.astype(np.float64), compute_uv=False)
    gap = float((sig[..., rank - 1] - sig[..., rank]).min()
                / sig[..., 0].max())
    print(f"rank {rank}: min relative gap sigma_R - sigma_R+1 = {gap:.3f}")
    assert gap > 1e-2
    pq, pk = svd_factors(torch.from_numpy(table), rank)
    rq, rk = ref_decomp.svd_factors(jnp.asarray(table), rank=rank)
    assert pq.shape == rq.shape == (2, 3, 12, rank)
    assert pk.shape == rk.shape == (2, 3, 10, rank)
    got = (pq @ pk.transpose(-1, -2)).numpy()
    # two LAPACKs (jaxlib's and torch's) in float32: 1e-4
    _close(got, np.asarray(rq) @ np.swapaxes(np.asarray(rk), -1, -2),
           rtol=1e-4, atol=1e-4)
    full_q, full_k = svd_factors(torch.from_numpy(table), 99)   # R = 10
    _close(full_q @ full_k.transpose(-1, -2), table, rtol=1e-4, atol=1e-4)


def test_svd_factors_of_a_non_finite_matrix_are_nan():
    """A matrix with a NaN gets all-NaN factors, as the reference's SVD
    gives them (torch's would raise); the other matrices are untouched."""
    rng = np.random.default_rng(4)
    table = rng.standard_normal((3, 6, 6)).astype(np.float32)
    table[1, 2, 3] = np.nan
    pq, pk = svd_factors(torch.from_numpy(table), 4)
    rq, rk = ref_decomp.svd_factors(jnp.asarray(table), rank=4)
    for got, want in ((pq, rq), (pk, rk)):
        np.testing.assert_array_equal(np.isnan(got.numpy()),
                                      np.isnan(np.asarray(want)))
    assert torch.isnan(pq[1]).all() and torch.isfinite(pq[[0, 2]]).all()


def _ref_and_port_prefill(mode, lengths=LENGTHS, dtype=None):
    rcfg, tcfg, rp, tp, rf, tf = _setup(mode, dtype)
    feats = _feats(lengths)
    lens = np.asarray(lengths, np.int32)
    tmodel = get_model(tcfg)
    if dtype is None:
        _, rc = ref_get_model(rcfg).prefill(
            rp, {"feats": jnp.asarray(feats)}, max_len=MAX_LEN,
            lengths=jnp.asarray(lens), factors=rf)
    else:
        rc = _ref_prefill_unrolled(rp, feats, rcfg, lens, rf)
    _, tc = tmodel.prefill(tp, {"feats": torch.from_numpy(feats)},
                           lengths=torch.from_numpy(lens), factors=tf)
    return (rcfg, tcfg, rp, tp, rf, tf), rc, tc


def _compare_caches(mode, rc, tc, lengths, tol=None):
    tol = tol or TOL
    live = np.asarray(lengths) > 0
    tc = _swap_factor_axes(tc)
    assert set(rc) == set(tc)
    # rows of length 0: the reference's XLA attention returns the mean of
    # v there, the port 0; the engine drops such rows
    _close(tc["s"].float().numpy()[live], np.asarray(rc["s"], np.float32)[
        live], **tol)
    np.testing.assert_array_equal(tc["length"].numpy(), rc["length"])
    if mode == "svd":
        _close(_product(tc), _product(rc), **tol)
    elif mode == "mlp":
        for key in ("phi_q", "phi_k"):
            _close(tc[key][:, live].numpy(), np.asarray(rc[key])[:, live],
                   **tol)
    else:
        key = "bias" if mode == "dense" else "z"
        _close(tc[key].float().numpy(), np.asarray(rc[key], np.float32),
               **tol)


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_prefill_caches_match_reference(mode):
    """The admission trunk pass in all four cache modes: the single rep of
    every live row, and the bias state (SVD through its product)."""
    _, rc, tc = _ref_and_port_prefill(mode)
    for key, v in _swap_factor_axes(tc).items():
        assert tuple(v.shape) == tuple(rc[key].shape), key
    _compare_caches(mode, rc, tc, LENGTHS)
    if mode in ("svd", "mlp"):
        r = 8 if mode == "mlp" else min(8, MAX_LEN)
        assert tc["phi_q"].shape[-1] == r


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_step_matches_reference(mode):
    """Two refinement steps from the SAME cache (the reference's, carried
    across), so the step alone is compared; length-0 rows stay frozen."""
    (rcfg, tcfg, rp, tp, _, _), rc, _ = _ref_and_port_prefill(mode)
    tc = _swap_factor_axes({k: torch.from_numpy(np.array(v))
                            for k, v in rc.items()})
    rmodel, tmodel = ref_get_model(rcfg), get_model(tcfg)
    for _ in range(2):
        rc = rmodel.decode(rp, rc)
        tc = tmodel.decode(tp, tc)
        _close(tc["s"], rc["s"])
    tc = _swap_factor_axes(tc)
    for key in rc:
        if key != "s":
            np.testing.assert_array_equal(tc[key].numpy(), rc[key])


def test_insert_at_slots_drops_padding_rows():
    """Wave rows go to their slots; an out-of-range slot id (a padding row)
    is dropped on the host, as the reference's ``mode="drop"`` does."""
    (rcfg, tcfg, *_), rc, tc = _ref_and_port_prefill("svd")
    rdst = ref_pf.init_serve_cache(rcfg, 3, MAX_LEN)
    tdst = tpf.init_serve_cache(tcfg, 3, MAX_LEN, device="cpu")
    slots = np.array([2, 0, 3], np.int32)            # 3 is out of range
    rdst = ref_pf.insert_serve_cache_at_slots(rdst, rc, jnp.asarray(slots))
    tdst = tpf.insert_serve_cache_at_slots(tdst, tc, slots)
    np.testing.assert_array_equal(tdst["length"].numpy(), rdst["length"])
    assert tdst["length"].tolist() == [7, 0, 12]
    _close(tdst["s"][[0, 2]], np.asarray(rdst["s"])[[0, 2]])
    assert not tdst["s"][1].any() and not tdst["phi_q"][:, 1].any()
    _close(_product(_swap_factor_axes(tdst)), _product(rdst))
    same = tpf.insert_serve_cache_at_slots(tdst, tc, [5, 6, 7])
    assert same is tdst and same["length"].tolist() == [7, 0, 12]


# ---------------------------------------------------------------------------
# bfloat16: the dtype promotion rules
# ---------------------------------------------------------------------------

def _ref_prefill_unrolled(params, feats, cfg, lengths, factors):
    """The reference's ``serve_prefill`` body, built from its own layer
    functions in a Python loop: its ``lax.scan`` rejects the bf16 carry."""
    dt = jnp.dtype(cfg.dtype)
    mode = ref_pf._serve_mode(cfg, factors)
    n = feats.shape[1]
    lengths = jnp.asarray(lengths, jnp.int32)
    valid = jnp.arange(n)[None, :] < lengths[:, None]
    f = jnp.asarray(feats).astype(dt)
    s = jnp.where(valid[..., None],
                  jnp.einsum("bnf,fd->bnd", f,
                             params["single_in"].astype(dt)), 0)
    z = jnp.einsum("bnf,fc->bnc", f, params["pair_in"].astype(dt))
    z = z[:, :, None, :] + z[:, None, :, :]
    z = jnp.where((valid[:, :, None] & valid[:, None, :])[..., None], z, 0)
    states = []
    for i in range(cfg.n_layers):
        lp = jax.tree.map(lambda p: p[i], params["layers"])
        z = ref_pf._triangle_update(lp, z)
        if mode == "mlp":
            fl = jax.tree.map(lambda p: p[i], factors)
            fx = ref_pf._factor_inputs(
                z, ref_common.rmsnorm(s, lp["ln1"])).astype(jnp.float32)
            state = (ref_pf._factor_apply(fl["q"], fx, cfg.n_heads,
                                          cfg.bias_rank),
                     ref_pf._factor_apply(fl["k"], fx, cfg.n_heads,
                                          cfg.bias_rank))
        elif mode == "svd":
            bias = ref_pf._pair_bias(lp, z, cfg.n_heads).astype(jnp.float32)
            pq, pk = ref_decomp.svd_factors(
                bias, rank=ref_pf._serve_rank(cfg, n, mode))
            state = (pq.transpose(0, 2, 1, 3), pk.transpose(0, 2, 1, 3))
        elif mode == "pair":
            state = z
        else:
            state = ref_pf._pair_bias(lp, z, cfg.n_heads).astype(jnp.float32)
        attn_state = (ref_pf._pair_bias(lp, state, cfg.n_heads)
                      .astype(jnp.float32) if mode == "pair" else state)
        s = ref_pf._attend_cached(lp, s, attn_state, cfg, lengths)
        s = s + ref_common.gelu_mlp(ref_common.rmsnorm(s, lp["ln2"]),
                                    lp["wi"].astype(dt),
                                    lp["wo_mlp"].astype(dt))
        z = z + ref_common.gelu_mlp(ref_common.rmsnorm(z, lp["pair_ln"]),
                                    lp["pair_wi"], lp["pair_wo"])
        states.append(state)
    cache = {"s": s, "length": lengths}
    if mode in ("svd", "mlp"):
        cache["phi_q"] = jnp.stack([q for q, _ in states])
        cache["phi_k"] = jnp.stack([k for _, k in states])
    else:
        cache["bias" if mode == "dense" else "z"] = jnp.stack(states)
    return cache


# bf16 has an 8-bit significand: both packages round the same float32
# values to bf16 at every layer boundary, but in a different order inside
# each op (and torch's bf16 GELU rounds once where JAX's rounds per op), so
# they may land one bf16 ulp apart and carry it on. 4 ulps (2^-6) of the
# magnitude bounds it over the two layers.
BF16_TOL = {"rtol": 2.0 ** -6, "atol": 2.0 ** -6}


def test_bf16_layer_dtypes_follow_jax_promotion():
    """Each layer function returns the dtype JAX's promotion gives, on the
    same bf16 / float32 inputs."""
    rcfg, tcfg, rp, tp, rf, tf = _setup("mlp", "bfloat16")
    rng = np.random.default_rng(4)
    z = jnp.asarray(rng.standard_normal((2, 9, 9, rcfg.d_pair)),
                    jnp.bfloat16)
    s = jnp.asarray(rng.standard_normal((2, 9, rcfg.d_model)), jnp.bfloat16)
    zt = torch.from_numpy(np.asarray(z, np.float32)).to(torch.bfloat16)
    st = torch.from_numpy(np.asarray(s, np.float32)).to(torch.bfloat16)
    rl = _layer0(rp["layers"])
    tl = tcommon.tree_map(lambda x: x[0], tp["layers"])
    pairs = [
        (tpf._triangle_update(tl, zt), ref_pf._triangle_update(rl, z)),
        (tpf._pair_bias(tl, zt), ref_pf._pair_bias(rl, z, rcfg.n_heads)),
        (tpf._factor_inputs(zt.float(), st),
         ref_pf._factor_inputs(z.astype(jnp.float32), s)),
        (tcommon.gelu_mlp(tcommon.rmsnorm(zt.float(), tl["pair_ln"]),
                          tl["pair_wi"], tl["pair_wo"]), ref_common.gelu_mlp(
            ref_common.rmsnorm(z.astype(jnp.float32), rl["pair_ln"]),
            rl["pair_wi"], rl["pair_wo"])),
    ]
    for got, want in pairs:
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        _close(got.float(), np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_bf16_prefill_and_step_match_reference(mode):
    """``SMOKE`` at bfloat16 with float32 parameters, in every cache mode:
    the cache dtypes are the reference's (``s`` bf16, factors and dense
    bias float32, the pair cache bf16 once inserted), the admission pass
    matches the unrolled reference, and one step from the same cache
    matches the reference's ``serve_step`` (which runs at bf16)."""
    (rcfg, tcfg, rp, tp, rf, tf), rc, tc = _ref_and_port_prefill(
        mode, dtype="bfloat16")
    for key in rc:
        assert str(tc[key].dtype).split(".")[-1] == str(rc[key].dtype), key
    _compare_caches(mode, rc, tc, LENGTHS, BF16_TOL)
    rdst = ref_pf.init_serve_cache(rcfg, 3, MAX_LEN, factors=rf)
    tdst = tpf.init_serve_cache(tcfg, 3, MAX_LEN, factors=tf, device="cpu")
    for key in rdst:
        assert str(tdst[key].dtype).split(".")[-1] == str(rdst[key].dtype)
    slots = np.arange(3, dtype=np.int32)
    rdst = ref_pf.insert_serve_cache_at_slots(rdst, rc, jnp.asarray(slots))
    tdst = _swap_factor_axes({
        k: torch.from_numpy(np.array(v, np.float32)).to(tdst[k].dtype)
        for k, v in rdst.items()})
    rstep = ref_get_model(rcfg).decode(rp, rdst)
    tstep = get_model(tcfg).decode(tpf.cast_params(tp, tcfg), tdst)
    assert tstep["s"].dtype == torch.bfloat16
    _close(tstep["s"].float(), np.asarray(rstep["s"], np.float32),
           **BF16_TOL)

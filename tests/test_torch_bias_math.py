"""The port's bias math against the JAX package, on the CPU, float32.

Inputs are numpy arrays from a seed; each port function and its JAX
counterpart get the same ones. Tolerance: max abs error <= 1e-4 x max(1,
max |ref|) (float32, summation order only). Covered: the sqdist,
scaled-sqdist and cos-relpos factor pairs with their dense oracles,
``broadcast_factors`` (with its errors for 3-D factors), ``BiasSpec``, the
Eq. 3 concat fold ``flashbias_concat_qk``, the App. I multiplicative form,
``core.lowrank`` (energy, rank choice and its edge cases, the IO model's
examples) and ``decomp.reconstruction_error``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.attention as jattn
import repro.core.bias as jbias
import repro.core.decomp as jdecomp
import repro.core.lowrank as jlowrank
from repro_torch.core import bias as tbias
from repro_torch.core import decomp as tdecomp
from repro_torch.core import lowrank as tlowrank
from repro_torch.core.attention import (
    MaskSpec,
    attention,
    flashbias_concat_qk,
    multiplicative_flashbias_attention,
)

RTOL = 1e-4


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= RTOL * max(1.0, float(np.abs(want).max())), err


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(x):
    return torch.from_numpy(x), jnp.asarray(x)


@pytest.mark.parametrize("negate", [True, False])
@pytest.mark.parametrize("d,lead", [(1, ()), (3, ()), (3, (2,)), (2, (2, 3))])
def test_sqdist_factors_and_dense(d, lead, negate):
    rng = np.random.default_rng(d + len(lead))
    (tq, jq), (tk, jk) = (_both(_rand(rng, *lead, 7, d)),
                          _both(_rand(rng, *lead, 5, d)))
    tpq, tpk = tbias.sqdist_factors(tq, tk, negate=negate)
    jpq, jpk = jbias.sqdist_factors(jq, jk, negate=negate)
    assert tpq.shape[-1] == tpk.shape[-1] == 3 * d
    _close(tpq, jpq)
    _close(tpk, jpk)
    dense = tbias.sqdist_dense(tq, tk, negate=negate)
    _close(dense, jbias.sqdist_dense(jq, jk, negate=negate))
    _close(tpq @ tpk.transpose(-1, -2), dense)


@pytest.mark.parametrize("alpha_shape", [(7,), (4, 7)])
def test_scaled_sqdist_factors_and_dense(alpha_shape):
    """alpha per query (N,) and per head (H, N) with (1, N, d) coordinates:
    the PDE solver's learnable scale folds into phi_q."""
    rng = np.random.default_rng(1)
    lead = (1,) if len(alpha_shape) == 2 else ()
    tx, jx = _both(_rand(rng, *lead, 7, 3))
    ta, ja = _both(np.log1p(np.exp(_rand(rng, *alpha_shape))))
    tpq, tpk = tbias.scaled_sqdist_factors(tx, tx, ta)
    jpq, jpk = jbias.scaled_sqdist_factors(jx, jx, ja)
    _close(tpq, jpq)
    _close(tpk, jpk)
    dense = tbias.scaled_sqdist_dense(tx, tx, ta)
    _close(dense, jbias.scaled_sqdist_dense(jx, jx, ja))
    _close(tpq @ tpk.transpose(-1, -2), dense)


@pytest.mark.parametrize("n,m", [(9, 13), (1, 6), (64, 64)])
def test_cos_relpos_factors_and_dense(n, m):
    tpq, tpk = tbias.cos_relpos_factors(n, m)
    jpq, jpk = jbias.cos_relpos_factors(n, m)
    _close(tpq, jpq)
    _close(tpk, jpk)
    dense = tbias.cos_relpos_dense(n, m)
    _close(dense, jbias.cos_relpos_dense(n, m))
    _close(tpq @ tpk.T, dense)


@pytest.mark.parametrize("shape", [(6, 2), (4, 6, 2), (3, 6, 1, 2),
                                   (3, 6, 4, 2), (1, 6, 4, 2)])
def test_broadcast_factors_matches_reference(shape):
    t, j = _both(_rand(np.random.default_rng(2), *shape))
    got = tbias.broadcast_factors(t, batch=3, seq=6, heads=4)
    want = jbias.broadcast_factors(j, batch=3, seq=6, heads=4)
    assert tuple(got.shape) == want.shape == (3, 6, 4, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,match", [((6, 6, 2), "per-head"),
                                         ((3, 6, 2), "per-head"),
                                         ((2,), "rank"),
                                         ((1, 1, 1, 6, 2), "rank")])
def test_broadcast_factors_rejects_what_the_reference_rejects(shape, match):
    """A 3-D factor is per head only (B == S == 6 would otherwise pass a
    broadcast and land batch in heads); ranks outside 2-4 raise."""
    t, j = _both(np.zeros(shape, np.float32))
    with pytest.raises(ValueError, match=match):
        jbias.broadcast_factors(j, batch=6, seq=6, heads=4)
    with pytest.raises(ValueError, match=match):
        tbias.broadcast_factors(t, batch=6, seq=6, heads=4)


@pytest.mark.parametrize("kind,rank,coord_dim,want", [
    ("alibi", 0, 3, 2), ("sqdist", 0, 3, 9), ("sqdist", 0, 2, 6),
    ("svd", 16, 3, 16), ("none", 0, 3, 0)])
def test_bias_spec_effective_rank(kind, rank, coord_dim, want):
    t = tbias.BiasSpec(kind=kind, rank=rank, coord_dim=coord_dim)
    j = jbias.BiasSpec(kind=kind, rank=rank, coord_dim=coord_dim)
    assert t.effective_rank == j.effective_rank == want


@pytest.mark.parametrize("kw", [{"kind": "rope"}, {"mode": "sparse"}])
def test_bias_spec_rejects_unknown_kind_and_mode(kw):
    with pytest.raises(AssertionError):
        jbias.BiasSpec(**kw)
    with pytest.raises(ValueError):
        tbias.BiasSpec(**kw)


def _gqa_inputs(seed, b=2, n=9, m=11, h=4, hk=2, d=8, r=3, phi_heads=1):
    rng = np.random.default_rng(seed)
    return (_rand(rng, b, n, h, d), _rand(rng, b, m, hk, d),
            _rand(rng, b, m, hk, d), _rand(rng, b, n, h, r),
            _rand(rng, b, m, phi_heads, r))


@pytest.mark.parametrize("phi_heads", [1, 2])
@pytest.mark.parametrize("scale", [None, 0.3])
def test_concat_qk_matches_reference_and_eq3(phi_heads, scale):
    """q' and k' equal the reference's, and attention over them (no bias)
    equals attention with the factored bias (Eq. 3), GQA 4:2 with phi_k
    per kv head or shared."""
    q, k, v, pq, pk = _gqa_inputs(3, phi_heads=phi_heads)
    tq, tk = flashbias_concat_qk(*(torch.from_numpy(x) for x in
                                   (q, k, pq, pk)), scale=scale)
    jq, jk = jattn.flashbias_concat_qk(*(jnp.asarray(x) for x in
                                         (q, k, pq, pk)), scale=scale)
    _close(tq, jq)
    _close(tk, jk)
    s = scale if scale is not None else 1.0 / np.sqrt(q.shape[-1])
    tv = torch.from_numpy(v)
    # phi_k per kv head rides under each kv head's G q-heads
    pk_q = torch.from_numpy(pk).repeat_interleave(4 // phi_heads, dim=2)
    want = attention(torch.from_numpy(q), torch.from_numpy(k), tv,
                     phi_q=torch.from_numpy(pq), phi_k=pk_q, scale=s,
                     impl="dense")
    got = attention(tq, tk, tv, scale=s, impl="dense")
    _close(got, want)


def test_concat_qk_rejects_phi_k_heads_off_the_kv_heads():
    q, k, _, pq, pk = _gqa_inputs(4, phi_heads=3)
    with pytest.raises(AssertionError):
        jattn.flashbias_concat_qk(*(jnp.asarray(x) for x in (q, k, pq, pk)))
    with pytest.raises(ValueError, match="kv heads"):
        flashbias_concat_qk(*(torch.from_numpy(x) for x in (q, k, pq, pk)))


@pytest.mark.parametrize("mask", ["none", "causal"])
@pytest.mark.parametrize("factors", ["cos", "random"])
def test_multiplicative_attention_matches_reference(mask, factors):
    """softmax((q k^T * scale) * b) v with b = phi_q phi_k^T (Eq. 17): the
    port against the reference, and against the product formed densely."""
    rng = np.random.default_rng(5)
    b, n, h, d = 2, 10, 3, 8
    q, k, v = (_rand(rng, b, n, h, d) for _ in range(3))
    if factors == "cos":
        pq, pk = (np.asarray(x)[None, :, None, :]
                  for x in jbias.cos_relpos_factors(n, n))
    else:
        pq, pk = _rand(rng, b, n, h, 2), _rand(rng, b, n, h, 2)
    got = multiplicative_flashbias_attention(
        *(torch.from_numpy(np.array(x))
          for x in (q, k, v, pq, pk)), mask=MaskSpec(mask))
    want = jattn.multiplicative_flashbias_attention(
        *(jnp.asarray(x) for x in (q, k, v, pq, pk)),
        mask=jattn.MaskSpec(mask))
    _close(got, want)
    pq4, pk4 = (np.broadcast_to(x, (b, n, h, x.shape[-1])) for x in (pq, pk))
    bias = np.einsum("bnhr,bmhr->bhnm", pq4, pk4)
    logits = np.einsum("bnhd,bmhd->bhnm", q, k) / np.sqrt(d) * bias
    if mask == "causal":
        logits = np.where(np.tril(np.ones((n, n), bool)), logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    _close(got, np.einsum("bhnm,bmhd->bnhd", p, v))


def _low_rank(rng, n, m, r):
    return _rand(rng, n, r) @ _rand(rng, r, m)


@pytest.mark.parametrize("name", ["full", "rank3", "batched", "zero",
                                  "wide"])
def test_energy_profile_and_rank_match_reference(name):
    rng = np.random.default_rng(6)
    mats = {"full": _rand(rng, 16, 16), "rank3": _low_rank(rng, 32, 32, 3),
            "batched": np.stack([np.zeros((8, 8), np.float32),
                                 _rand(rng, 8, 8)]),
            "zero": np.zeros((12, 7), np.float32),
            "wide": _low_rank(rng, 6, 20, 4)}
    t, j = _both(mats[name])
    _close(tlowrank.energy_profile(t), jlowrank.energy_profile(j))
    for energy in (0.5, 0.9, 0.99, 0.999, 1.0):
        assert (tlowrank.rank_for_energy(t, energy)
                == jlowrank.rank_for_energy(j, energy)), energy
    for rank in (-1, 0, 1, 3, 7, 100):
        got = tlowrank.retained_energy(t, rank)
        assert abs(got - jlowrank.retained_energy(j, rank)) <= RTOL, rank


def test_lowrank_edge_cases():
    """The reference's regression cases: a zero matrix needs the whole
    spectrum (never min(N, M) + 1), rank <= 0 keeps nothing, ranks past the
    spectrum keep everything, an exact rank-3 matrix needs <= 3."""
    rng = np.random.default_rng(7)
    assert tlowrank.rank_for_energy(torch.zeros(12, 7), 0.99) == 7
    assert tlowrank.rank_for_energy(torch.zeros(3, 3), 1.0) == 3
    assert tlowrank.rank_for_energy(torch.from_numpy(_rand(rng, 16, 16)),
                                    1.0) == 16
    assert tlowrank.rank_for_energy(
        torch.from_numpy(_low_rank(rng, 32, 32, 3)), 0.999) <= 3
    m = torch.from_numpy(_rand(rng, 24, 24))
    es = [tlowrank.retained_energy(m, r) for r in (1, 4, 8, 24)]
    assert es == sorted(es) and abs(es[-1] - 1.0) < 1e-5
    assert tlowrank.retained_energy(m, 0) == 0.0
    assert tlowrank.retained_energy(m, -1) == 0.0
    assert abs(tlowrank.retained_energy(m, 100) - 1.0) < 1e-5
    assert tlowrank.retained_energy(torch.zeros(5, 9), 3) == 0.0


@pytest.mark.parametrize("n,rank,itemsize", [(576, 16, 2), (32186, 9, 4),
                                             (7, 7, 2)])
def test_optimal_storage_bytes(n, rank, itemsize):
    assert (tlowrank.optimal_storage_bytes(n, rank, itemsize)
            == jlowrank.optimal_storage_bytes(n, rank, itemsize)
            == (2 * n * rank - rank * rank) * itemsize)


@pytest.mark.parametrize("dims", [(65536, 65536, 64, 64, 100 * 1024 // 2),
                                  (576, 576, 32, 16, 100 * 1024 // 2),
                                  (32186, 32186, 16, 9, 228 * 1024 // 4)])
def test_io_model_matches_reference(dims):
    t, j = tlowrank.IOModel(*dims), jlowrank.IOModel(*dims)
    for fn in ("standard_attention", "flashattention",
               "flashattention_with_bias", "flashbias",
               "flashbias_multiplicative", "speedup_over_dense_bias",
               "multiplicative_worthwhile"):
        assert getattr(t, fn)() == pytest.approx(getattr(j, fn)()), fn


def test_io_model_examples():
    """Example 3.9: C = R = 64, S = 100 KB at half precision gives ~6x
    fewer HBM accesses; Cor. I.2's threshold R <= sqrt(S / C^2 + 1) holds
    on both sides of its boundary."""
    sram = 100 * 1024 // 2
    io = tlowrank.IOModel(n=65536, m=65536, c=64, rank=64, sram=sram)
    assert 5.0 < io.speedup_over_dense_bias() < 7.0
    r_star = np.sqrt(sram / 64 ** 2 + 1)
    assert tlowrank.IOModel(1, 1, 64, int(np.floor(r_star)),
                            sram).multiplicative_worthwhile()
    assert not tlowrank.IOModel(1, 1, 64, int(np.ceil(r_star)) + 1,
                                sram).multiplicative_worthwhile()


@pytest.mark.parametrize("rank", [1, 4, 6])
def test_reconstruction_error_matches_reference(rank):
    """The relative Frobenius error of truncated SVD factors of a batched
    (H, N, M) table, the port's factors against the port's table and the
    reference's against the reference's: the errors agree (the factors
    themselves are unique only up to sign)."""
    rng = np.random.default_rng(8)
    table = _rand(rng, 3, 6, 6)
    t, j = _both(table)
    tq, tk = tdecomp.svd_factors(t, rank)
    jq, jk = jdecomp.svd_factors(j, rank=rank)
    got = tdecomp.reconstruction_error(t, tq, tk)
    want = jdecomp.reconstruction_error(j, jq, jk)
    assert abs(got - want) <= RTOL
    # the reference's own factors, carried across, give the same error
    assert abs(tdecomp.reconstruction_error(
        t, *(torch.from_numpy(np.array(x)) for x in (jq, jk)))
        - want) <= RTOL
    assert (rank == 6) == (got < 1e-5)

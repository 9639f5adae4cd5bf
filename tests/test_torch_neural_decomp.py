"""The port's SVD and neural decompositions (``repro_torch.core.decomp``)
against the JAX package's, on the CPU, float32.

Inputs are made with numpy from a seed; the reference's initial factor
MLPs (``jax.random``, which has no torch twin) cross with
``interop.neural_decomp_from_numpy``. SVD factors are unique only up to
sign, so they are compared through ``phi_q @ phi_k^T``.

Tolerances: SVD products within 1e-4 of the table's scale (two SVD
implementations); the factor MLPs' outputs and the predicted bias within
1e-5 (the same float32 products); 20 Adam steps of Eq. 5: every step's loss
within rtol 1e-4 and the fitted parameters within 1e-4 of each leaf's
scale (float32 roundings in another order, amplified by Adam's division
by ``sqrt(n_hat)`` on near-zero gradients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decomp as jdecomp
from repro_torch.core import decomp
from repro_torch.interop import neural_decomp_from_numpy

HIDDEN, HEADS, RANK = 16, 2, 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _carried(seed=0, din_q=3, din_k=3):
    jp = jdecomp.neural_decomp_init(jax.random.PRNGKey(seed), din_q, din_k,
                                    hidden=HIDDEN, heads=HEADS, rank=RANK)
    return jp, neural_decomp_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _spectrum_table(seed=0, h=3, n=20, m=18):
    """Per-head tables whose spectra decay geometrically, so that the
    energy rule picks ranks well inside (1, min(N, M))."""
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.standard_normal((h, n, n)))[0]
    v = np.linalg.qr(rng.standard_normal((h, m, m)))[0]
    k = min(n, m)
    s = 0.5 ** np.arange(k)[None] * rng.uniform(0.5, 2.0, (h, 1))
    return np.einsum("hnk,hk,hmk->hnm", u[..., :k], s,
                     v[..., :k]).astype(np.float32)


@pytest.mark.parametrize("energy", [0.9, 0.99, 0.999])
def test_svd_factors_energy_rank(energy):
    """``rank=None``: the rank the energy rule picks (the largest over the
    heads) and the reconstruction are the reference's."""
    table = _spectrum_table()
    jq, jk = jdecomp.svd_factors(jnp.asarray(table), rank=None,
                                 energy=energy)
    tq, tk = decomp.svd_factors(torch.from_numpy(table), energy=energy)
    assert tq.shape == jq.shape and tk.shape == jk.shape
    assert 1 < tq.shape[-1] < table.shape[-1]
    _close(tq @ tk.transpose(-1, -2),
           np.asarray(jq @ jnp.swapaxes(jk, -1, -2)), 1e-4)
    err = decomp.reconstruction_error(torch.from_numpy(table), tq, tk)
    assert abs(err - jdecomp.reconstruction_error(jnp.asarray(table), jq,
                                                  jk)) <= 1e-5


def test_svd_factors_given_rank_still_matches():
    table = _spectrum_table(seed=1)
    jq, jk = jdecomp.svd_factors(jnp.asarray(table), rank=5)
    tq, tk = decomp.svd_factors(torch.from_numpy(table), 5)
    assert tq.shape[-1] == 5
    _close(tq @ tk.transpose(-1, -2),
           np.asarray(jq @ jnp.swapaxes(jk, -1, -2)), 1e-4)


def test_carried_params_keep_structure_and_refuse_bad_trees():
    jp, tp = _carried()
    assert (tp.heads, tp.rank) == (HEADS, RANK)
    assert len(tp.leaves()) == len(jax.tree.leaves(jp)) == 12
    for got, want in zip(tp.leaves(), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bad = {"q_layers": [tuple(map(np.asarray, layer))
                        for layer in jp.q_layers],
           "k_layers": [tuple(map(np.asarray, layer))
                        for layer in jp.k_layers],
           "heads": HEADS, "rank": RANK + 1}
    with pytest.raises(ValueError, match="heads x rank"):
        neural_decomp_from_numpy(bad, device="cpu")
    bad["rank"] = RANK
    bad["k_layers"][1] = (bad["k_layers"][1][0][:-1], bad["k_layers"][1][1])
    with pytest.raises(ValueError, match="k_layers"):
        neural_decomp_from_numpy(bad, device="cpu")


def test_init_shapes_and_law():
    gen = torch.Generator().manual_seed(0)
    p = decomp.neural_decomp_init(gen, 5, 7, hidden=64, heads=3, rank=6)
    jp = jdecomp.neural_decomp_init(jax.random.PRNGKey(0), 5, 7, hidden=64,
                                    heads=3, rank=6)
    assert [tuple(t.shape) for t in p.leaves()] == \
        [tuple(t.shape) for t in jax.tree.leaves(jp)]
    assert all(t.device.type == "cpu" for t in p.leaves())
    w1 = p.q_layers[1][0]
    assert abs(float(w1.std()) - 1 / 8) < 0.02       # N(0, 1) / sqrt(64)
    assert all(float(b.abs().max()) == 0 for _, b in p.k_layers)


@pytest.mark.parametrize("batched", [False, True])
def test_apply_and_predicted_bias(batched):
    jp, tp = _carried(seed=1)
    rng = np.random.default_rng(2)
    lead = (2,) if batched else ()
    xq = rng.standard_normal(lead + (10, 3)).astype(np.float32)
    xk = rng.standard_normal(lead + (7, 3)).astype(np.float32)
    jq, jk = jdecomp.neural_decomp_apply(jp, jnp.asarray(xq), jnp.asarray(xk))
    tq, tk = decomp.neural_decomp_apply(tp, torch.from_numpy(xq),
                                        torch.from_numpy(xk))
    assert tuple(tq.shape) == lead + (10, HEADS, RANK)
    _close(tq, jq, 1e-5)
    _close(tk, jk, 1e-5)
    _close(decomp.predicted_bias(tp, torch.from_numpy(xq),
                                 torch.from_numpy(xk)),
           jdecomp.predicted_bias(jp, jnp.asarray(xq), jnp.asarray(xk)), 1e-5)


def test_fit_matches_reference():
    """20 Adam steps of Eq. 5 on a fixed sample, with the learning rate
    decayed every 5 steps: every step's loss and the fitted parameters."""
    jp, tp = _carried(seed=3, din_q=2, din_k=2)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (12, 2)).astype(np.float32)
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
    target = np.stack([1.0 / (d2 + 0.1), -d2]).astype(np.float32)
    kw = dict(steps=20, lr=3e-3, lr_decay=0.5, lr_decay_every=5)
    jfit, jloss = jdecomp.fit_neural_decomposition(
        jax.random.PRNGKey(0), jp,
        lambda key: (jnp.asarray(x), jnp.asarray(x), jnp.asarray(target)),
        **kw)
    tx, tt = torch.from_numpy(x), torch.from_numpy(target)
    seen = []
    tfit, tloss = decomp.fit_neural_decomposition(
        torch.Generator().manual_seed(0), tp,
        lambda gen: (seen.append(gen) or tx, tx, tt), **kw)
    assert len(seen) == 20 and tloss.dtype == torch.float32
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-4)
    assert float(tloss[-1]) < 0.5 * float(tloss[0])
    for got, want in zip(tfit.leaves(), jax.tree.leaves(jfit)):
        _close(got, want, 1e-4)
    # the starting parameters are left as they were
    for got, want in zip(tp.leaves(), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_factors_are_tokenwise():
    """Remark 3.6: a factor row depends on its own token's features alone,
    so permuting the tokens permutes the factors (the reference's
    ``tests/test_decomp.py`` case, on the port)."""
    _, tp = _carried(seed=1)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (10, 3)).astype(np.float32))
    perm = torch.tensor([3, 1, 4, 0, 2, 9, 8, 7, 5, 6])
    pq, pk = decomp.neural_decomp_apply(tp, x, x)
    pq_p, pk_p = decomp.neural_decomp_apply(tp, x[perm], x[perm])
    torch.testing.assert_close(pq[perm], pq_p, atol=1e-6, rtol=0)
    torch.testing.assert_close(pk[perm], pk_p, atol=1e-6, rtol=0)

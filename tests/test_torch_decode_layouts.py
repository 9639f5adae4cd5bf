"""The decode dispatch's cache layouts and factor forms against the JAX
reference, on the CPU, float32: ``ops.flash_decode`` against
``repro.kernels.ops.flash_decode(impl="xla")`` and
``ops.flash_chunk_attention`` against the reference's, at rtol 1e-5 (atol
1e-6: outputs are O(1) averages of v; the paths sum in other orders).

- ``kv_layout="bshd"`` (the default, as in the reference): contiguous ``(B,
  S, KVH, D)`` caches and paged pools ``(n_pages, ps, KVH, D)``, with
  per-q-head ``phi_k`` (over all H heads), per-kv-head and shared factors
  (contiguous ``(B, S, H|KVH|1, R)``; paged slabs ``(n_pages, ps, H|KVH,
  R)`` and ``(n_pages, ps, R)``), and ALiBi, at 1, 2 and 4 q heads per kv
  head.
- ``kv_layout="bhsd"`` (the models' kernel layout): the same cases; a
  per-q-head ``phi_k (B, H, S, R)``, which the reference's head-major path
  does not take, is held against the reference's bshd call on the same
  values.
- The new row (``k_new`` / ``v_new``) on a bshd cache lands in the
  caller's cache, contiguous and paged: the result equals the write done
  first and the decode call after it.
- ``flash_chunk_attention`` in bshd, contiguous and paged, with and without
  ALiBi.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

B, KVH, D, R, S, PS = 3, 2, 16, 3, 40, 8
LENGTHS = np.array([17, 40, 5], np.int32)
N_PAGES = B * S // PS + 3


def _rng(*key):
    return np.random.default_rng(list(key))


def _factors(rng, g: int, form: str):
    """phi_q (B, 1, H, R) and phi_k (B, S, X, R) with X = H, KVH or 1."""
    h = KVH * g
    heads = {"per_q_head": h, "per_kv_head": KVH, "shared": 1}[form]
    phi_q = rng.standard_normal((B, 1, h, R)).astype(np.float32)
    phi_k = rng.standard_normal((B, S, heads, R)).astype(np.float32)
    return phi_q, phi_k


def _inputs(g: int, seed: int):
    rng = _rng(seed, g)
    q = rng.standard_normal((B, 1, KVH * g, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    return rng, q, k, v


def _slopes(g: int):
    h = KVH * g
    return (2.0 ** -np.arange(1, h + 1) / 2).astype(np.float32)


def _reference(q, k, v, bias, **kw):
    jkw = {name: jnp.asarray(x) for name, x in bias.items()}
    return np.asarray(jops.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(LENGTHS),
        impl="xla", kv_layout="bshd", **jkw,
        **{n: jnp.asarray(x) for n, x in kw.items()}))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-6)


def _paged(rng, k, v, phi_k):
    """bshd pools holding each row's logical cache at random pages, a page
    table with sentinel entries past the live blocks, and the factor slab
    (phi_k (B, S, X, R) -> (n_pages, ps, X, R))."""
    table = np.full((B, S // PS + 1), N_PAGES, np.int32)
    order = rng.permutation(N_PAGES)
    pools = [np.zeros((N_PAGES, PS) + x.shape[2:], np.float32)
             for x in (k, v) + (() if phi_k is None else (phi_k,))]
    for b in range(B):
        for j in range(S // PS):
            page = order[b * (S // PS) + j]
            table[b, j] = page
            for pool, x in zip(pools, (k, v, phi_k)):
                pool[page] = x[b, j * PS:(j + 1) * PS]
    return table, pools


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("bias", ["per_q_head", "per_kv_head", "shared",
                                  "alibi"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_bshd_matches_reference(g, bias, paged):
    rng, q, k, v = _inputs(g, 1)
    if bias == "alibi":
        jb = {"slopes": _slopes(g)}
        phi_k = None
    else:
        phi_q, phi_k = _factors(rng, g, bias)
        jb = {"phi_q": phi_q, "phi_k": phi_k}
    want = _reference(q, k, v, jb)
    if paged:
        table, pools = _paged(rng, k, v, phi_k)
        kc, vc = pools[0], pools[1]
        tb = dict(jb)
        if phi_k is not None:
            slab = pools[2]
            tb["phi_k"] = slab[:, :, 0] if bias == "shared" else slab
        extra = {"page_table": torch.from_numpy(table)}
        # the reference's paged bshd path over the same pools
        jwant = _reference(q, kc, vc, tb, page_table=table)
        _close(jwant, want)
    else:
        kc, vc, tb, extra = k, v, jb, {}
    got = tops.flash_decode(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(LENGTHS), impl="torch", **extra,
        **{n: torch.from_numpy(x) for n, x in tb.items()})
    _close(got, want)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("bias", ["per_q_head", "per_kv_head", "shared",
                                  "alibi"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_bhsd_matches_reference(g, bias, paged):
    rng, q, k, v = _inputs(g, 2)
    if bias == "alibi":
        jb, phi_k = {"slopes": _slopes(g)}, None
    else:
        phi_q, phi_k = _factors(rng, g, bias)
        jb = {"phi_q": phi_q, "phi_k": phi_k}
    want = _reference(q, k, v, jb)
    tb = {n: torch.from_numpy(x) for n, x in jb.items()}
    if paged:
        table, pools = _paged(rng, k, v, phi_k)
        kc, vc = (torch.from_numpy(p).permute(2, 0, 1, 3).contiguous()
                  for p in pools[:2])
        if phi_k is not None:
            slab = torch.from_numpy(pools[2])
            tb["phi_k"] = (slab[:, :, 0] if bias == "shared"
                           else slab.permute(2, 0, 1, 3).contiguous())
        extra = {"page_table": torch.from_numpy(table)}
    else:
        kc, vc = (torch.from_numpy(x).transpose(1, 2).contiguous()
                  for x in (k, v))
        if phi_k is not None:
            pk = torch.from_numpy(phi_k)
            tb["phi_k"] = (pk[:, :, 0] if bias == "shared"
                           else pk.transpose(1, 2).contiguous())
        extra = {}
    if bias in ("per_kv_head", "shared", "alibi"):
        # the reference's kernel-layout path takes these forms directly
        jkw = {n: jnp.asarray(x.numpy()) for n, x in tb.items()}
        if paged:
            jkw["page_table"] = jnp.asarray(table)
        jwant = np.asarray(jops.flash_decode(
            jnp.asarray(q), jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy()),
            jnp.asarray(LENGTHS), impl="xla", kv_layout="bhsd", **jkw))
        _close(jwant, want)
    got = tops.flash_decode(torch.from_numpy(q), kc, vc,
                            torch.from_numpy(LENGTHS), impl="torch",
                            kv_layout="bhsd", **extra, **tb)
    _close(got, want)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("bias", ["per_q_head", "alibi"])
def test_new_row_lands_in_the_callers_cache(layout, paged, bias):
    """``k_new`` / ``v_new`` give the write done first and the decode after
    it, on every layout and route (per-q-head factors copy the cache, so
    the row must land in the caller's before the copy)."""
    g = 2
    rng, q, k, v = _inputs(g, 3)
    kw = ({"slopes": torch.from_numpy(_slopes(g))} if bias == "alibi"
          else dict(zip(("phi_q", "phi_k"), map(torch.from_numpy,
                                                 _factors(rng, g, bias)))))
    k_new = torch.from_numpy(rng.standard_normal((B, KVH, D))
                             .astype(np.float32))
    v_new = torch.from_numpy(rng.standard_normal((B, KVH, D))
                             .astype(np.float32))
    lengths = torch.from_numpy(LENGTHS.copy())
    lengths[2] = 0                                   # a frozen row
    if paged:
        phi_k = kw["phi_k"].numpy() if "phi_k" in kw else None
        table, pools = _paged(rng, k, v, phi_k)
        kc, vc = (torch.from_numpy(p) for p in pools[:2])
        if phi_k is not None:
            kw["phi_k"] = torch.from_numpy(pools[2])
        kw["page_table"] = torch.from_numpy(table)
    else:
        kc, vc = torch.from_numpy(k), torch.from_numpy(v)
    if layout == "bhsd":
        perm = (2, 0, 1, 3) if paged else (0, 2, 1, 3)
        kc, vc = (x.permute(perm).contiguous() for x in (kc, vc))
        if "phi_k" in kw:
            kw["phi_k"] = kw["phi_k"].permute(perm).contiguous()
    k_one, v_one = kc.clone(), vc.clone()
    got = tops.flash_decode(torch.from_numpy(q), k_one, v_one, lengths,
                            impl="torch", kv_layout=layout, k_new=k_new,
                            v_new=v_new, **kw)
    # the write done first by the plain rule, on a head-major view
    k_two, v_two = kc.clone(), vc.clone()
    hm = (lambda t: t) if layout == "bhsd" else (
        (lambda t: t.permute(2, 0, 1, 3)) if paged
        else (lambda t: t.transpose(1, 2)))
    from repro_torch.kernels.flash_decode import write_paged_row, write_row
    if paged:
        write_paged_row(hm(k_two), hm(v_two), lengths, kw["page_table"],
                        k_new, v_new)
    else:
        write_row(hm(k_two), hm(v_two), lengths, k_new, v_new)
    want = tops.flash_decode(torch.from_numpy(q), k_two, v_two, lengths,
                             impl="torch", kv_layout=layout, **kw)
    assert torch.equal(k_one, k_two) and torch.equal(v_one, v_two)
    assert not torch.equal(k_one, kc)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("alibi", [False, True], ids=["none", "alibi"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_chunk_attention_bshd_matches_reference(paged, alibi):
    rng = _rng(4, int(paged), int(alibi))
    g, c = 2, 6
    h = KVH * g
    q = rng.standard_normal((B, c, h, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    offsets = np.array([0, 20, 34], np.int32)
    chunk_lens = np.array([6, 3, 6], np.int32)
    slopes = _slopes(g) if alibi else None
    kw, tkw = {}, {}
    if paged:
        table, pools = _paged(rng, k, v, None)
        k, v = pools
        kw = {"page_table": jnp.asarray(table)}
        tkw = {"page_table": torch.from_numpy(table)}
    want = np.asarray(jops.flash_chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(offsets),
        jnp.asarray(chunk_lens), None if slopes is None else
        jnp.asarray(slopes), impl="xla", kv_layout="bshd", **kw))
    got = tops.flash_chunk_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        offsets, chunk_lens, None if slopes is None else
        torch.from_numpy(slopes), **tkw)
    live = np.arange(c)[None, :] < chunk_lens[:, None]
    _close(got.numpy()[live], want[live])

"""The port's attention math against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
port's plain kernel versions (``flashbias_attention_torch``,
``flash_decode_torch``) are held to the reference's Pallas kernels run in
interpret mode, at float32 with ``rtol = atol = 1e-5``; the port's core
attention, oracles and ALiBi factorization to their reference twins. The
CUDA kernels themselves are compared with their plain versions by the
tests marked ``cuda``, which skip without a card. The reference is imported
by a fixture, so that the ``cuda`` tests also run where JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_attention_kernels.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import attention as tattn
from repro_torch.core import bias as tbias
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_decode import (
    flash_decode_fwd,
    flash_decode_paged_fwd,
    flash_decode_paged_torch,
    flash_decode_torch,
)
from repro_torch.kernels.flashbias_attn import (
    flashbias_attention_fwd,
    flashbias_attention_ragged_fwd,
    flashbias_attention_torch,
)

TOL = {"rtol": 1e-5, "atol": 1e-5}
B, N, D, R, WINDOW = 2, 40, 16, 3, 12        # N is not a tile multiple


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference modules (the tests comparing against it skip where
    JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.core.attention as attn
    import repro.core.bias as bias
    from repro.kernels import ops, ref
    return types.SimpleNamespace(jnp=jnp, attn=attn, bias=bias, ops=ops,
                                 ref=ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _prefill_case(rng, h, kvh, bias):
    q, k, v = _rand(rng, B, h, N, D), _rand(rng, B, kvh, N, D), \
        _rand(rng, B, kvh, N, D)
    phi_q = phi_k = slopes = None
    if bias == "phi":
        phi_q, phi_k = _rand(rng, B, h, N, R), _rand(rng, B, h, N, R)
    elif bias == "alibi":
        slopes = tbias.alibi_slopes(h).numpy()
    return q, k, v, phi_q, phi_k, slopes


@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa4:2"])
@pytest.mark.parametrize("mask", ["causal", "local", "none"])
@pytest.mark.parametrize("bias", ["alibi", "phi", "none"])
def test_flashbias_plain_matches_pallas(jx, bias, mask, heads):
    rng = np.random.default_rng(0)
    q, k, v, phi_q, phi_k, slopes = _prefill_case(rng, *heads, bias)
    want = jx.ops.flash_attention(q, k, v, phi_q, phi_k, slopes,
                                mask_kind=mask, window=WINDOW,
                                impl="pallas_interpret", layout="bhsd",
                                block_q=16, block_k=16)
    got = flashbias_attention_torch(
        _t(q), _t(k), _t(v), _t(phi_q), _t(phi_k), _t(slopes),
        scale=D ** -0.5, mask_kind=mask, window=WINDOW)
    _close(got, want)


@pytest.mark.parametrize("heads", [(8, 8), (8, 2)], ids=["mha", "gqa4:1"])
@pytest.mark.parametrize("bias", ["alibi", "phi"])
def test_flash_decode_plain_matches_pallas(jx, bias, heads):
    h, kvh = heads
    s = 48
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, B + 1, 1, h, D), _rand(rng, B + 1, kvh, s, D), \
        _rand(rng, B + 1, kvh, s, D)
    lengths = np.array([0, 17, 48], np.int32)         # incl. an idle row
    kw_j, kw_t = {}, {}
    if bias == "phi":
        pq, pk = _rand(rng, B + 1, 1, h, R), _rand(rng, B + 1, kvh, s, R)
        kw_j = {"phi_q": pq, "phi_k": pk}
        kw_t = {"phi_q": _t(pq), "phi_k": _t(pk)}
    else:
        slopes = np.asarray(jx.bias.alibi_slopes(h))
        kw_j, kw_t = {"slopes": slopes}, {"slopes": _t(slopes)}
    want = jx.ops.flash_decode(q, k, v, jx.jnp.asarray(lengths), **kw_j,
                             impl="pallas_interpret", kv_layout="bhsd",
                             block_k=16)
    got = tops.flash_decode(_t(q), _t(k), _t(v), _t(lengths), **kw_t,
                            impl="torch")
    _close(got, want)
    assert not got[0].any()                            # length 0 -> zeros


@pytest.mark.parametrize("impl", ["dense", "chunked"])
@pytest.mark.parametrize("mask", ["causal", "local", "none"])
def test_core_attention_matches_reference(jx, impl, mask):
    rng = np.random.default_rng(2)
    m = 70
    q, k, v = _rand(rng, B, N, 4, D), _rand(rng, B, m, 2, D), \
        _rand(rng, B, m, 2, D)
    pq, pk = _rand(rng, B, N, 4, R), _rand(rng, B, m, 1, R)
    bias = _rand(rng, 1, 4, N, m)
    kw = dict(mask=jx.attn.MaskSpec(mask, WINDOW), q_offset=np.array([30, 3]),
              kv_length=np.array([70, 45]), impl=impl, chunk_size=32)
    want = jx.attn.attention(q, k, v, phi_q=pq, phi_k=pk, bias=bias, **{
        **kw, "q_offset": jx.jnp.asarray(kw["q_offset"]),
        "kv_length": jx.jnp.asarray(kw["kv_length"])})
    got = tattn.attention(
        _t(q), _t(k), _t(v), phi_q=_t(pq), phi_k=_t(pk), bias=_t(bias),
        **{**kw, "mask": tattn.MaskSpec(mask, WINDOW),
           "q_offset": _t(kw["q_offset"]), "kv_length": _t(kw["kv_length"])})
    _close(got, want)


@pytest.mark.parametrize("mask", ["causal", "local", "none"])
def test_mha_reference_matches_reference(jx, mask):
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, B, N, 4, D), _rand(rng, B, N, 2, D), \
        _rand(rng, B, N, 2, D)
    pq, pk = _rand(rng, B, N, 4, R), _rand(rng, B, N, 4, R)
    kw = dict(mask_kind=mask, window=WINDOW, kv_length=33)
    want = jx.ref.mha_reference(q, k, v, phi_q=pq, phi_k=pk, **kw)
    got = tref.mha_reference(_t(q), _t(k), _t(v), phi_q=_t(pq),
                             phi_k=_t(pk), **kw)
    _close(got, want)


def test_decode_reference_matches_reference(jx):
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 3, 1, 8, D), _rand(rng, 3, 30, 2, D), \
        _rand(rng, 3, 30, 2, D)
    lengths = np.array([30, 1, 12], np.int32)
    slopes = np.asarray(jx.bias.alibi_slopes(8))
    want = jx.ref.decode_reference(q, k, v, jx.jnp.asarray(lengths),
                                 slopes=jx.jnp.asarray(slopes))
    got = tref.decode_reference(_t(q), _t(k), _t(v), _t(lengths),
                                slopes=_t(slopes))
    _close(got, want)


@pytest.mark.parametrize("heads", [8, 50, 64])
def test_alibi_factorization_matches_reference(jx, heads):
    _close(tbias.alibi_slopes(heads), jx.bias.alibi_slopes(heads))
    pq_j, pk_j = jx.bias.alibi_factors(7, 9, heads, q_offset=3, k_offset=1)
    pq_t, pk_t = tbias.alibi_factors(7, 9, heads, q_offset=3, k_offset=1)
    _close(pq_t, pq_j)
    _close(pk_t, pk_j)
    dense = tbias.alibi_dense(7, 9, heads, q_offset=3, k_offset=1)
    _close(dense, jx.bias.alibi_dense(7, 9, heads, q_offset=3, k_offset=1))
    _close(torch.einsum("hnr,mr->hnm", pq_t, pk_t), dense)


@pytest.mark.parametrize("bias", ["alibi", "phi"])
def test_flash_attention_layouts_match_reference_xla(jx, bias):
    """ops.flash_attention in both layouts, with per-kv-head factors that
    must expand over their query groups, against the reference XLA path."""
    rng = np.random.default_rng(5)
    q, k, v = _rand(rng, B, N, 4, D), _rand(rng, B, N, 2, D), \
        _rand(rng, B, N, 2, D)
    kw_j = kw_t = {}
    if bias == "phi":
        pq, pk = _rand(rng, B, N, 4, R), _rand(rng, B, N, 2, R)
        kw_j, kw_t = {"phi_q": pq, "phi_k": pk}, {"phi_q": _t(pq),
                                                  "phi_k": _t(pk)}
    else:
        sl = np.asarray(jx.bias.alibi_slopes(4))
        kw_j, kw_t = {"slopes": sl}, {"slopes": _t(sl)}
    want = jx.ops.flash_attention(q, k, v, **kw_j, mask_kind="causal",
                                impl="xla")
    got = tops.flash_attention(_t(q), _t(k), _t(v), **kw_t,
                               mask_kind="causal", impl="torch")
    _close(got, want)
    hm = {key: val.transpose(1, 2) for key, val in kw_t.items()
          if key != "slopes"}
    got_hm = tops.flash_attention(
        _t(q).transpose(1, 2), _t(k).transpose(1, 2), _t(v).transpose(1, 2),
        **{**kw_t, **hm}, mask_kind="causal", impl="auto", layout="bhsd")
    _close(got_hm.transpose(1, 2), want)


def test_wrappers_take_the_plain_version_on_cpu():
    rng = np.random.default_rng(6)
    q, k, v, _, _, slopes = _prefill_case(rng, 4, 2, "alibi")
    before = (flashbias_attention_fwd.launches, flash_decode_fwd.launches)
    kw = dict(scale=0.25, mask_kind="causal")
    out = flashbias_attention_fwd(_t(q), _t(k), _t(v), slopes=_t(slopes), **kw)
    torch.testing.assert_close(out, flashbias_attention_torch(
        _t(q), _t(k), _t(v), slopes=_t(slopes), **kw), rtol=0, atol=0)
    lens = torch.tensor([3, 0], dtype=torch.int32)
    qd = _t(q)[:, :, :1].reshape(B, 2, 2, D)
    dec = flash_decode_fwd(qd, _t(k), _t(v), lens, scale=0.25)
    torch.testing.assert_close(dec, flash_decode_torch(qd, _t(k), _t(v), lens,
                                                       scale=0.25),
                               rtol=0, atol=0)
    assert (flashbias_attention_fwd.launches,
            flash_decode_fwd.launches) == before
    assert tops.resolve_impl("auto", torch.device("cpu")) == "torch"
    assert tops.resolve_impl("auto", torch.device("cuda")) == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", ["causal", "local", "none"])
@pytest.mark.parametrize("bias", ["alibi", "phi", "none"])
def test_flashbias_kernel_matches_plain_on_card(cuda, bias, mask, dtype):
    rng = np.random.default_rng(7)
    args = [None if x is None else _t(x).to(cuda)
            for x in _prefill_case(rng, 4, 2, bias)]
    args[:3] = [x.to(dtype) for x in args[:3]]
    kw = dict(scale=D ** -0.5, mask_kind=mask, window=WINDOW)
    before = flashbias_attention_fwd.launches
    tc = flashbias_attention_fwd.tensor_core_launches
    got = flashbias_attention_fwd(*args, **kw)
    want = flashbias_attention_torch(*args, **kw)
    torch.cuda.synchronize()
    assert flashbias_attention_fwd.launches == before + 1
    assert (flashbias_attention_fwd.tensor_core_launches - tc
            == (dtype == torch.bfloat16))
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6 * 4
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", ["alibi", "phi", "none"])
def test_flash_decode_kernel_matches_plain_on_card(cuda, bias, dtype):
    rng = np.random.default_rng(8)
    b, kvh, g, s = 4, 2, 4, 300
    q = _t(_rand(rng, b, kvh, g, D)).to(cuda, dtype)
    k = _t(_rand(rng, b, kvh, s, D)).to(cuda, dtype)
    v = _t(_rand(rng, b, kvh, s, D)).to(cuda, dtype)
    lens = torch.tensor([0, 1, 129, 300], dtype=torch.int32, device=cuda)
    kw = {"scale": D ** -0.5}
    if bias == "phi":
        kw["phi_q"] = _t(_rand(rng, b, kvh, g, R)).to(cuda)
        kw["phi_k"] = _t(_rand(rng, b, kvh, s, R)).to(cuda)
    elif bias == "alibi":
        kw["slopes"] = tbias.alibi_slopes(kvh * g, device=cuda).reshape(kvh, g)
    got = flash_decode_fwd(q, k, v, lens, **kw)
    want = flash_decode_torch(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6 * 4
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [16, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", ["alibi", "phi", "phi_kvh", "none"])
def test_flash_decode_paged_kernel_matches_plain_on_card(cuda, bias, dtype,
                                                         ps):
    """Pages in a random permutation, then garbage table entries (ids past
    the pool and negative ones): the kernel clamps them as the plain
    version does."""
    rng = np.random.default_rng(9)
    b, kvh, g, d = 4, 2, 4, 160
    lengths = [0, 1, 129, 300]
    live = -(-max(lengths) // ps)
    n_pages = b * live + 3
    q = _t(_rand(rng, b, kvh, g, d)).to(cuda, dtype)
    kp = _t(_rand(rng, kvh, n_pages, ps, d)).to(cuda, dtype)
    vp = _t(_rand(rng, kvh, n_pages, ps, d)).to(cuda, dtype)
    table = rng.permutation(n_pages)[:b * live].reshape(b, live)
    junk = rng.integers(-2, 2 * n_pages, (b, 4))
    pt = torch.tensor(np.concatenate([table, junk], 1), dtype=torch.int32,
                      device=cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kw = {"scale": d ** -0.5}
    if bias.startswith("phi"):
        lead = kvh if bias == "phi_kvh" else 1
        kw["phi_q"] = _t(_rand(rng, b, kvh, g, R)).to(cuda)
        kw["phi_pages"] = _t(_rand(rng, lead, n_pages, ps, R)).to(cuda)
    elif bias == "alibi":
        kw["slopes"] = tbias.alibi_slopes(kvh * g, device=cuda).reshape(kvh, g)
    before = flash_decode_paged_fwd.launches
    got = flash_decode_paged_fwd(q, kp, vp, lens, pt, **kw)
    want = flash_decode_paged_torch(q, kp, vp, lens, pt, **kw)
    torch.cuda.synchronize()
    assert flash_decode_paged_fwd.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6 * 4
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert not got[0].any()


# Lengths around the kernel's splits (128 keys at D 32, 32 at D 160: one
# split up to a span, several past it) and the whole cache.
SPLIT_LENGTHS = [0, 1, 63, 64, 65, 127, 128, 129, 777, 2048]
SPLIT_S = 2048


def _split_case(rng, cuda, layout, g, d, dtype, lengths, write):
    """Inputs of one split-boundary call: contiguous with ALiBi slopes, or
    paged (ps 16 / 48, pages permuted, junk table columns past the live
    ones) with phi factors on a shared slab. ``write`` adds the new rows;
    paged, the row of length 65 then finds the sentinel on the page its
    write lands on, and drops it."""
    b, kvh = len(lengths), 2
    q = _t(_rand(rng, b, kvh, g, d)).to(cuda, dtype)
    kw = {"scale": d ** -0.5}
    if layout == "contiguous":
        k = _t(_rand(rng, b, kvh, SPLIT_S, d)).to(cuda, dtype)
        v = _t(_rand(rng, b, kvh, SPLIT_S, d)).to(cuda, dtype)
        kw["slopes"] = tbias.alibi_slopes(kvh * g,
                                          device=cuda).reshape(kvh, g)
        args = (q, k, v)
    else:
        ps = int(layout[5:])
        live = -(-SPLIT_S // ps)
        n_pages = b * live + 3
        k = _t(_rand(rng, kvh, n_pages, ps, d)).to(cuda, dtype)
        v = _t(_rand(rng, kvh, n_pages, ps, d)).to(cuda, dtype)
        # the last page is no row's (a sentinel is clamped onto it)
        table = rng.permutation(n_pages - 1)[:b * live].reshape(b, live)
        table = np.concatenate([table, rng.integers(-2, 2 * n_pages, (b, 4))],
                               1)
        if write and 65 in lengths:
            table[lengths.index(65), 64 // ps] = n_pages
        kw["phi_q"] = _t(_rand(rng, b, kvh, g, R)).to(cuda)
        kw["phi_pages"] = _t(_rand(rng, 1, n_pages, ps, R)).to(cuda)
        kw["page_table"] = torch.tensor(table, dtype=torch.int32,
                                        device=cuda)
        args = (q, k, v)
    if write:
        kw["k_new"] = _t(_rand(rng, b, kvh, d)).to(cuda, dtype)
        kw["v_new"] = _t(_rand(rng, b, kvh, d)).to(cuda, dtype)
    return args, kw


def _split_call(fn, args, lengths, kw, cuda):
    """One call on copies of the caches; returns (output, k, v)."""
    q, k, v = args
    k, v = k.clone(), v.clone()
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kw = dict(kw)
    table = kw.pop("page_table", None)
    extra = () if table is None else (table,)
    out = fn(q, k, v, lens, *extra, **kw)
    torch.cuda.synchronize()
    return out, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("write", [False, True], ids=["read", "write"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 32), (4, 160)], ids=["g1d32", "g4d160"])
@pytest.mark.parametrize("layout", ["contiguous", "paged16", "paged48"])
def test_flash_decode_splits_on_card(cuda, layout, shape, dtype, write):
    """Lengths across split boundaries against the plain version (within
    the tolerance of the tests above); with the new rows, the caches after
    the call bit-equal to the plain version's; two calls bit-equal; and
    each row's output bit-equal when the other rows' lengths change."""
    g, d = shape
    rng = np.random.default_rng(10)
    args, kw = _split_case(rng, cuda, layout, g, d, dtype, SPLIT_LENGTHS,
                           write)
    if layout == "contiguous":
        fn, plain = flash_decode_fwd, flash_decode_torch
    else:
        fn, plain = flash_decode_paged_fwd, flash_decode_paged_torch
    before = fn.launches
    got, k_got, v_got = _split_call(fn, args, SPLIT_LENGTHS, kw, cuda)
    want, k_want, v_want = _split_call(plain, args, SPLIT_LENGTHS, kw, cuda)
    assert fn.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6 * 4
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert not got[0].any()
    assert torch.equal(k_got, k_want) and torch.equal(v_got, v_want)
    if write:
        assert not torch.equal(k_got, args[1])
    again, _, _ = _split_call(fn, args, SPLIT_LENGTHS, kw, cuda)
    assert torch.equal(again, got)
    keep = [3, 6, 8]
    others = [n if i in keep else max(0, SPLIT_S - n)
              for i, n in enumerate(SPLIT_LENGTHS)]
    moved, _, _ = _split_call(fn, args, others, kw, cuda)
    assert torch.equal(moved[keep], got[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_paged_repeated_page_on_card(cuda, dtype):
    """A table that names the written page twice, in different splits: the
    key of the first split on the written row reads the new row, as the
    plain version (write, then attend) does."""
    rng = np.random.default_rng(11)
    lengths, ps, d = [300, 40, 0], 16, 32
    args, kw = _split_case(rng, cuda, f"paged{ps}", 1, d, dtype,
                           lengths, True)
    table = kw["page_table"].clone()
    table[0, 0] = table[0, (lengths[0] - 1) // ps]
    kw["page_table"] = table
    got, k_got, v_got = _split_call(flash_decode_paged_fwd, args, lengths,
                                    kw, cuda)
    want, k_want, v_want = _split_call(flash_decode_paged_torch, args,
                                       lengths, kw, cuda)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6 * 4
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert torch.equal(k_got, k_want) and torch.equal(v_got, v_want)


# ---------------------------------------------------------------------------
# Kernel 2: the ragged batch (per-row key bound ``lengths``)
# ---------------------------------------------------------------------------

RAGGED_LENGTHS = [40, 17, 0, 33]      # full, not a tile multiple, empty


def _ragged_case(rng, bias, h=4, kvh=2):
    b = len(RAGGED_LENGTHS)
    q, k, v = _rand(rng, b, h, N, D), _rand(rng, b, kvh, N, D), \
        _rand(rng, b, kvh, N, D)
    phi_q = phi_k = slopes = None
    if bias == "phi":
        phi_q, phi_k = _rand(rng, b, h, N, R), _rand(rng, b, h, N, R)
    elif bias == "alibi":
        slopes = tbias.alibi_slopes(h).numpy()
    lengths = np.asarray(RAGGED_LENGTHS, np.int32)
    return q, k, v, phi_q, phi_k, slopes, lengths


def _ragged_plain(q, k, v, phi_q, phi_k, slopes, lengths, mask):
    return flashbias_attention_torch(
        _t(q), _t(k), _t(v), _t(phi_q), _t(phi_k), _t(slopes),
        scale=D ** -0.5, mask_kind=mask, lengths=_t(lengths))


@pytest.mark.parametrize("mask", ["none", "causal"])
@pytest.mark.parametrize("bias", ["phi", "alibi", "none"])
def test_ragged_plain_matches_pallas(jx, bias, mask):
    """The plain ragged version against the reference's ragged Pallas
    kernel (interpret mode). Without a mask every row is compared, the
    length-0 row included: both give 0 there. Under ``causal`` the
    reference kernel still visits the kv blocks the causal bound reaches
    for a length-0 row and returns the mean of v over its first block (its
    block pruning skips on the causal bound, not on the length), where the
    port gives 0 as for every row with no allowed key; that row is left
    out there (the serve path runs without a mask)."""
    rng = np.random.default_rng(11)
    case = _ragged_case(rng, bias)
    want = np.asarray(jx.ops.flash_attention(
        *case[:6], mask_kind=mask, impl="pallas_interpret", layout="bhsd",
        block_q=16, block_k=16, lengths=jx.jnp.asarray(case[6])))
    got = _ragged_plain(*case, mask).numpy()
    rows = case[6] > 0 if mask == "causal" else slice(None)
    _close(got[rows], want[rows])
    assert not got[2].any()


@pytest.mark.parametrize("mask", ["none", "causal"])
@pytest.mark.parametrize("bias", ["phi", "alibi", "none"])
def test_ragged_plain_matches_xla_on_live_rows(jx, bias, mask):
    """The same against the reference's XLA path, through both packages'
    ``flash_attention(lengths=)`` in the canonical layout. Rows with length
    0 are left out: there the XLA path returns the mean of v, the kernels 0
    (no result of the serve path depends on such a row)."""
    rng = np.random.default_rng(12)
    q, k, v, phi_q, phi_k, slopes, lengths = _ragged_case(rng, bias)
    bshd = [None if x is None else np.ascontiguousarray(x.transpose(0, 2, 1, 3))
            for x in (q, k, v, phi_q, phi_k)]
    want = np.asarray(jx.ops.flash_attention(
        *bshd, slopes, mask_kind=mask, impl="xla",
        lengths=jx.jnp.asarray(lengths)))
    got = tops.flash_attention(*[_t(x) for x in bshd], _t(slopes),
                               mask_kind=mask, impl="torch",
                               lengths=_t(lengths)).numpy()
    live = lengths > 0
    _close(got[live], want[live])
    plain = _ragged_plain(q, k, v, phi_q, phi_k, slopes, lengths, mask)
    _close(plain.transpose(1, 2)[live], want[live])


def test_ragged_wrapper_and_dispatch_on_cpu():
    """On CPU tensors the ragged wrapper runs the plain version (its own
    counter does not move, nor kernel 1's), ``impl="cuda"`` refuses inputs
    that require grad (the kernel is forward only), and the plain path is
    differentiable."""
    rng = np.random.default_rng(13)
    q, k, v, phi_q, phi_k, _, lengths = _ragged_case(rng, "phi")
    args = [_t(x) for x in (q, k, v, phi_q, phi_k)]
    before = (flashbias_attention_ragged_fwd.launches,
              flashbias_attention_fwd.launches)
    got = flashbias_attention_ragged_fwd(*args, None, _t(lengths),
                                         scale=D ** -0.5)
    torch.testing.assert_close(got, flashbias_attention_torch(
        *args, scale=D ** -0.5, lengths=_t(lengths)), rtol=0, atol=0)
    assert (flashbias_attention_ragged_fwd.launches,
            flashbias_attention_fwd.launches) == before
    qg = args[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        tops.flash_attention(qg, *args[1:], impl="cuda", layout="bhsd",
                             lengths=_t(lengths))
    out = tops.flash_attention(qg, *args[1:], impl="torch", layout="bhsd",
                               lengths=_t(lengths))
    out.square().sum().backward()
    assert torch.isfinite(qg.grad).all() and qg.grad.abs().sum() > 0
    with pytest.raises(ValueError, match="not both"):
        flashbias_attention_torch(*args, scale=1.0, kv_len=3,
                                  lengths=_t(lengths))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", ["none", "causal"])
@pytest.mark.parametrize("bias", ["phi", "alibi", "none"])
def test_ragged_kernel_matches_plain_on_card(cuda, bias, mask, dtype):
    rng = np.random.default_rng(14)
    case = [None if x is None else _t(x).to(cuda)
            for x in _ragged_case(rng, bias)]
    case[:3] = [x.to(dtype) for x in case[:3]]
    kw = dict(scale=D ** -0.5, mask_kind=mask)
    before = flashbias_attention_ragged_fwd.launches
    tc = flashbias_attention_ragged_fwd.tensor_core_launches
    got = flashbias_attention_ragged_fwd(*case, **kw)
    want = flashbias_attention_torch(*case[:6], lengths=case[6], **kw)
    torch.cuda.synchronize()
    assert flashbias_attention_ragged_fwd.launches == before + 1
    assert (flashbias_attention_ragged_fwd.tensor_core_launches - tc
            == (dtype == torch.bfloat16))
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6 * 4
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert not got[2].any()


def test_zero_padding_head_dim_and_rank_changes_no_logit():
    """The bf16 kernel's wrapper zero-pads q / k to a head dim that is a
    multiple of 8, v likewise (cutting the output's extra columns), and the
    factors to a rank that is a multiple of 4: the plain version shows
    that this leaves the result as it was."""
    rng = np.random.default_rng(15)
    q, k, v = (_t(_rand(rng, 2, 4, N, 5)) for _ in range(3))
    pq, pk = _t(_rand(rng, 2, 4, N, 3)), _t(_rand(rng, 2, 4, N, 3))
    kw = dict(scale=5 ** -0.5, mask_kind="causal")
    want = flashbias_attention_torch(q, k, v, pq, pk, **kw)
    pad = torch.nn.functional.pad
    got = flashbias_attention_torch(pad(q, (0, 3)), pad(k, (0, 3)),
                                    pad(v, (0, 3)), pad(pq, (0, 1)),
                                    pad(pk, (0, 1)), **kw)
    torch.testing.assert_close(got[..., :5], want, rtol=1e-6, atol=1e-6)
    assert not got[..., 5:].any()


# ---------------------------------------------------------------------------
# The bf16 tensor-core body at the serving paths' shapes and off its tiles
# ---------------------------------------------------------------------------

def _card_inputs(rng, cuda, b, h, kvh, n, d, dv, r, bias):
    q = _t(_rand(rng, b, h, n, d)).to(cuda, torch.bfloat16)
    k = _t(_rand(rng, b, kvh, n, d)).to(cuda, torch.bfloat16)
    v = _t(_rand(rng, b, kvh, n, dv)).to(cuda, torch.bfloat16)
    extra = {}
    if bias == "phi":                     # standard-normal float32 factors
        extra["phi_q"] = _t(_rand(rng, b, h, n, r)).to(cuda)
        extra["phi_k"] = _t(_rand(rng, b, h, n, r)).to(cuda)
    elif bias == "alibi":
        extra["slopes"] = tbias.alibi_slopes(h, device=cuda)
    return q, k, v, extra


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (4, 64, 64, 512, 32, 32, 0, "alibi", "causal"),    # kernel 1's path
    (2, 8, 8, 130, 32, 32, 0, "alibi", "causal"),      # N off the tile
    (2, 4, 2, 200, 40, 40, 4, "phi", "local"),         # D 40, R 4
    (1, 4, 4, 77, 40, 24, 0, "none", "none"),          # Dv 24 < D
    (2, 4, 4, 150, 96, 96, 96, "phi", "none"),         # R 96 factors
    (4, 16, 16, 512, 64, 64, 8, "phi", "causal"),      # phi, one warpgroup
], ids=["path-B4H64N512D32", "N130", "D40R4-local", "N77-D40-Dv24",
        "D96R96", "phi-large-grid"])
def test_tensor_core_kernel1_on_card(cuda, case):
    b, h, kvh, n, d, dv, r, bias, mask = case
    rng = np.random.default_rng(16)
    q, k, v, extra = _card_inputs(rng, cuda, b, h, kvh, n, d, dv, r, bias)
    kw = dict(scale=d ** -0.5, mask_kind=mask, window=48, **extra)
    tc = flashbias_attention_fwd.tensor_core_launches
    got = flashbias_attention_fwd(q, k, v, **kw)
    want = flashbias_attention_torch(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flashbias_attention_fwd.tensor_core_launches == tc + 1
    assert got.shape == want.shape and got.is_contiguous()
    tol = 2 ** -6 * 4                   # the bf16 tolerance above
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (384, 96, 96, [384, 200, 1, 0], "none"),    # kernel 2's path
    (384, 96, 96, [333, 77, 5, 0], "causal"),   # lengths off the tile
    (200, 40, 4, [200, 130, 63, 0], "none"),    # D 40, R 4
    (100, 64, 8, [100, 64, 65, 0], "none"),     # N off the tile
], ids=["path-N384D96R96", "lengths-off-tile-causal", "D40R4", "N100R8"])
def test_tensor_core_kernel2_on_card(cuda, case):
    n, d, r, lengths, mask = case
    rng = np.random.default_rng(17)
    q, k, v, extra = _card_inputs(rng, cuda, 4, 4, 4, n, d, d, r, "phi")
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kw = dict(scale=d ** -0.5, mask_kind=mask)
    tc = flashbias_attention_ragged_fwd.tensor_core_launches
    got = flashbias_attention_ragged_fwd(q, k, v, extra["phi_q"],
                                         extra["phi_k"], None, lens, **kw)
    want = flashbias_attention_torch(q, k, v, lengths=lens, **kw, **extra)
    torch.cuda.synchronize()
    assert flashbias_attention_ragged_fwd.tensor_core_launches == tc + 1
    tol = 2 ** -6 * 4                   # the bf16 tolerance above
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert not got[lens == 0].any()

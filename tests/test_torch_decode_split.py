"""The decode kernels' split-KV arithmetic and their fused row write, on the
CPU.

- A plain PyTorch emulation of the kernel's plan (each row's live keys cut
  into spans of ``split_span`` keys, a softmax per span, the spans merged
  by log-sum-exp in span order) against the plain versions
  (``flash_decode_torch`` / ``flash_decode_paged_torch``) and the
  reference's Pallas kernels in interpret mode, at float32 with ``atol
  3e-5``: lengths 0, 1, span - 1, span, span + 1 and the whole cache; G 1
  and 4; ALiBi, phi and no bias; contiguous and paged at page sizes 16 and
  48.
- Row independence: the emulated output of a row is bit-equal when the
  other rows' lengths change.
- The fused write: ``ops.flash_decode(..., k_new=, v_new=, impl="torch")``
  leaves the cache and the output equal to the write done first by the
  reference's rule and the decode call after it, with frozen rows, a
  sentinel table entry and a position whose block is past the table.

The emulation lives here, not in the package: the kernel is its only other
implementation, and the card tests hold that to the plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_decode import split_span

KVH, D, R = 2, 16, 3
SPAN = split_span(D, D, R, torch.float32)
S = 144                                   # a multiple of both page sizes
LENGTHS = [0, 1, SPAN - 1, SPAN, SPAN + 1, S]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def split_emulation(q, k, v, lengths, phi_q=None, phi_k=None, slopes=None,
                    *, scale, span):
    """The kernel's arithmetic over a contiguous view ``k, v (B, KVH, S,
    E)``: split z of row b holds keys [z * span, (z + 1) * span) below
    lengths[b]; a row with one split outputs acc / l, one with several
    merges (m, l, acc) in split order; a row of length 0 outputs 0."""
    s_len = k.shape[2]
    lens = lengths.long().clamp(0, s_len)
    pos = torch.arange(s_len)
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k.float()) * scale
    if phi_q is not None:
        s = s + torch.einsum("bkgr,bksr->bkgs", phi_q.float(), phi_k.float())
    if slopes is not None:
        rel = (pos[None] - (lens - 1)[:, None]).float()
        s = s + slopes.float()[None, :, :, None] * rel[:, None, None]
    nsplit = ((lens + span - 1) // span).clamp(min=1)
    m_run = torch.full(s.shape[:3], -torch.inf)
    l_run = torch.zeros(s.shape[:3])
    o_run = torch.zeros(s.shape[:3] + (v.shape[-1],))
    first = None
    for z in range(-(-s_len // span)):
        lo, hi = z * span, min((z + 1) * span, s_len)
        live = (pos[lo:hi][None] < lens[:, None])[:, None, None]   # B,1,1,n
        x = s[..., lo:hi]
        m = torch.where(live, x, -torch.inf).amax(-1)
        p = torch.where(live, torch.exp(x - m[..., None]), 0.0)
        l = p.sum(-1)
        acc = torch.einsum("bkgs,bkse->bkge", p, v[:, :, lo:hi].float())
        if first is None:
            first = acc / l[..., None]
        on = (z < nsplit)[:, None, None]
        mn = torch.where(on, torch.maximum(m_run, m), m_run)
        cm, cz = torch.exp(m_run - mn), torch.exp(m - mn)
        l_run = torch.where(on, l_run * cm + l * cz, l_run)
        o_run = torch.where(on[..., None],
                            o_run * cm[..., None] + acc * cz[..., None],
                            o_run)
        m_run = mn
    out = torch.where((nsplit == 1)[:, None, None, None], first,
                      o_run / l_run[..., None])
    return torch.where((lens > 0)[:, None, None, None], out, 0.0)


def paged_view(pool, table, lengths, ps):
    """Each row's logical view of a pool ``(H', n_pages, ps, E)``, pages
    resolved as the kernel resolves them: ``(B, H', P * ps, E)``."""
    n_pages, width = pool.shape[1], table.shape[1]
    last = (lengths.long() - 1).clamp(min=0) // ps
    blocks = torch.minimum(torch.arange(width)[None], last[:, None])
    pages = table.long().gather(1, blocks).clamp(0, n_pages - 1)
    rows = pool[:, pages].transpose(0, 1)
    return rows.reshape(len(lengths), pool.shape[0], width * ps, -1)


def _case(rng, layout, g, bias, lengths=LENGTHS):
    """numpy inputs of one case: q (B, 1, H, D), caches (contiguous) or
    pools and a page table with junk columns past the live ones (paged),
    and the bias as the reference takes it."""
    b, h = len(lengths), KVH * g
    q = rng.standard_normal((b, 1, h, D)).astype(np.float32)
    kw, table, ps = {}, None, None
    if layout == "contiguous":
        k = rng.standard_normal((b, KVH, S, D)).astype(np.float32)
        v = rng.standard_normal((b, KVH, S, D)).astype(np.float32)
    else:
        ps = int(layout[5:])
        live = S // ps
        n_pages = b * live + 2
        k = rng.standard_normal((KVH, n_pages, ps, D)).astype(np.float32)
        v = rng.standard_normal((KVH, n_pages, ps, D)).astype(np.float32)
        table = rng.permutation(n_pages)[:b * live].reshape(b, live)
        table = np.concatenate([table, rng.integers(-2, 2 * n_pages, (b, 3))],
                               1).astype(np.int32)
    if bias == "alibi":
        kw["slopes"] = (0.5 ** np.arange(1, h + 1)).astype(np.float32)
    elif bias == "phi":
        kw["phi_q"] = rng.standard_normal((b, 1, h, R)).astype(np.float32)
        kw["phi_k"] = (rng.standard_normal((b, KVH, S, R)) if table is None
                       else rng.standard_normal((k.shape[1], ps, R))
                       ).astype(np.float32)
    return q, k, v, table, ps, kw


def _emulate(q, k, v, lengths, table, ps, kw):
    """The emulation on the case's inputs, in the decode call's layouts:
    returns (B, 1, H, D)."""
    b, _, h, d = q.shape
    g = h // KVH
    qg = torch.from_numpy(q)[:, 0].reshape(b, KVH, g, d)
    lens = torch.from_numpy(lengths)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    ekw = {}
    if "slopes" in kw:
        ekw["slopes"] = torch.from_numpy(kw["slopes"]).reshape(KVH, g)
    if "phi_q" in kw:
        ekw["phi_q"] = torch.from_numpy(kw["phi_q"])[:, 0].reshape(b, KVH, g,
                                                                   R)
        ekw["phi_k"] = torch.from_numpy(kw["phi_k"])
    if table is not None:
        tt = torch.from_numpy(table)
        kt, vt = (paged_view(p, tt, lens, ps) for p in (kt, vt))
        if "phi_k" in ekw:
            ekw["phi_k"] = paged_view(ekw["phi_k"][None], tt, lens,
                                      ps).expand(b, KVH, -1, R)
    o = split_emulation(qg, kt, vt, lens, **ekw, scale=d ** -0.5, span=SPAN)
    return o.reshape(b, 1, h, d)


def test_span_is_a_function_of_static_shapes():
    assert SPAN == 128
    assert split_span(32, 32, 2, torch.bfloat16) == 128       # the LM path
    assert split_span(160, 160, 4, torch.bfloat16) == 32
    assert split_span(160, 160, 4, torch.float32) == 16
    assert split_span(256, 256, 0, torch.float32) == 16


@pytest.mark.parametrize("bias", ["alibi", "phi", "none"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("layout", ["contiguous", "paged16", "paged48"])
def test_split_emulation_matches_plain_and_pallas(layout, g, bias):
    rng = np.random.default_rng(20)
    q, k, v, table, ps, kw = _case(rng, layout, g, bias)
    lengths = np.array(LENGTHS, np.int32)
    got = _emulate(q, k, v, lengths, table, ps, kw)
    tkw = {name: torch.from_numpy(x) for name, x in kw.items()}
    paged = {} if table is None else {"page_table": torch.from_numpy(table)}
    plain = tops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(lengths),
                              **tkw, **paged, impl="torch")
    torch.testing.assert_close(got, plain, rtol=0, atol=3e-5)
    assert not got[0].any()
    jpaged = {} if table is None else {"page_table": jnp.asarray(table)}
    want = jops.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        kv_layout="bhsd", impl="pallas_interpret", block_k=16, **jpaged,
        **{name: jnp.asarray(x) for name, x in kw.items()})
    live = lengths > 0
    np.testing.assert_allclose(got.numpy()[live],
                               np.asarray(want, np.float32)[live], atol=3e-5)


@pytest.mark.parametrize("layout", ["contiguous", "paged16"])
def test_split_emulation_rows_are_independent(layout):
    """A row's output does not move when the other rows' lengths do."""
    rng = np.random.default_rng(21)
    q, k, v, table, ps, kw = _case(rng, layout, 4, "alibi")
    lengths = np.array(LENGTHS, np.int32)
    got = _emulate(q, k, v, lengths, table, ps, kw)
    keep = [2, 4]
    for seed in range(3):
        other = np.random.default_rng(seed).integers(0, S + 1, len(LENGTHS))
        other[keep] = lengths[keep]
        moved = _emulate(q, k, v, other.astype(np.int32), table, ps, kw)
        assert torch.equal(moved[keep], got[keep])


def _reference_write(k, v, lengths, k_new, v_new, table=None):
    """The reference's rule, row by row: rows with lengths > 0 write at
    lengths - 1; paged, on page table[b, min(pos // ps, P - 1)] unless it
    lies outside the pool (contiguous: unless pos is past the cache)."""
    for b, n in enumerate(lengths.tolist()):
        if n <= 0:
            continue
        pos = n - 1
        if table is None:
            if pos < k.shape[2]:
                k[b, :, pos], v[b, :, pos] = k_new[b], v_new[b]
            continue
        n_pages, ps = k.shape[1], k.shape[2]
        page = int(table[b, min(pos // ps, table.shape[1] - 1)])
        if 0 <= page < n_pages:
            k[:, page, pos % ps], v[:, page, pos % ps] = k_new[b], v_new[b]


@pytest.mark.parametrize("bias", ["alibi", "phi"])
@pytest.mark.parametrize("layout", ["contiguous", "paged4"])
def test_fused_write_equals_write_then_decode(layout, bias):
    """Frozen rows (length 0) write nothing; paged, a sentinel entry on the
    written block drops the write (the row then reads the clamped page's
    old row) and a position past the table's width writes on its last
    page."""
    rng = np.random.default_rng(22)
    g = 2
    if layout == "contiguous":
        lengths = np.array([0, 5, 64, 65, S, 0], np.int32)
        q, k, v, table, ps, kw = _case(rng, layout, g, bias, lengths)
    else:
        ps = 4
        lengths = np.array([0, 6, 9, 14, 3, 0], np.int32)
        b, h = len(lengths), KVH * g
        n_pages = 12
        q = rng.standard_normal((b, 1, h, D)).astype(np.float32)
        k = rng.standard_normal((KVH, n_pages, ps, D)).astype(np.float32)
        v = rng.standard_normal((KVH, n_pages, ps, D)).astype(np.float32)
        table = np.array([[1, 2, 3], [4, 5, n_pages], [6, 7, n_pages],
                          [8, 9, 10], [11, 0, -1], [1, 2, 3]], np.int32)
        table[2, 2] = n_pages     # pos 8: its block is the sentinel
        kw = {}
        if bias == "alibi":
            kw["slopes"] = (0.5 ** np.arange(1, h + 1)).astype(np.float32)
        else:
            kw["phi_q"] = rng.standard_normal((b, 1, h, R)).astype(np.float32)
            kw["phi_k"] = rng.standard_normal((n_pages, ps, R)
                                              ).astype(np.float32)
    k_new = torch.from_numpy(rng.standard_normal(
        (len(lengths), KVH, D)).astype(np.float32))
    v_new = torch.from_numpy(rng.standard_normal(
        (len(lengths), KVH, D)).astype(np.float32))
    tkw = {name: torch.from_numpy(x) for name, x in kw.items()}
    paged = {} if table is None else {"page_table": torch.from_numpy(table)}
    lens = torch.from_numpy(lengths)
    k_two, v_two = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    _reference_write(k_two, v_two, lens, k_new, v_new, table)
    want = tops.flash_decode(torch.from_numpy(q), k_two, v_two, lens, **tkw,
                             **paged, impl="torch")
    k_one, v_one = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = tops.flash_decode(torch.from_numpy(q), k_one, v_one, lens, **tkw,
                            **paged, impl="torch", k_new=k_new, v_new=v_new)
    assert torch.equal(k_one, k_two) and torch.equal(v_one, v_two)
    assert torch.equal(got, want)
    assert not torch.equal(k_one, torch.from_numpy(k))
    if table is not None:      # row 2's write fell on the sentinel
        assert not (k_one == k_new[2][:, None, None]).all(-1).any()

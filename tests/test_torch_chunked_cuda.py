"""Chunked prefill and prefix caching on the card (tests marked ``cuda``,
which skip without one; no JAX here, so they also run where it is absent):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_chunked_cuda.py

- ``flash_chunk_attention`` (plain ops, the admission path's attention) on
  the card against its CPU result, contiguous and paged, with ALiBi;
- a row frozen at length 0 while its prompt is mid-chunk keeps its cache
  rows (and paged, its pages and factor rows) bit-identical under the
  decode kernels, which write every other row's new token themselves;
- a page-aligned prefix-cache hit copies its shared page before the
  sharer's chunk and decode calls write: the indexed pages stay
  bit-identical, and the streams equal the unshared engine's.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (
    flash_decode_fwd,
    flash_decode_paged_fwd,
)
from repro_torch.models import get_model, init_params
from repro_torch.serve import SamplingParams, ServeEngine


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, ref) -> float:
    """float32: summation order only. bfloat16: both sides round the same
    float32 result once, so 2 bf16 ulps at the output's scale."""
    if dtype == torch.float32:
        return 1e-4
    return 2.0 ** -6 * max(1.0, float(ref.float().abs().max()))


def _chunk_inputs(rng, paged, dtype):
    b, c, kvh, g, d, s, ps = 3, 16, 2, 2, 32, 64, 8
    q = torch.tensor(rng.standard_normal((b, c, kvh * g, d)), dtype=dtype)
    offsets = np.array([0, 21, 48])
    chunk_lens = np.array([16, 9, 0])              # the last row frozen
    slopes = torch.tensor(rng.uniform(0.05, 0.5, kvh * g),
                          dtype=torch.float32)
    if not paged:
        k, v = (torch.tensor(rng.standard_normal((b, kvh, s, d)),
                             dtype=dtype) for _ in range(2))
        return (q, k, v, offsets, chunk_lens, slopes), {}
    n_pages = b * s // ps + 2
    k, v = (torch.tensor(rng.standard_normal((kvh, n_pages, ps, d)),
                         dtype=dtype) for _ in range(2))
    table = rng.permutation(n_pages)[:b * s // ps].reshape(b, s // ps)
    table[2, 3:] = n_pages                          # sentinel entries
    return (q, k, v, offsets, chunk_lens, slopes), {
        "page_table": torch.tensor(table, dtype=torch.int32)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_chunk_attention_on_card_matches_cpu(cuda, paged, dtype):
    args, kw = _chunk_inputs(np.random.default_rng(0), paged, dtype)
    want = ops.flash_chunk_attention(*args, **kw, kv_layout="bhsd")
    moved = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    got = ops.flash_chunk_attention(
        *moved, **{k: v.to(cuda) for k, v in kw.items()}, max_pages=8,
        kv_layout="bhsd")
    live = torch.arange(args[0].shape[1])[None, :] < torch.as_tensor(
        args[4])[:, None]                           # frozen rows unread
    err = float((got.cpu().float() - want.float())[live].abs().max())
    assert err <= _tol(dtype, want), err


def _engine_model(arch="stablelm_12b"):
    cfg = smoke_config(arch)
    return get_model(cfg), init_params(cfg, torch.Generator().manual_seed(0),
                                       device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_frozen_row_mid_chunk_stays_bit_identical_under_decode(cuda, paged):
    """Row 0 holds the first chunk of a prompt (length 0, final_lens -1);
    rows 1-2 decode through the kernel, which writes their new rows. Row 0's
    cache, and its length, must not move."""
    model, params = _engine_model()
    cfg = model.cfg
    params = _to(params, cuda)
    b, c, ps, max_len = 3, 8, 4, 32
    if paged:
        cache = model.init_paged_cache(b, 24, ps, max_len // ps, device=cuda)
        table = np.arange(24).reshape(b, 8)
        model.grow_page_table(cache, np.arange(b), table)
    else:
        cache = model.init_cache(b, max_len, device=cuda)
    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (b, c)), device=cuda)
    with torch.no_grad():
        # rows 1, 2: whole 5- and 7-token prompts; row 0: a prompt's first
        # chunk, mid-prompt
        _, cache = model.prefill_chunk(params, cache, toks,
                                       np.zeros(b, np.int64),
                                       np.array([c, 5, 7]),
                                       np.array([-1, 5, 7]))
        keys = (("pages_k", "pages_v", "pages_phi") if paged
                else ("k", "v"))
        before = {k: cache[k].clone() for k in keys}
        launches = (flash_decode_paged_fwd if paged
                    else flash_decode_fwd).launches
        tok = torch.tensor(rng.integers(0, cfg.vocab, (b, 1)), device=cuda)
        for _ in range(3):
            _, cache = model.decode(params, cache, tok,
                                    max_pages=max_len // ps)
    moved = (flash_decode_paged_fwd if paged
             else flash_decode_fwd).launches - launches
    assert moved == 3 * cfg.n_layers
    assert cache["length"].tolist() == [0, 8, 10]
    for k in keys:
        if not paged:
            now, old = cache[k][:, 0], before[k][:, 0]
        elif k == "pages_phi":                     # (n_pages, ps, 2)
            now, old = cache[k][table[0]], before[k][table[0]]
        else:                                      # (L, KVH, n_pages, ps, hd)
            now, old = cache[k][:, :, table[0]], before[k][:, :, table[0]]
        assert torch.equal(now, old), k
        assert not torch.equal(cache[k], before[k]), f"{k}: nothing written"


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
def test_cow_page_copied_before_the_sharer_writes(cuda):
    """Chunk 3 on pages of 4: a second request with the first's 8-token
    prompt matches both pages, re-runs positions [6, 8) into a private copy
    of page 1 (positions 4-5 come only from the copy), then decodes through
    the kernel. The indexed pages stay bit-identical and the streams equal
    the unshared engine's."""
    model, params = _engine_model()
    prompt = np.random.default_rng(3).integers(
        0, model.cfg.vocab, (8,)).astype(np.int32)

    def run(prefix_cache):
        eng = ServeEngine(model, params, max_len=32, n_slots=2, page_size=4,
                          pages_per_slot=8, prefill_chunk=3,
                          prefix_cache=prefix_cache, device=cuda)
        first = eng.submit(prompt, 6)
        eng.run()
        snap = None
        if prefix_cache:
            idx = eng.backend._prefix
            pages = sorted(e.page for e in idx._entries.values())
            cache = eng.backend._cache
            snap = (pages, [cache[k][:, :, pages].clone()
                            for k in ("pages_k", "pages_v")])
        second = eng.submit(prompt, 6,
                            sampling=SamplingParams(0.8, 5, seed=4))
        eng.run()
        return eng, [eng.result(r) for r in (first, second)], snap

    on, got, (pages, before) = run(True)
    _, want, _ = run(False)
    stats = on.page_stats()["prefix"]
    assert stats["cow_copies"] >= 1 and stats["tokens_matched"] == 8
    cache = on.backend._cache
    for k, old in zip(("pages_k", "pages_v"), before):
        assert torch.equal(cache[k][:, :, pages], old), k
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)

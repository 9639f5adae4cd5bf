"""The arithmetic of kernel 5's tensor-core body, emulated on the CPU.

``csrc/ssd_scan.cu`` runs the SSD chunk scan as four stages: the chunk
states ``S_c = (exp(cum_last - cum) dt X)^T B``, ``C B^T``, a pass over the
chunks that turns the states into the state before each chunk
(``h = exp(cum_last) h + S_c`` from ``h0``, ending in ``h_fin``), and the
scan ``Y = exp(cum_i) (C h_prev^T) + ((C B^T) . L . dt_j) X``. Every product
runs on bf16 tensor cores with float32 sums, each float32 operand split into
``hi = bf16(v)`` and ``lo = bf16(v - hi)`` and the product taken as
``hi.hi + hi.lo + lo.hi``. ``emulate`` below repeats those stages and that
precision in plain PyTorch (bf16 x has no lo part: its split gives lo = 0).

Inputs are made with numpy from a seed. The emulation is held, on y and the
final state, within ``1e-4 x max(1, max|ref|)`` (the card's float32 bound
for the kernel) against

- the reference's Pallas ``ssd_scan_fwd`` in interpret mode, as
  ``tests/test_torch_ssd.py`` runs it (it takes no h0 and S a multiple of
  the chunk: a ragged last chunk is padded with dt = 0, which computes the
  same), with the final state from the reference's scan;
- the reference's scan ``repro.models.ssd.ssd_scan`` where there is an h0;
- ``ssd_scan_torch``, the kernel's plain version, always.

bf16 x is compared before y's own bf16 rounding, against references run on
the same bf16 values in float32 (the card holds the rounded y at 2 bf16
ulps). A control drops the lo terms (single bf16 products) at N = 128,
Q = 256, the SSM path's state and chunk: its error exceeds the bound, so
the split is needed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan_fwd as pallas_ssd_scan
from repro.models import ssd as jssd
from repro_torch.kernels.ssd_scan import ssd_scan_torch

BOUND = 1e-4             # x max(1, max|ref|), the kernel's float32 tolerance


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def split(v: torch.Tensor):
    """float32 v as bf16 hi + lo, both returned as float32 values."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def product(a: torch.Tensor, b: torch.Tensor, lo: bool = True):
    """a @ b as the kernel's wgmma takes it: bf16 operands, float32 sums,
    hi.hi + hi.lo + lo.hi (hi.hi alone without ``lo``). A product of two
    bf16 values is exact in float32."""
    ah, al = split(a)
    bh, bl = split(b)
    out = ah @ bh
    if lo:
        out = out + ah @ bl + al @ bh
    return out


def emulate(x, dt, a, b, c, *, chunk, h0=None, lo=True):
    """The tensor-core body's stages on the kernel's layout: x (B, H, S, P),
    dt (B, H, S), a (H,), b / c (B, 1|H, S, N), h0 (B, H, P, N) or None.
    Returns float32 y (B, H, S, P) (before any rounding to x's dtype) and
    h_fin (B, H, P, N)."""
    x = x.float()
    bsz, h, s, p = x.shape
    n = b.shape[-1]
    b = b.float().expand(bsz, h, s, n)          # one group: read by every head
    c = c.float().expand(bsz, h, s, n)
    q = chunk
    nc = -(-s // q)
    pad = nc * q - s                             # past the last chunk: zeros
    x, b, c = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (x, b, c))
    dt = torch.nn.functional.pad(dt.float(), (0, pad))
    xc = x.reshape(bsz, h, nc, q, p)
    dtc = dt.reshape(bsz, h, nc, q)
    bc = b.reshape(bsz, h, nc, q, n)
    cc = c.reshape(bsz, h, nc, q, n)
    cum = torch.cumsum(dtc * a.float()[None, :, None, None], dim=-1)
    last = cum[..., -1:]

    # 1. chunk states, every chunk at once
    sdec = torch.exp(last - cum) * dtc
    states = product((sdec[..., None] * xc).transpose(-1, -2), bc, lo)
    decay = torch.exp(last[..., 0])              # (B, H, nc)

    # 2. the pass: the state before each chunk, then h_fin
    hc = torch.zeros((bsz, h, p, n)) if h0 is None else h0.float()
    h_prev = []
    for k in range(nc):
        h_prev.append(hc)
        hc = hc * decay[:, :, k, None, None] + states[:, :, k]
    h_prev = torch.stack(h_prev, dim=2)          # (B, H, nc, P, N)

    # 3. C B^T and the scan; exp only under the mask (j <= i)
    cb = product(cc, bc.transpose(-1, -2), lo)
    tri = torch.ones((q, q), dtype=torch.bool).tril()
    seg = torch.where(tri, cum[..., :, None] - cum[..., None, :],
                      torch.tensor(-math.inf))
    w = cb * torch.exp(seg) * dtc[..., None, :]
    y = (torch.exp(cum)[..., None] * product(cc, h_prev.transpose(-1, -2), lo)
         + product(w, xc, lo))
    return y.reshape(bsz, h, nc * q, p)[:, :, :s], hc


def _inputs(seed, bsz, s, h, p, n, heads_bc, bf16_x=False):
    """Kernel-layout numpy inputs: x (B,H,S,P) (bf16 values in float32 with
    ``bf16_x``), dt (B,H,S) softplus'd, a (H,) < 0, b / c (B,1|H,S,N)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, h, s, p)).astype(np.float32)
    if bf16_x:
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    dt = np.log1p(np.exp(rng.standard_normal((bsz, h, s)))).astype(np.float32)
    a = (-np.exp(0.3 * rng.standard_normal((h,)))).astype(np.float32)
    g = h if heads_bc else 1
    b = rng.standard_normal((bsz, g, s, n)).astype(np.float32)
    c = rng.standard_normal((bsz, g, s, n)).astype(np.float32)
    return x, dt, a, b, c


def _pallas(x, dt, a, b, c, chunk):
    """The reference's Pallas kernel in interpret mode on numpy kernel-layout
    inputs, S padded to the chunk with dt = 0; y cut back to S."""
    s = x.shape[2]
    pad = (-s) % chunk
    rows = ((0, 0), (0, 0), (0, pad), (0, 0))
    x, b, c = (np.pad(t, rows) for t in (x, b, c))
    dt = np.pad(dt, ((0, 0), (0, 0), (0, pad)))
    y = pallas_ssd_scan(jnp.asarray(x), jnp.asarray(dt[..., None]),
                        jnp.asarray(a[:, None]), jnp.asarray(b),
                        jnp.asarray(c), chunk=chunk, interpret=True)
    return np.asarray(y)[:, :, :s]


def _reference_scan(x, dt, a, b, c, chunk, h0):
    """The reference's model-layout scan (``repro.models.ssd.ssd_scan``), one
    head at a time for per-head b / c: y (B,H,S,P) and h_fin."""
    heads = x.shape[1]
    groups = [slice(None)] if b.shape[1] == 1 else \
        [slice(i, i + 1) for i in range(heads)]
    ys, hs = [], []
    for k, hd in enumerate(groups):
        g = 0 if b.shape[1] == 1 else k
        y, hf = jssd.ssd_scan(
            jnp.asarray(x[:, hd].transpose(0, 2, 1, 3)),
            jnp.asarray(dt[:, hd].transpose(0, 2, 1)), jnp.asarray(a[hd]),
            jnp.asarray(b[:, g]), jnp.asarray(c[:, g]), chunk=chunk,
            h0=None if h0 is None else jnp.asarray(h0[:, hd]))
        ys.append(np.asarray(y).transpose(0, 2, 1, 3))
        hs.append(np.asarray(hf))
    return np.concatenate(ys, axis=1), np.concatenate(hs, axis=1)


def _err(got, want):
    """max |got - want| and the bound 1e-4 x max(1, max|want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return (float(np.abs(got - want).max()),
            BOUND * max(1.0, float(np.abs(want).max())))


CASES = [
    # (name, B, S, H, P, N, chunk, b/c per head, h0, bf16 x)
    ("ragged last chunk, b/c shared", 2, 40, 3, 16, 16, 16, False, False,
     False),
    ("ragged last chunk, b/c per head", 2, 40, 3, 16, 16, 16, True, False,
     False),
    ("h0, b/c shared", 2, 37, 3, 8, 16, 16, False, True, False),
    ("h0, b/c per head", 1, 50, 2, 16, 8, 16, True, True, False),
    ("bf16 x, b/c shared", 2, 48, 2, 16, 16, 16, False, False, True),
    ("bf16 x, b/c per head, h0", 1, 45, 2, 8, 16, 16, True, True, True),
    ("chunk 64, one short chunk", 1, 100, 2, 16, 32, 64, False, False,
     False),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_emulation_matches_references(case):
    _, bsz, s, h, p, n, chunk, heads_bc, with_h0, bf16_x = case
    x, dt, a, b, c = _inputs(11, bsz, s, h, p, n, heads_bc, bf16_x)
    h0 = (np.random.default_rng(12).standard_normal((bsz, h, p, n))
          .astype(np.float32) if with_h0 else None)
    t = [torch.from_numpy(v) for v in (x, dt, a, b, c)]
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h_fin = emulate(*t, chunk=chunk, h0=th0)
    assert y.shape == (bsz, h, s, p) and h_fin.shape == (bsz, h, p, n)
    assert torch.isfinite(y).all() and torch.isfinite(h_fin).all()

    wants = {"ssd_scan_torch": ssd_scan_torch(*t, chunk=chunk, h0=th0)}
    if h0 is None:
        wants["pallas (interpret)"] = (
            _pallas(x, dt, a, b, c, chunk),
            _reference_scan(x, dt, a, b, c, chunk, None)[1])
    else:
        wants["reference scan"] = _reference_scan(x, dt, a, b, c, chunk, h0)
    for label, (y_ref, h_ref) in wants.items():
        err, bound = _err(y, y_ref)
        assert err <= bound, f"y vs {label}: {err:.3e} > {bound:.3e}"
        err, bound = _err(h_fin, h_ref)
        assert err <= bound, f"h_fin vs {label}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("lo", [True, False], ids=["split", "single bf16"])
def test_split_is_needed_at_the_path_state_and_chunk(lo):
    """N = 128, Q = 256 (mamba2-130m's state and chunk), two chunks: the
    split products stay within the bound; single bf16 products (the lo
    terms dropped) exceed it on y and on the final state."""
    x, dt, a, b, c = _inputs(13, 1, 512, 2, 16, 128, False)
    t = [torch.from_numpy(v) for v in (x, dt, a, b, c)]
    y_ref, h_ref = ssd_scan_torch(*t, chunk=256)
    y, h_fin = emulate(*t, chunk=256, lo=lo)
    (ey, by), (eh, bh) = _err(y, y_ref), _err(h_fin, h_ref)
    if lo:
        assert ey <= by and eh <= bh, (ey, by, eh, bh)
    else:
        assert ey > by and eh > bh, (ey, by, eh, bh)

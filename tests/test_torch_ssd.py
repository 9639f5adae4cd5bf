"""The port's SSD scan against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages:

- ``repro_torch.models.ssd.ssd_scan`` (the ``"torch"`` path of
  ``ops.ssd_scan``) against ``repro.models.ssd.ssd_scan`` on y and the
  final state, with and without ``h0``, at the ``(s, chunk)`` cases of
  ``tests/test_ssd.py`` (s 17 and 7 are off the chunk), float32 at
  ``rtol = atol = 1e-5`` (summation order only);
- ``ssd_decode_step`` continuing a scan, against the reference's;
- ``ssd_scan_torch`` (the plain version of kernel 5) against the
  reference's Pallas ``ssd_scan_fwd`` in interpret mode, as
  ``tests/test_ssd_kernel.py`` runs it: float32 at ``atol = 2e-4``, bf16
  (inputs quantized alike, y rounded alike) at ``rtol = atol = 3e-2``;
  its final state against the reference scan's at ``1e-5``;
- the dispatch: ``ops.ssd_scan(impl="cuda")`` raises on a CPU tensor, and
  the kernel wrapper takes the plain version there without counting a
  launch.

The CUDA kernel itself is held against ``ssd_scan_torch`` by
``tests/test_torch_ssd_kernel.py``, which needs the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan_fwd as pallas_ssd_scan
from repro.models import ssd as jssd
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_torch
from repro_torch.models import ssd as tssd

TOL = {"rtol": 1e-5, "atol": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, bsz, s, h, p, n, heads_bc=0):
    """x (B,S,H,P), dt (B,S,H) softplus'd, a (H,) < 0, b/c (B,S,N), or
    per head (B,S,H,N) with ``heads_bc``; numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, h)))).astype(np.float32)
    a = (-np.exp(0.3 * rng.standard_normal((h,)))).astype(np.float32)
    shape = (bsz, s, h, n) if heads_bc else (bsz, s, n)
    b = rng.standard_normal(shape).astype(np.float32)
    c = rng.standard_normal(shape).astype(np.float32)
    return x, dt, a, b, c


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=None", "h0"])
@pytest.mark.parametrize("s,chunk", [(16, 4), (17, 4), (32, 8), (7, 16)])
def test_ssd_scan_matches_reference(s, chunk, with_h0):
    x, dt, a, b, c = _inputs(0, 2, s, 3, 4, 5)
    h0 = (np.random.default_rng(1).standard_normal((2, 3, 4, 5))
          .astype(np.float32) if with_h0 else None)
    jy, jh = jssd.ssd_scan(*(jnp.asarray(v) for v in (x, dt, a, b, c)),
                           chunk=chunk,
                           h0=None if h0 is None else jnp.asarray(h0))
    ty, th = tssd.ssd_scan(*(_t(v) for v in (x, dt, a, b, c)), chunk=chunk,
                           h0=None if h0 is None else _t(h0))
    assert ty.shape == jy.shape and th.shape == jh.shape
    _close(ty, jy)
    _close(th, jh)
    # the "torch" impl of the dispatch is this function
    oy, oh = ops.ssd_scan(*(_t(v) for v in (x, dt, a, b, c)), chunk=chunk,
                          h0=None if h0 is None else _t(h0))
    assert torch.equal(oy, ty) and torch.equal(oh, th)


def test_decode_step_continues_scan():
    """Prefill of 9 tokens, then 3 decode steps, equal to one scan of 12 —
    and each step equal to the reference's."""
    x, dt, a, b, c = _inputs(2, 2, 12, 2, 4, 3)
    t = [_t(v) for v in (x, dt, a, b, c)]
    y_full, h_full = tssd.ssd_scan(*t, chunk=4)
    _, h = tssd.ssd_scan(t[0][:, :9], t[1][:, :9], t[2], t[3][:, :9],
                         t[4][:, :9], chunk=4)
    _, jh = jssd.ssd_scan(jnp.asarray(x[:, :9]), jnp.asarray(dt[:, :9]),
                          jnp.asarray(a), jnp.asarray(b[:, :9]),
                          jnp.asarray(c[:, :9]), chunk=4)
    for i in range(9, 12):
        y1, h = tssd.ssd_decode_step(h, t[0][:, i], t[1][:, i], t[2],
                                     t[3][:, i], t[4][:, i])
        jy1, jh = jssd.ssd_decode_step(jh, jnp.asarray(x[:, i]),
                                       jnp.asarray(dt[:, i]), jnp.asarray(a),
                                       jnp.asarray(b[:, i]),
                                       jnp.asarray(c[:, i]))
        _close(y1, y_full[:, i], rtol=1e-4, atol=1e-4)
        _close(y1, jy1)
        _close(h, jh)
    _close(h, h_full, rtol=1e-4, atol=1e-4)


def _kernel_layout(x, dt, a, b, c, heads_bc):
    """The kernel's layout: x (B,H,S,P), dt (B,H,S,1), a (H,1), b/c
    (B,1|H,S,N)."""
    bc = ((lambda m: m.transpose(0, 2, 1, 3)) if heads_bc
          else (lambda m: m[:, None]))
    return (x.transpose(0, 2, 1, 3), dt.transpose(0, 2, 1)[..., None],
            a[:, None], bc(b), bc(c))


@pytest.mark.parametrize("heads_bc", [0, 1], ids=["bc-shared", "bc-per-head"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk", [(16, 4), (32, 8), (64, 16)])
def test_plain_kernel_matches_pallas_kernel(s, chunk, dtype, heads_bc):
    x, dt, a, b, c = _inputs(3, 2, s, 3, 8, 4, heads_bc)
    jdt = jnp.dtype(dtype)
    kx, kdt, ka, kb, kc = _kernel_layout(x, dt, a, b, c, heads_bc)
    kx, kdt, kb, kc = (jnp.asarray(v).astype(jdt) for v in (kx, kdt, kb, kc))
    want = pallas_ssd_scan(kx, kdt, jnp.asarray(ka), kb, kc, chunk=chunk,
                           interpret=True)
    tdt = getattr(torch, dtype)
    kx, kdt, kb, kc = (_t(v.astype(jnp.float32)).to(tdt)
                       for v in (kx, kdt, kb, kc))
    got, h_fin = ssd_scan_torch(kx, kdt, _t(ka), kb, kc, chunk=chunk)
    assert got.dtype == tdt and got.shape == want.shape
    if dtype == "float32":
        _close(got.float(), want, atol=2e-4, rtol=0)
    else:
        _close(got.float(), want.astype(jnp.float32), rtol=3e-2, atol=3e-2)
    if not heads_bc and dtype == "float32":
        # the final state, which the TPU kernel keeps in scratch
        _, jh = jssd.ssd_scan(*(jnp.asarray(v) for v in (x, dt, a, b, c)),
                              chunk=chunk)
        _close(h_fin, jh)


def test_plain_kernel_state_carries_and_bounds_the_last_chunk():
    """A last chunk shorter than ``chunk`` (S = 23, chunk 8) and a nonzero
    h0: the plain kernel version equals the reference scan on y and h_fin."""
    x, dt, a, b, c = _inputs(4, 2, 23, 3, 4, 8)
    h0 = np.random.default_rng(5).standard_normal((2, 3, 4, 8)).astype(
        np.float32)
    jy, jh = jssd.ssd_scan(*(jnp.asarray(v) for v in (x, dt, a, b, c)),
                           chunk=8, h0=jnp.asarray(h0))
    kx, kdt, ka, kb, kc = _kernel_layout(x, dt, a, b, c, 0)
    y, h = ssd_scan_torch(*(_t(v) for v in (kx, kdt, ka, kb, kc)), chunk=8,
                          h0=_t(h0))
    _close(y.transpose(1, 2), jy)
    _close(h, jh)


def test_cuda_impl_on_a_cpu_tensor_raises():
    x, dt, a, b, c = _inputs(6, 1, 8, 2, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.ssd_scan(*(_t(v) for v in (x, dt, a, b, c)), chunk=4,
                     impl="cuda")


def test_wrapper_takes_the_plain_version_on_cpu():
    x, dt, a, b, c = _inputs(7, 2, 10, 2, 4, 4)
    args = [_t(v) for v in _kernel_layout(x, dt, a, b, c, 0)]
    before = ssd_scan_fwd.launches
    got = ssd_scan_fwd(*args, chunk=4)
    want = ssd_scan_torch(*args, chunk=4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ssd_scan_fwd.launches == before

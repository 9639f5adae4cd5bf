"""``ops.flash_attention``'s backward recomputed by blocks of query rows,
on the CPU.

``_FlashAttention.backward`` recomputes the plain attention and
differentiates it. Where the float32 ``(B, H, N, M)`` scores would pass
``ops.BWD_SCORE_BYTES`` it does so a block of query rows at a time (each
block's causal / local mask and ALiBi distances offset to its rows). Here
the budget is forced down so that 23 query rows split into blocks of 5
(the last one partial), and the gradients of q, k, v, the factors and the
slopes are held against the one-block backward for every mask kind, each
bias mode, GQA and a ``phi_k`` broadcast over heads and batch, and against
the reference's VJP (``repro.kernels.ops.flash_attention``, impl "xla").
Where one block covers N the gradients are bit for bit those of autograd
through the plain version (the parent's backward), and a checkpointed call
(the LM's remat) gives the same gradients.

Tolerances: float32 within 1e-5 of each gradient's scale (the blocked sums
add in another order); bf16 inputs within 2 bf16 ulps (2^-7) of the
gradient's scale (each path rounds the float32 gradient to bf16 once);
against the reference within 1e-4 of the scale (float32, the reference
recomputes in 512-key chunks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels.flashbias_attn import flashbias_attention_torch

B, H, KVH, N, M, D, R = 2, 4, 2, 23, 19, 8, 3
ROWS = 5
CASES = [(mask, bias) for mask in ("none", "causal", "local")
         for bias in ("none", "phi", "alibi")]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(bias, seed=0, broadcast=False):
    """Canonical bshd numpy inputs: q (B, N, H, D), k / v (B, M, KVH, D),
    factors phi_q (B, N, H, R), phi_k (B, M, H, R) or (1, M, 1, R)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    out = {"q": f(B, N, H, D), "k": f(B, M, KVH, D), "v": f(B, M, KVH, D)}
    if bias == "phi":
        out["phi_q"] = f(B, N, H, R)
        out["phi_k"] = f(1, M, 1, R) if broadcast else f(B, M, H, R)
    if bias == "alibi":
        out["slopes"] = rng.uniform(0.05, 0.5, (H,)).astype(np.float32)
    return out


def _grads(inputs, mask, dtype=torch.float32, rows=None, monkeypatch=None,
           window=4):
    """Output and gradients of ``ops.flash_attention`` (impl "torch") for a
    fixed output cotangent; ``rows`` forces the backward's block."""
    if rows is not None:
        monkeypatch.setattr(ops, "BWD_SCORE_BYTES", B * H * M * 4 * rows)
        assert ops.backward_block_rows(B, H, N, M) == rows
    leaves = {k: torch.from_numpy(v).to(dtype if k in "qkv" else
                                        torch.float32).requires_grad_(True)
              for k, v in inputs.items()}
    out = ops.flash_attention(leaves["q"], leaves["k"], leaves["v"],
                              leaves.get("phi_q"), leaves.get("phi_k"),
                              leaves.get("slopes"), mask_kind=mask,
                              window=window if mask == "local" else 0,
                              impl="torch")
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        out.shape).astype(np.float32)).to(out.dtype)
    out.backward(g)
    if monkeypatch is not None:
        monkeypatch.undo()
    return out.detach(), {k: t.grad for k, t in leaves.items()}


def _close(got, want, tol):
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        scale = max(1.0, float(want[key].float().abs().max()))
        err = float((got[key].float() - want[key].float()).abs().max())
        assert err <= tol * scale, (key, err, tol * scale)


@pytest.mark.parametrize("mask,bias", CASES)
def test_blocked_backward_equals_one_block(mask, bias, monkeypatch):
    inputs = _inputs(bias)
    out1, one = _grads(inputs, mask)
    out5, blocked = _grads(inputs, mask, rows=ROWS, monkeypatch=monkeypatch)
    assert torch.equal(out1, out5)
    assert set(blocked) == set(inputs)
    _close(blocked, one, 1e-5)


@pytest.mark.parametrize("mask", ["none", "causal"])
def test_blocked_backward_sums_a_broadcast_phi_k(mask, monkeypatch):
    """A ``phi_k (1, M, 1, R)`` shared by the batch and the heads gets its
    gradient summed back to its own shape."""
    inputs = _inputs("phi", seed=1, broadcast=True)
    _, one = _grads(inputs, mask)
    _, blocked = _grads(inputs, mask, rows=ROWS, monkeypatch=monkeypatch)
    assert tuple(blocked["phi_k"].shape) == (1, M, 1, R)
    _close(blocked, one, 1e-5)


@pytest.mark.parametrize("bias", ["phi", "alibi"])
def test_blocked_backward_bf16(bias, monkeypatch):
    """bf16 q / k / v (float32 factors and slopes): the blocked gradients
    come back in the inputs' dtypes, within 2 bf16 ulps of the one-block
    gradients."""
    inputs = _inputs(bias, seed=2)
    _, one = _grads(inputs, "causal", torch.bfloat16)
    _, blocked = _grads(inputs, "causal", torch.bfloat16, rows=ROWS,
                        monkeypatch=monkeypatch)
    assert blocked["q"].dtype == torch.bfloat16
    _close(blocked, one, 2.0 ** -7)


@pytest.mark.parametrize("mask,bias", [("causal", "alibi"), ("local", "phi"),
                                       ("none", "phi")])
def test_blocked_backward_matches_reference_vjp(mask, bias, monkeypatch):
    """Window 8 leaves every query row a key (23 rows over 19 keys): a row
    with none outputs 0 in the port, as the kernels' rows do, where the
    reference's XLA path averages v under its finite mask value."""
    inputs = _inputs(bias, seed=3)
    _, blocked = _grads(inputs, mask, rows=ROWS, monkeypatch=monkeypatch,
                        window=8)
    names = [k for k in ("q", "k", "v", "phi_q", "phi_k", "slopes")
             if k in inputs]
    g = np.random.default_rng(9).standard_normal((B, N, H, D)).astype(
        np.float32)

    def f(*args):
        kw = dict(zip(names, args))
        return jops.flash_attention(
            kw["q"], kw["k"], kw["v"], kw.get("phi_q"), kw.get("phi_k"),
            kw.get("slopes"), mask_kind=mask,
            window=8 if mask == "local" else 0, impl="xla")
    _, vjp = jax.vjp(f, *(jnp.asarray(inputs[k]) for k in names))
    want = {k: torch.from_numpy(np.array(v))
            for k, v in zip(names, vjp(jnp.asarray(g)))}
    _close(blocked, want, 1e-4)


@pytest.mark.parametrize("mask", ["none", "causal", "local"])
def test_plain_rows_with_offset_are_rows_of_the_whole(mask):
    """``flashbias_attention_torch`` on query rows ``lo:hi`` with
    ``q_offset=lo`` gives the whole call's rows: the mask and the ALiBi
    distances follow the offset."""
    rng = np.random.default_rng(4)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, k, v = t(B, H, N, D), t(B, KVH, M, D), t(B, KVH, M, D)
    slopes = torch.linspace(0.1, 0.4, H)
    kw = dict(scale=D ** -0.5, mask_kind=mask,
              window=4 if mask == "local" else 0)
    whole = flashbias_attention_torch(q, k, v, slopes=slopes, **kw)
    for lo, hi in ((0, 5), (5, 17), (17, N)):
        part = flashbias_attention_torch(q[:, :, lo:hi], k, v,
                                         slopes=slopes, q_offset=lo, **kw)
        torch.testing.assert_close(part, whole[:, :, lo:hi], rtol=0,
                                   atol=1e-6)


def test_block_rows_at_the_training_shapes():
    """GPT-2's training microbatch (B 2, H 64, N = M 1024: 0.5 GB of
    scores) recomputes in one block; the PDE solver at 32186 points (8
    heads: 33 GB) in blocks whose scores stay under the budget."""
    assert ops.backward_block_rows(2, 64, 1024, 1024) == 1024
    rows = ops.backward_block_rows(1, 8, 32186, 32186)
    assert 1 < rows < 32186
    assert 8 * rows * 32186 * 4 <= ops.BWD_SCORE_BYTES \
        < 8 * (rows + 1) * 32186 * 4
    assert ops.backward_block_rows(1, 1, 4, 2 ** 40) == 1


def test_blocked_backward_under_checkpoint(monkeypatch):
    """Recomputed under ``torch.utils.checkpoint`` (the LM's remat), the
    blocked backward gives the gradients it gives without it: it unpacks
    its saved tensors once, as a checkpointed Function must."""
    inputs = _inputs("alibi", seed=5)
    _, plain = _grads(inputs, "causal", rows=ROWS, monkeypatch=monkeypatch)
    monkeypatch.setattr(ops, "BWD_SCORE_BYTES", B * H * M * 4 * ROWS)
    leaves = [torch.from_numpy(inputs[k]).requires_grad_(True)
              for k in ("q", "k", "v", "slopes")]

    def fn(q, k, v, slopes):
        return ops.flash_attention(q, k, v, slopes=slopes, mask_kind="causal",
                                   impl="torch")
    out = torch.utils.checkpoint.checkpoint(fn, *leaves, use_reentrant=False)
    out.backward(torch.from_numpy(np.random.default_rng(9).standard_normal(
        out.shape).astype(np.float32)))
    _close({k: t.grad for k, t in zip(("q", "k", "v", "slopes"), leaves)},
           plain, 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", ["phi", "alibi"])
def test_one_block_backward_is_autograd_of_the_plain_version(bias, dtype):
    """Where one block covers N (GPT-2's training shape does: one block of
    1024 rows), the backward gives bit for bit the gradients of autograd
    through the plain version on the inputs themselves."""
    inputs = _inputs(bias, seed=6)
    got = _grads(inputs, "causal", dtype)[1]
    leaves = {k: torch.from_numpy(v).to(dtype if k in "qkv" else
                                        torch.float32).requires_grad_(True)
              for k, v in inputs.items()}
    hm = {k: (t.transpose(1, 2) if k != "slopes" else t)
          for k, t in leaves.items()}
    if bias == "phi":
        hm["phi_k"] = hm["phi_k"].expand(B, H, M, R)
    out = flashbias_attention_torch(
        hm["q"], hm["k"], hm["v"], hm.get("phi_q"), hm.get("phi_k"),
        hm.get("slopes"), scale=D ** -0.5, mask_kind="causal")
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, N, H, D)).astype(np.float32)).to(dtype)
    out.backward(g.transpose(1, 2))
    for key, t in leaves.items():
        assert torch.equal(got[key], t.grad), key

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

The backward kernel's plain version (``flashbias_attention_bwd_torch``:
from the output's cotangent and the forward's row log-sum-exp) is held
against autograd through the plain forward in the same cases; the
forward's ``return_lse`` against ``torch.logsumexp`` of
the plain scores (+inf for a row with no allowed key); the backward's route
(``ops.backward_route``) as a function of impl, dtype, the gradients asked
for and the widths; and the kernel route taken on the CPU (the wrapper runs
the plain version there) against the recompute. The reference's VJP holds
the recompute, the plain backward from lse and the kernel route on the CPU.

Tolerances: float32 within 1e-5 of each gradient's scale (the blocked sums
add in another order); bf16 inputs within 2 bf16 ulps (2^-7) of the
gradient's scale (each path rounds the float32 gradient to bf16 once);
against the reference within 1e-4 of the scale (float32, the reference
recomputes in 512-key chunks). The kernel route against the recompute on
bf16 inputs: within 2 bf16 ulps, as the blocked bf16 backward (both compute
in float32 and round each gradient once); against the reference on the same
bf16-rounded inputs, 2 bf16 ulps too (its gradients are float32, the port's
rounded to bf16 once).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flashbias_attn, ops
from repro_torch.kernels.flashbias_attn import (
    bwd_width, flashbias_attention_bwd_torch, flashbias_attention_torch)

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


VJP_CASES = [("causal", "alibi"), ("local", "phi"), ("none", "phi")]


def _route_grads(inputs, mask, route, window):
    """Gradients of q, k, v and the factors from the backward kernel's
    plain version on float32 inputs (``"plain_bwd"``: the forward's lse,
    then ``flashbias_attention_bwd_torch``), or through ``ops`` on the
    kernel route on the CPU (``"kernel_bf16"``: bf16 q / k / v on impl
    "cuda", which runs the same plain version through the wrapper), for
    ``_grads``' cotangent. Slopes are constants: neither takes their
    gradient."""
    bf16 = route == "kernel_bf16"
    leaves = {k: torch.from_numpy(v).to(torch.bfloat16 if bf16 and k in "qkv"
                                        else torch.float32)
              .requires_grad_(k != "slopes") for k, v in inputs.items()}
    kw = dict(mask_kind=mask, window=window if mask == "local" else 0)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, N, H, D)).astype(np.float32))
    if bf16:
        out = ops.flash_attention(leaves["q"], leaves["k"], leaves["v"],
                                  leaves.get("phi_q"), leaves.get("phi_k"),
                                  leaves.get("slopes"), impl="cuda", **kw)
        out.backward(g.to(out.dtype))
        return {k: t.grad for k, t in leaves.items() if k != "slopes"}
    hm = {k: (t.detach().transpose(1, 2) if k != "slopes" else t)
          for k, t in leaves.items()}
    _, lse = flashbias_attention_torch(
        hm["q"], hm["k"], hm["v"], hm.get("phi_q"), hm.get("phi_k"),
        hm.get("slopes"), scale=D ** -0.5, return_lse=True, **kw)
    got = flashbias_attention_bwd_torch(
        hm["q"], hm["k"], hm["v"], g.transpose(1, 2), lse, hm.get("phi_q"),
        hm.get("phi_k"), hm.get("slopes"), scale=D ** -0.5, **kw)
    got = dict(zip(("q", "k", "v", "phi_q", "phi_k"), got))
    return {k: t.transpose(1, 2) for k, t in got.items() if t is not None}


@pytest.mark.parametrize("mask,bias,route", [
    pytest.param(mask, bias, route,
                 id=f"{mask}-{bias}" + ("" if route == "recompute"
                                        else f"-{route}"))
    for route in ("recompute", "plain_bwd", "kernel_bf16")
    for mask, bias in VJP_CASES])
def test_blocked_backward_matches_reference_vjp(mask, bias, route,
                                                monkeypatch):
    """Window 8 leaves every query row a key (23 rows over 19 keys): a row
    with none outputs 0 in the port, as the kernels' rows do, where the
    reference's XLA path averages v under its finite mask value. The
    backward's three forms against the reference's VJP: the blocked
    recompute (``"recompute"``), the backward kernel's plain version from
    the forward's lse (``"plain_bwd"``), both float32 within 1e-4; and the
    kernel route on bf16 inputs (``"kernel_bf16"``), against the reference
    on the same bf16-rounded inputs within 2 bf16 ulps."""
    inputs = _inputs(bias, seed=3)
    if route == "kernel_bf16":
        inputs = {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy()
                  if k in "qkv" else v for k, v in inputs.items()}
    if route == "recompute":
        _, got = _grads(inputs, mask, rows=ROWS, monkeypatch=monkeypatch,
                        window=8)
    else:
        got = _route_grads(inputs, mask, route, window=8)
    names = [k for k in ("q", "k", "v", "phi_q", "phi_k", "slopes")
             if k in inputs]
    g = np.random.default_rng(9).standard_normal((B, N, H, D)).astype(
        np.float32)
    if route == "kernel_bf16":
        g = torch.from_numpy(g).to(torch.bfloat16).float().numpy()

    def f(*args):
        kw = dict(zip(names, args))
        return jops.flash_attention(
            kw["q"], kw["k"], kw["v"], kw.get("phi_q"), kw.get("phi_k"),
            kw.get("slopes"), mask_kind=mask,
            window=8 if mask == "local" else 0, impl="xla")
    _, vjp = jax.vjp(f, *(jnp.asarray(inputs[k]) for k in names))
    want = {k: torch.from_numpy(np.array(v))
            for k, v in zip(names, vjp(jnp.asarray(g))) if k in got}
    assert set(want) == set(got) == set(names) - (
        set() if route == "recompute" else {"slopes"})
    if route == "kernel_bf16":
        want = {k: t.to(got[k].dtype) for k, t in want.items()}
        _close(got, want, 2.0 ** -7)
    else:
        _close(got, want, 1e-4)


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


def _head_major(inputs):
    """Float32 leaves of ``_inputs`` in the kernels' head-major layout, the
    key factor expanded over the batch and heads as ``ops`` passes it."""
    hm = {k: torch.from_numpy(v).requires_grad_(True) for k, v in inputs.items()}
    leaves = dict(hm)
    for k in ("q", "k", "v", "phi_q", "phi_k"):
        if k in hm:
            hm[k] = hm[k].transpose(1, 2)
    if "phi_k" in hm:
        hm["phi_k"] = hm["phi_k"].expand(B, H, M, R)
    return leaves, hm


@pytest.mark.parametrize("mask,bias,broadcast", [
    (mask, bias, False) for mask, bias in CASES] + [
    (mask, "phi", True) for mask in ("none", "causal", "local")])
def test_plain_bwd_from_lse_matches_autograd(mask, bias, broadcast):
    """``flashbias_attention_bwd_torch`` (P from the forward's lse, Delta
    = rowsum(P * dP)) against autograd through the plain
    forward: GQA (4 heads over 2), each mask and bias mode, and a ``phi_k``
    per head or shared by the batch and heads (its gradient summed back by
    the expand's backward)."""
    inputs = _inputs(bias, seed=7, broadcast=broadcast)
    leaves, hm = _head_major(inputs)
    kw = dict(scale=D ** -0.5, mask_kind=mask,
              window=4 if mask == "local" else 0)
    o, lse = flashbias_attention_torch(hm["q"], hm["k"], hm["v"],
                                       hm.get("phi_q"), hm.get("phi_k"),
                                       hm.get("slopes"), return_lse=True, **kw)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        o.shape).astype(np.float32))
    names = [k for k in ("q", "k", "v", "phi_q", "phi_k") if k in leaves]
    want = dict(zip(names, torch.autograd.grad(o, [hm[k] for k in names], g)))
    got = flashbias_attention_bwd_torch(
        *(hm[k].detach() for k in ("q", "k", "v")), g, lse.detach(),
        *(None if hm.get(k) is None else hm[k].detach()
          for k in ("phi_q", "phi_k", "slopes")), **kw)
    got = dict(zip(("q", "k", "v", "phi_q", "phi_k"), got))
    assert {k for k, t in got.items() if t is not None} == set(names)
    if "phi_k" in want:   # autograd's is the expanded factor's gradient
        assert got["phi_k"].shape == want["phi_k"].shape == (B, H, M, R)
    _close({k: got[k] for k in names}, want, 1e-5)


def test_plain_bwd_skips_what_needs_asks_none_of():
    inputs = _inputs("phi", seed=8)
    _, hm = _head_major(inputs)
    hm = {k: t.detach() for k, t in hm.items()}
    o, lse = flashbias_attention_torch(hm["q"], hm["k"], hm["v"], hm["phi_q"],
                                       hm["phi_k"], scale=0.3, return_lse=True)
    got = flashbias_attention_bwd_torch(
        hm["q"], hm["k"], hm["v"], torch.ones_like(o), lse, hm["phi_q"],
        hm["phi_k"], scale=0.3, needs=(True, False, False, True, False))
    assert [t is not None for t in got] == [True, False, False, True, False]


@pytest.mark.parametrize("mask", ["none", "causal", "local"])
@pytest.mark.parametrize("bias", ["phi", "alibi"])
def test_forward_lse_is_the_logsumexp_of_the_scores(mask, bias):
    """``return_lse`` gives ``torch.logsumexp`` of the masked float32
    scores, and +inf on the rows that see no key (a ragged row of length 0;
    with ``q_offset`` the rows' own mask)."""
    inputs = _inputs(bias, seed=10)
    _, hm = _head_major(inputs)
    hm = {k: t.detach() for k, t in hm.items()}
    kw = dict(scale=D ** -0.5, mask_kind=mask,
              window=3 if mask == "local" else 0)
    lengths = torch.tensor([M, 0])
    o, lse = flashbias_attention_torch(
        hm["q"], hm["k"], hm["v"], hm.get("phi_q"), hm.get("phi_k"),
        hm.get("slopes"), lengths=lengths, return_lse=True, **kw)
    assert torch.equal(o, flashbias_attention_torch(
        hm["q"], hm["k"], hm["v"], hm.get("phi_q"), hm.get("phi_k"),
        hm.get("slopes"), lengths=lengths, **kw))
    kf = hm["k"].repeat_interleave(H // KVH, dim=1)
    s = torch.einsum("bhnd,bhmd->bhnm", hm["q"], kf) * kw["scale"]
    if bias == "phi":
        s = s + torch.einsum("bhnr,bhmr->bhnm", hm["phi_q"], hm["phi_k"])
    else:
        rel = (torch.arange(M)[None, :] - torch.arange(N)[:, None]).float()
        s = s + hm["slopes"][:, None, None] * rel
    allowed = flashbias_attn._allowed(N, M, mask, kw["window"], M, "cpu")
    want = torch.logsumexp(s.masked_fill(~allowed, -float("inf")), dim=-1)
    want = want.masked_fill(~allowed.any(-1), float("inf"))
    torch.testing.assert_close(lse[0], want[0], rtol=1e-5, atol=1e-5)
    assert torch.isinf(lse[1]).all() and (lse[1] > 0).all()


ROUTES = [
    # impl, dtype, needs (q, k, v, phi_q, phi_k, slopes), D, Dv, R, route
    ("cuda", torch.bfloat16, (1, 1, 1, 1, 0, 0), 16, 16, 9, "kernel"),
    ("cuda", torch.bfloat16, (1, 1, 1, 0, 0, 0), 32, 32, 0, "kernel"),
    ("cuda", torch.bfloat16, (1, 1, 1, 1, 1, 0), 96, 96, 96, "kernel"),
    ("cuda", torch.bfloat16, (0, 0, 0, 1, 0, 0), 128, 128, 0, "kernel"),
    ("cuda", torch.bfloat16, (1, 1, 1, 0, 0, 1), 32, 32, 0, "recompute"),
    ("cuda", torch.float32, (1, 1, 1, 1, 0, 0), 16, 16, 9, "recompute"),
    ("cuda", torch.bfloat16, (0, 0, 0, 0, 0, 0), 16, 16, 9, "recompute"),
    ("cuda", torch.bfloat16, (1, 1, 1, 1, 1, 0), 96, 96, 100, "recompute"),
    ("cuda", torch.bfloat16, (1, 1, 1, 0, 0, 0), 192, 192, 0, "recompute"),
    ("torch", torch.bfloat16, (1, 1, 1, 1, 0, 0), 16, 16, 9, "recompute"),
    ("io_stub", torch.bfloat16, (1, 1, 1, 1, 0, 0), 16, 16, 9, "recompute"),
]


@pytest.mark.parametrize("impl,dtype,needs,d,dv,r,route", ROUTES)
def test_backward_route(impl, dtype, needs, d, dv, r, route):
    """The route is a function of the impl, q's dtype, the gradients asked
    for and the widths: the kernel for bf16 on "cuda" with no slopes'
    gradient at widths it fits (padded to 16, 32, 64, 96 or 128, at most 96
    with factors); the recompute for everything else."""
    assert ops.backward_route(impl, dtype, tuple(map(bool, needs)), d, dv,
                              r) == route


def test_bwd_width_pads_to_the_built_widths():
    assert [bwd_width(d, d, 0) for d in (8, 16, 24, 48, 72, 112, 128, 136)] \
        == [16, 16, 32, 64, 96, 128, 128, None]
    assert bwd_width(16, 16, 9) == 16 and bwd_width(16, 16, 40) == 64
    assert bwd_width(96, 96, 96) == 96 and bwd_width(128, 128, 8) is None


@pytest.mark.parametrize("bias", ["phi", "alibi"])
def test_kernel_route_on_the_cpu_matches_the_recompute(bias, monkeypatch):
    """bf16 inputs on impl "cuda" take the kernel route on a CPU tensor
    too, where the wrappers run their plain versions: the forward saves its
    output and lse, the backward wrapper runs once and ``_recompute_grads``
    never; the gradients agree with the recompute's (impl "torch") within
    2 bf16 ulps of their scale. The ALiBi case's slopes are constants: the
    kernel route takes no slopes' gradient."""
    inputs = _inputs(bias, seed=11)
    calls = []
    orig = ops.flashbias_attention_bwd

    def counted(*args, **kw):
        calls.append(kw["needs"])
        return orig(*args, **kw)

    def refused(*args, **kw):
        raise AssertionError("the kernel route recomputed")

    grads = {}
    for impl in ("cuda", "torch"):
        leaves = {k: torch.from_numpy(v).to(
            torch.bfloat16 if k in "qkv" else torch.float32).requires_grad_(
                k != "slopes") for k, v in inputs.items()}
        with monkeypatch.context() as mp:
            if impl == "cuda":
                mp.setattr(ops, "flashbias_attention_bwd", counted)
                mp.setattr(ops, "_recompute_grads", refused)
            out = ops.flash_attention(
                leaves["q"], leaves["k"], leaves["v"], leaves.get("phi_q"),
                leaves.get("phi_k"), leaves.get("slopes"),
                mask_kind="causal", impl=impl)
            out.float().backward(torch.from_numpy(np.random.default_rng(
                9).standard_normal(out.shape).astype(np.float32)))
        grads[impl] = {k: t.grad for k, t in leaves.items() if k != "slopes"}
    assert calls == [(True, True, True, bias == "phi", bias == "phi")]
    _close(grads["cuda"], grads["torch"], 2.0 ** -7)

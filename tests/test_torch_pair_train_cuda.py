"""The training path's kernel-1 calls on the card (tests marked ``cuda``,
which skip without one; no JAX here, so they also run where it is
absent):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_pair_train_cuda.py

- The Pairformer at full width (``pairformer_lite``: d 384, d_pair 128, 4
  heads x 96, R 96, factor MLPs of hidden 256, bf16 compute, float32
  masters), 2 of its 16 layers, one complex of 384 residues: the loss and
  the gradients of the trunk and the factor MLPs on the kernel path
  (kernel 1 in phi mode, launched once per layer) against the plain path
  (``attn_impl="torch"``, never launched).
- The PDE solver whole (8 layers, d 128, 8 heads x 16, rank 9, bf16) on
  8192 points, the same comparison (kernel 1 once per layer).
- The query-blocked backward on the card (float32, 3000 rows over 3000
  keys, the budget forced to 700-row blocks) against the one-block
  backward, at the PDE's head count and rank with ``phi_k`` shared by the
  heads.

Tolerances: the bf16 paths' losses within 1e-3 relative and every leaf's
gradient norm within 1e-2 relative (bf16 roundings of the attention
output, propagated through the layers; ``chip_smoke.py``'s training
bounds), relative to at least 1e-6 of the largest leaf norm; the blocked
backward within 1e-5 of each gradient's scale (float32 sums in another
order).
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flashbias_attn import flashbias_attention_fwd
from repro_torch.models import init_params, pairformer, pde
from repro_torch.models.common import materialize, stack_layers, tree_map

pytestmark = pytest.mark.cuda

LOSS_RTOL, NORM_RTOL, NORM_FLOOR = 1e-3, 1e-2, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_named(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _loss_and_norms(loss_fn, *trees):
    """The loss and every leaf's gradient norm (0 where the loss does not
    reach the leaf), with kernel 1's launches counted."""
    leaves = [tree_map(lambda p: p.detach().clone().requires_grad_(True), t)
              for t in trees]
    before = flashbias_attention_fwd.launches
    loss = loss_fn(*leaves)
    loss.backward()
    launches = flashbias_attention_fwd.launches - before
    norms = {}
    for i, tree in enumerate(leaves):
        for name, t in _named(tree).items():
            norms[f"{i}{name}"] = (0.0 if t.grad is None else float(
                torch.linalg.vector_norm(t.grad.float())))
    return float(loss.detach()), norms, launches


def _agree(kernel, plain):
    """Losses within LOSS_RTOL; each leaf's gradient norm within NORM_RTOL
    of the larger of its norm and NORM_FLOOR x the largest leaf norm: a
    leaf whose gradient vanishes analytically (the bias of the last layer
    of the phi_k MLP shifts every key's factor by one vector, which moves
    each query's logits by a constant the softmax ignores) holds rounding
    noise only (2e-10 against norms of 1e-2 on the card)."""
    (lk, nk, _), (lt, nt, _) = kernel, plain
    assert abs(lk - lt) <= LOSS_RTOL * abs(lt), (lk, lt)
    floor = NORM_FLOOR * max(nt.values())
    for name, n in nt.items():
        assert abs(nk[name] - n) <= NORM_RTOL * max(n, floor), (
            name, nk[name], n)


def test_pairformer_kernel_path_grads_match_plain(cuda):
    cfg = get_config("pairformer_lite").replace(n_layers=2)
    assert (cfg.d_model, cfg.d_pair, cfg.n_heads, cfg.resolved_head_dim,
            cfg.bias_rank, cfg.dtype) == (384, 128, 4, 96, 96, "bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    factors = materialize(stack_layers(pairformer.factor_mlp_template(
        cfg, 256), cfg.n_layers), gen, device="cuda")
    batch = {"feats": torch.randn((1, 384, 64), generator=gen, device="cuda"),
             "coords": torch.randn((1, 384, 3), generator=gen,
                                   device="cuda")}
    runs = {impl: _loss_and_norms(
        lambda p, f, c=cfg.replace(attn_impl=impl):
            pairformer.denoise_loss(p, batch, c, f), params, factors)
        for impl in ("cuda", "torch")}
    assert runs["cuda"][2] == cfg.n_layers and runs["torch"][2] == 0
    _agree(runs["cuda"], runs["torch"])


def test_pde_kernel_path_grads_match_plain(cuda):
    cfg = get_config("pde_solver")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_params(cfg, gen, device="cuda")
    batch = {"coords": torch.rand((1, 8192, 3), generator=gen, device="cuda"),
             "targets": torch.randn((1, 8192, 4), generator=gen,
                                    device="cuda")}
    runs = {impl: _loss_and_norms(
        lambda p, c=cfg.replace(attn_impl=impl):
            pde.regression_loss(p, batch, c), params)
        for impl in ("cuda", "torch")}
    assert runs["cuda"][2] == cfg.n_layers and runs["torch"][2] == 0
    _agree(runs["cuda"], runs["torch"])


def test_blocked_backward_on_the_card(cuda, monkeypatch):
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, h, n, d, r = 1, 8, 3000, 16, 9
    t = lambda *s: torch.randn(s, generator=gen, device="cuda")
    inputs = [t(b, h, n, d), t(b, h, n, d), t(b, h, n, d), t(b, h, n, r),
              t(b, 1, n, r)]

    def grads():
        leaves = [x.clone().requires_grad_(True) for x in inputs]
        q, k, v, pq, pk = leaves
        out = ops.flash_attention(q, k, v, pq, pk.expand(b, h, n, r),
                                  impl="cuda", layout="bhsd")
        out.backward(torch.ones_like(out))
        return [x.grad for x in leaves]

    one = grads()
    monkeypatch.setattr(ops, "BWD_SCORE_BYTES", b * h * n * 4 * 700)
    assert ops.backward_block_rows(b, h, n, n) == 700
    blocked = grads()
    for g1, g2 in zip(one, blocked):
        scale = max(1.0, float(g1.abs().max()))
        assert float((g1 - g2).abs().max()) <= 1e-5 * scale

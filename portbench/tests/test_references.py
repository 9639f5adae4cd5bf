"""Each plain reference against the program at its reduced (smoke) size on
the CPU, in float32: the references compute what the program computes.
The control's float8 arithmetic departs from them by far more."""
import pytest
import torch

from portbench import harness, inputs, port, weights
from portbench.reference import adamw, arith, pde

F32, LOWP = arith.Arith(False), arith.Arith(True)


def _ctx(cell, **over):
    return harness.context(cell, 11, 0.1, False, device="cpu", smoke=True,
                           traffic_overrides=over)


def _weights(ctx, dtype=torch.float32):
    return weights.make(ctx.layout, ctx.seed_for("weights"), ctx.device,
                        dtype)


def _gap(a, b):
    return float((a - b).norm() / b.norm())


def test_pde_forward_and_loss():
    ctx = _ctx("pde_solver.train")
    p = _weights(ctx)
    b = inputs.mesh_batch(ctx.seed, 0, 1, 96, 3, 4, "cpu")
    got = ctx.family().forward(ctx.cfg)(p, b["coords"])
    want = pde.forward(p, b["coords"], ctx.spec, F32)
    assert _gap(got, want) < 1e-5
    loss = port.model(ctx.cfg).loss(p, b)
    assert float(loss) == pytest.approx(
        float(pde.loss(p, b, ctx.spec, F32)), rel=1e-5)
    low = pde.forward(p, b["coords"], ctx.spec, LOWP)
    assert _gap(low, want) > 100 * _gap(got, want)


def test_pde_blocks_agree_with_one_block(monkeypatch):
    ctx = _ctx("pde_solver.infer")
    p = _weights(ctx)
    c = inputs.mesh_points(ctx.seed, 0, 1, 50, 3, "cpu")
    whole = pde.forward(p, c, ctx.spec, F32)
    monkeypatch.setattr(pde, "BLOCK_ROWS", 7)
    assert _gap(pde.forward(p, c, ctx.spec, F32), whole) < 1e-6


def test_adamw_matches_the_programs_step():
    from repro_torch.optim import AdamW, constant
    torch.manual_seed(0)
    params = {"w": torch.randn(5, 3), "b": torch.randn(3)}
    grads = {"w": torch.randn(5, 3) * 3, "b": torch.randn(3)}
    prog = AdamW(lr_fn=constant(1e-2))
    state = prog.init(params)
    mine = [params["b"].clone(), params["w"].clone()]
    ref = adamw.AdamW(1e-2, 0.9, 0.95, 1e-8, 0.1, 1.0)
    for _ in range(3):
        prog.update(grads, state, params)
        ref.step(mine, [grads["b"], grads["w"]])
    assert torch.allclose(params["b"], mine[0], atol=1e-6)
    assert torch.allclose(params["w"], mine[1], atol=1e-6)


def test_fp8_rounding():
    x = torch.linspace(-3, 3, 101)
    y = arith.fp8(x)
    assert float((y - x).abs().max()) <= 3 * 2 ** -4
    assert float((y - x).abs().max()) > 0
    assert torch.equal(arith.fp8(torch.zeros(4)), torch.zeros(4))

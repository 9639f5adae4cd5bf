"""The references' arithmetic: float32 with TF32 off, or the control's
float8.

``Arith(lowp=False)`` is plain float32. ``Arith(lowp=True)`` is the
control, the references computed one precision below the configurations'
bfloat16: every operand of a matrix product (weights, activations, q, k, v
and the attention probabilities), the residual stream after each add, and
in training the gradient entering each product, is rounded to float8 e4m3
with a per-tensor scale; norms, softmax, the bias and the sums inside a
product stay float32.
"""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """Matrix products in full float32 (no TF32) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, in float32."""
    scale = FP8_MAX / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` of float8-rounded operands; the backward rounds the
    incoming gradient too and reuses the rounded operands."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = fp8(a), fp8(b)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = fp8(g)
        ga = g8 @ b8.T if ctx.needs_input_grad[0] else None
        gb = (a8.reshape(-1, a8.shape[-1]).T @ g8.reshape(-1, g8.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return ga, gb


class Arith:
    def __init__(self, lowp: bool = False):
        self.lowp = lowp

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The product ``a @ b`` of an activation ``(..., k)`` and a
        weight ``(k, n)``."""
        return _Fp8Matmul.apply(a, b) if self.lowp else a @ b

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand rounded as the arithmetic rounds it (identity in
        float32; float8 with a straight-through gradient in the control)."""
        if not self.lowp:
            return x
        return x + (fp8(x) - x).detach()

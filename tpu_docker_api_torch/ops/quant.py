"""Projection entry point (counterpart of ``tpu_docker_api/ops/quant.py``).

Only plain weights are ported so far; the int8 ``QuantizedLinear`` and
``LoraLinear`` leaves come with int8 serving.
"""

from __future__ import annotations

import torch


class _WideMM(torch.autograd.Function):
    """``mm`` with a widened result dtype, differentiable: torch has no
    derivative for ``mm`` with ``out_dtype``. The backward rounds the
    wide cotangent to the operands' dtype and runs both products on
    those operands with f32 accumulation, as chunked_cross_entropy's
    backward does explicitly in both packages."""

    @staticmethod
    def forward(ctx, x2, w, out_dtype):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = x2.t() @ g if ctx.needs_input_grad[1] else None
        return dx, dw, None


def linear(x: torch.Tensor, w: torch.Tensor,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y = x @ w for an (in, out) weight. ``out_dtype`` asks for widened
    ACCUMULATION, not a cast: the lm_head keeps bf16 operands and wants
    the unrounded f32 result. On CUDA that is one ``mm`` with
    ``out_dtype`` (differentiable through ``_WideMM``); the CPU build of
    torch has no such kernel, so there both operands are upcast (bf16
    products are exact in f32, so the result is the same function)."""
    if out_dtype is None or out_dtype == x.dtype:
        return x @ w
    if x.is_cuda:
        y = _WideMM.apply(x.reshape(-1, x.shape[-1]), w, out_dtype)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.to(out_dtype) @ w.to(out_dtype)

"""Projection entry point and int8 serving weights (counterpart of
``tpu_docker_api/ops/quant.py``).

``linear`` dispatches on the weight leaf: a plain tensor takes the float
matmul (training, bf16 serving), a ``QuantizedLinear`` the int8 path:

    w_int8[i, o] = round(w[i, o] / s_w[o]),  s_w[o] = absmax_i |w| / 127
    x_int8[r, i] = round(x[r, i] / s_x[r]),  s_x[r] = absmax_i |x| / 127
    y[r, o]      = (x_int8 · w_int8)[int32] · s_x[r] · s_w[o]

The int8 × int8 → int32 product is ``torch._int_mm`` (cuBLASLt on the
card); the JAX package computes it as an XLA ``dot_general``, outside any
Pallas kernel. The activation quantization and the scale epilogue are
plain torch ops, in the JAX function's order, so the CPU result is bit
for bit the JAX one. A ``LoraLinear`` (QLoRA's leaf, train/lora.py) adds
a low-rank adapter branch to either kind of base.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from tpu_docker_api_torch.telemetry.profile import span

_EPS = 1e-12

#: ``torch._int_mm`` on CUDA refuses an A of 16 rows or fewer ("self.size(0)
#: needs to be greater than 16", measured on an H100 with torch's CUDA
#: build) and inner or outer sizes that are not multiples of 8. Fewer rows
#: (a decode step of 8 slots has 8) are padded with zero rows up to
#: ``INT_MM_PAD_ROWS`` and sliced off after. With a row-major B, cuBLASLt
#: also refused 17 rows (CUBLAS_STATUS_NOT_SUPPORTED) and ran 5.7x slower
#: where it ran: ``QuantizedLinear`` stores B column-major.
INT_MM_MIN_ROWS = 17
INT_MM_PAD_ROWS = 32

#: the profiler range around the straight-through backward's f32 product
#: (the trainer's ``--profile-dir`` summary reports its device time)
STE_BACKWARD_RANGE = "int8_linear_ste_backward"


@functools.lru_cache(maxsize=None)
def _divisor_127(device: torch.device) -> torch.Tensor:
    return torch.tensor(127.0, device=device)


def _over_127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as an IEEE division, as the JAX function divides. On
    CUDA torch divides by a Python scalar as a multiply by its reciprocal,
    which is one ulp off at times; a 0-d tensor on the device divides."""
    return t / _divisor_127(t.device)


@dataclasses.dataclass
class QuantizedLinear:
    """An (…, in, out) weight stored int8 with per-out-channel f32 scales.

    ``w_int8`` keeps the JAX tree's logical (…, in, out) shape but is
    stored column-major, as a transposed view of an (…, out, in)
    contiguous tensor: cuBLASLt's int8 product in the ``TN`` operand
    order (``INT_MM_MIN_ROWS``). Slicing along the leading layer dims
    keeps the layout, so per-layer views cost nothing."""

    w_int8: torch.Tensor  # (…, in, out) int8
    scale: torch.Tensor   # (…, out) f32

    def __post_init__(self):
        w = self.w_int8
        if torch.is_tensor(w) and w.dim() >= 2 and w.stride(-2) != 1:
            self.w_int8 = (self.w_int8.transpose(-1, -2).contiguous()
                           .transpose(-1, -2))

    @property
    def shape(self):
        return self.w_int8.shape

    @property
    def size(self) -> int:
        return self.w_int8.numel()

    def unbind(self, dim: int = 0) -> tuple["QuantizedLinear", ...]:
        """Per-layer slices of a stacked leaf (views), as ``Tensor.unbind``
        gives them for a plain leaf (models/llama.py ``unstack_layers``)."""
        if dim != 0:
            raise ValueError("QuantizedLinear unbinds its leading dim only")
        return tuple(QuantizedLinear(w, s) for w, s in
                     zip(self.w_int8.unbind(0), self.scale.unbind(0)))


def quantize_weight(w: torch.Tensor) -> QuantizedLinear:
    """Quantize an (…, in, out) weight along its in axis (axis -2)."""
    wf = w.float()
    scale = _over_127(wf.abs().amax(dim=-2).clamp_min(_EPS))
    w_int8 = torch.round(wf / scale[..., None, :]).clamp(-127, 127)
    return QuantizedLinear(w_int8.to(torch.int8), scale)


def dequantize_weight(q: QuantizedLinear,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.w_int8.float() * q.scale[..., None, :]).to(dtype)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 × (k, n) int8 → (m, n) int32 through ``torch._int_mm``.
    On the card an A of ``INT_MM_MIN_ROWS - 1`` rows or fewer is padded
    with zero rows to ``INT_MM_PAD_ROWS`` (zero rows add nothing to the
    kept rows' sums) and the result sliced back; k or n not a multiple of
    8 raises, naming the rule. Nothing falls back to another product."""
    if not a.is_cuda:
        return torch._int_mm(a, b)
    m, k = a.shape
    n = b.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"int8 product of ({m}, {k}) x ({k}, {n}): "
                         f"torch._int_mm on CUDA needs inner and outer "
                         f"sizes that are multiples of 8")
    if m >= INT_MM_MIN_ROWS:
        return torch._int_mm(a, b)
    padded = a.new_zeros((INT_MM_PAD_ROWS, k))
    padded[:m] = a
    return torch._int_mm(padded, b)[:m]


def _int8_linear_fwd(x: torch.Tensor, w_int8: torch.Tensor,
                     scale: torch.Tensor,
                     out_dtype: torch.dtype | None) -> torch.Tensor:
    xf = x.float()
    x_scale = _over_127(xf.abs().amax(dim=-1, keepdim=True).clamp_min(_EPS))
    x_int8 = torch.round(xf / x_scale).clamp(-127, 127).to(torch.int8)
    acc = int8_matmul(x_int8.reshape(-1, x.shape[-1]), w_int8)
    acc = acc.reshape(*x.shape[:-1], w_int8.shape[-1])
    y = acc.float() * x_scale * scale
    return y.to(out_dtype or x.dtype)


class _Int8LinearSTE(torch.autograd.Function):
    """Straight-through gradient of the int8 product: the forward's
    ``round`` of the activations has zero derivative almost everywhere,
    so dL/dx is taken as the exact gradient of the DEQUANTIZED matmul,
    dL/dx = (g · s_w) @ W_int8ᵀ in f32, cast to x's dtype. The weights
    are frozen by contract and get no gradient (QLoRA's base)."""

    @staticmethod
    def forward(ctx, x, w_int8, scale, out_dtype):
        ctx.save_for_backward(w_int8, scale)
        ctx.x_dtype = x.dtype
        return _int8_linear_fwd(x, w_int8, scale, out_dtype)

    @staticmethod
    def backward(ctx, g):
        w_int8, scale = ctx.saved_tensors
        with span(STE_BACKWARD_RANGE):
            gx = (g.float() * scale) @ w_int8.float().t()
        return gx.to(ctx.x_dtype), None, None, None


def int8_linear(x: torch.Tensor, q: QuantizedLinear,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y = x @ dequant(q) as an int8 × int8 product with dynamic per-row
    activation quantization; x: (…, in), q: (in, out). Differentiable in
    x through the straight-through backward (``_Int8LinearSTE``)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Int8LinearSTE.apply(x, q.w_int8, q.scale, out_dtype)
    return _int8_linear_fwd(x, q.w_int8, q.scale, out_dtype)


@dataclasses.dataclass
class LoraLinear:
    """A frozen base projection (tensor OR ``QuantizedLinear``) plus a
    low-rank adapter branch, evaluated unmerged:

        y = linear(x, base) + s·(x @ A) @ B,   s = alpha / rank

    The leaf ``train/lora.py`` ``attach_lora`` builds: the merged tree
    ``W + s·A@B`` never materializes, so an int8 base stays int8. The
    branch computes in the adapter dtype (f32) and casts at the add, so
    the base path's numerics and dtype are untouched and autograd reaches
    A and B; the base is frozen (an int8 base gets no weight gradient
    from ``int8_linear``'s straight-through backward, a tensor base is
    not a leaf that requires one)."""

    base: Any             # (…, in, out) tensor or QuantizedLinear
    a: torch.Tensor       # (…, in, rank)
    b: torch.Tensor       # (…, rank, out)
    scale: float          # alpha / rank

    @property
    def shape(self):
        return self.base.shape

    def unbind(self, dim: int = 0) -> tuple["LoraLinear", ...]:
        """Per-layer slices of a stacked leaf: the base, A and B unbind
        together (models/llama.py ``unstack_layers``)."""
        if dim != 0:
            raise ValueError("LoraLinear unbinds its leading dim only")
        return tuple(LoraLinear(w, a, b, self.scale) for w, a, b in zip(
            self.base.unbind(0), self.a.unbind(0), self.b.unbind(0)))


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


def linear(x: torch.Tensor, w,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y = x @ w for an (in, out) weight: a ``QuantizedLinear`` takes the
    int8 path, a tensor the float matmul, a ``LoraLinear`` its base's path
    plus the adapter branch. ``out_dtype`` asks for widened
    ACCUMULATION, not a cast: the lm_head keeps bf16 operands and wants
    the unrounded f32 result. On CUDA that is one ``mm`` with
    ``out_dtype`` (differentiable through ``_WideMM``); the CPU build of
    torch has no such kernel, so there both operands are upcast (bf16
    products are exact in f32, so the result is the same function)."""
    if isinstance(w, LoraLinear):
        y = linear(x, w.base, out_dtype)
        delta = (x.to(w.a.dtype) @ w.a) @ w.b
        return y + (w.scale * delta).to(y.dtype)
    if isinstance(w, QuantizedLinear):
        return int8_linear(x, w, out_dtype)
    if out_dtype is None or out_dtype == x.dtype:
        return x @ w
    if x.is_cuda:
        y = _WideMM.apply(x.reshape(-1, x.shape[-1]), w, out_dtype)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return x.to(out_dtype) @ w.to(out_dtype)

"""Flash attention, forward and backward: wrappers around the CUDA
kernels in ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` plus their
plain PyTorch versions.

Counterpart of ``tpu_docker_api/ops/flash_pallas.py``. Layout follows the
JAX function: q (batch, heads, seq, head_dim), k/v (batch, kv_heads, seq,
head_dim). These may be strided views of the model's (batch, seq, heads,
head_dim) tensors: the kernels read the strides, only head_dim must be
contiguous. ``out``, ``dq``, ``dk`` and ``dv`` are returned as (batch,
heads, seq, head_dim) views of contiguous (batch, seq, heads, head_dim)
buffers, so the model's transposes stay free; ``lse`` is (batch, heads,
seq) f32, natural log.

``flash_attention`` is differentiable, as the JAX ``custom_vjp`` is: the
forward is the custom op ``tpu_docker_api_torch::flash_fwd`` (``FLASH_OP``),
which saves ``(q, k, v, out, lse)``; its backward runs the dq kernel, which
also writes ``D = rowsum(dO∘O)``, then the dk/dv kernel. Being an op of its
own lets a selective-checkpoint policy keep its outputs (models/llama.py's
remat), as ``TRAIN_REMAT_POLICY`` keeps the JAX kernel's ``(out, lse)``.

In bf16 all three kernels run on the tensor cores and load their tiles by
TMA (``csrc/hopper.cuh``), which takes only 16-byte aligned rows
(``rows_aligned``): an input that breaks the rule is refused with a
ValueError naming it. In f32 they run on the CUDA cores.

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_docker_api_torch import _build

#: kernel launches by these wrappers (the plain versions never count) —
#: lets a run prove that its main path went through the kernels
launch_count = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30

_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_count() -> None:
    for name in launch_count:
        launch_count[name] = 0


def supports(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take this head_dim and dtype."""
    return head_dim in _HEAD_DIMS and dtype in _DTYPES


def _plain_scores(q, k, causal):
    """f32 scores (b, hk, group, s, s), scaled and causally masked."""
    b, h, s, d = q.shape
    hk = k.shape[1]
    qf = q.float().reshape(b, hk, h // hk, s, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    scores = scores * (1.0 / d**0.5)
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, _NEG)
    return scores


def flash_attention_fwd_plain(q, k, v, causal: bool = True):
    """Plain PyTorch version of the forward kernel: scores → causal/GQA
    mask → f32 softmax → PV. Returns (out like q, lse (b, h, s) f32)."""
    b, h, s, d = q.shape
    scores = _plain_scores(q, k, causal)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, h, s, d).to(q.dtype), lse.reshape(b, h, s)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal: bool = True):
    """Plain PyTorch version of the two backward kernels, the formulas of
    ``flash_pallas.py``'s header in f32 with P rebuilt from ``lse``:

        D = rowsum(dO∘O);  P = exp(q kᵀ·scale − lse)
        dV = Σ_g Pᵀ dO;  dS = P∘(dO vᵀ − D)
        dQ = scale·dS k;  dK = scale·Σ_g dSᵀ q

    Returns (dq like q, dk like k, dv like v)."""
    b, h, s, d = q.shape
    hk = k.shape[1]
    scale = 1.0 / d**0.5
    probs = torch.exp(_plain_scores(q, k, causal)
                      - lse.float().reshape(b, hk, h // hk, s, 1))
    do = dout.float().reshape(b, hk, h // hk, s, d)
    delta = (do * out.float().reshape(b, hk, h // hk, s, d)).sum(-1)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", probs, do)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do, v.float())
    ds = probs * (dp - delta[..., None])
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds,
                      q.float().reshape(b, hk, h // hk, s, d)) * scale
    return (dq.reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    lib = _build.load(name)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    f32 = ctypes.c_float
    if name == "flash_fwd":
        lib.flash_fwd.argtypes = (
            [ptr] * 5                    # q, k, v, out, lse
            + [i32] * 7                  # batch, seq, heads, kv_heads,
            #                              head_dim, is_bf16, causal
            + [i64] * 12                 # (b, h, s) strides of q, k, v, out
            + [f32, ptr])                # softmax scale, stream
        lib.flash_fwd.restype = i32
    else:
        lib.flash_bwd_dq.argtypes = (
            [ptr] * 8                    # q, k, v, out, dout, lse, delta, dq
            + [i32] * 7
            + [i64] * 18                 # strides of q, k, v, out, dout, dq
            + [f32, ptr])
        lib.flash_bwd_dq.restype = i32
        lib.flash_bwd_dkv.argtypes = (
            [ptr] * 8                    # q, k, v, dout, lse, delta, dk, dv
            + [i32] * 7
            + [i64] * 18                 # strides of q, k, v, dout, dk, dv
            + [f32, ptr])
        lib.flash_bwd_dkv.restype = i32
    _libs[name] = lib
    return lib


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash attention takes 4-D (batch, heads, seq, "
                         "head_dim) tensors")
    b, h, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (s, d):
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"{h} heads do not group over {k.shape[1]} "
                         f"kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share one dtype")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must be on one device")


def _check_kernel(q, k, v, *like_q):
    """What every kernel requires of a CUDA call; ``like_q`` (out, dout)
    have q's shape."""
    ts = (q, k, v, *like_q)
    b, h, s, d = q.shape
    if any(t.shape != q.shape for t in like_q):
        raise ValueError(f"out/dout must have q's shape {tuple(q.shape)}")
    if not q.is_cuda or any(t.device != q.device for t in ts):
        raise ValueError("flash kernels take tensors on one CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"flash kernels take bf16 or f32 tensors of one "
                         f"dtype, got {[t.dtype for t in ts]}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {_HEAD_DIMS}, "
                         f"got {d}")
    if s < 1 or b * h > 65535:
        raise ValueError(f"flash kernels take seq >= 1 and batch*heads <= "
                         f"65535, got seq {s}, batch*heads {b * h}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("flash kernels need a contiguous head_dim")


def _raise_launch(name: str, rc: int, *loaded: torch.Tensor):
    """The error of a failed launch. The three bf16 kernels load
    ``loaded`` by TMA (and the dq kernel reads ``out``'s rows 16 bytes at
    a time), which ``csrc/hopper.cuh`` refuses unless their rows follow
    ``rows_aligned``: such a refusal gets a ValueError saying which tensor
    broke the rule."""
    bad = [i for i, t in enumerate(loaded) if not rows_aligned(t)]
    if bad:
        raise ValueError(f"{name}: the bf16 kernels load 16-byte rows, but "
                         f"input(s) {bad} have (batch, head, seq) strides "
                         f"that are not nonzero multiples of 8 elements or "
                         f"data that is not 16-byte aligned")
    raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether every (batch, head, seq) row of ``t`` starts on a 16-byte
    boundary and none repeats another (a broadcast stride of 0), as the
    bf16 kernels' TMA tile loads need (the kernels check it themselves;
    this is for messages and for copying a cotangent that breaks it)."""
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) * t.element_size() % 16 == 0
        and (t.stride(i) != 0 or t.shape[i] == 1) for i in range(3))


def _check_stats(q, *stats):
    """lse and delta: contiguous (batch, heads, seq) f32 beside q."""
    b, h, s, _ = q.shape
    for t in stats:
        if (t.shape != (b, h, s) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError("lse and delta must be contiguous (batch, "
                             "heads, seq) f32 on q's device")


def _strides(*ts):
    return [st for t in ts for st in (t.stride(0), t.stride(1), t.stride(2))]


def _empty_bshd(like: torch.Tensor) -> torch.Tensor:
    """A (b, h, s, d) view of a new contiguous (b, s, h, d) buffer."""
    b, h, s, d = like.shape
    return torch.empty((b, s, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True):
    """(out, lse) of causal or full GQA attention. CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal)
    if not q.is_cuda:
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check_kernel(q, k, v)
    b, h, s, d = q.shape
    out = _empty_bshd(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _load("flash_fwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, s, h, k.shape[1], d, _DTYPES[q.dtype],
            int(causal), *_strides(q, k, v, out), 1.0 / d**0.5, _stream(q))
    if rc != 0:
        _raise_launch("flash_fwd", rc, q, k, v)
    launch_count["flash_fwd"] += 1
    return out, lse


def flash_bwd_dq(q, k, v, out, lse, dout, causal: bool = True):
    """Launch the dq kernel: (dq like q, delta (b, h, s) f32). The kernel
    also writes ``delta = rowsum(dout∘out)``, which the dk/dv kernel
    reads, so it runs first. CUDA tensors only; in bf16 the rows of q, k,
    v, out and dout must follow ``rows_aligned``."""
    _check_kernel(q, k, v, out, dout)
    _check_stats(q, lse)
    b, h, s, d = q.shape
    dq = _empty_bshd(q)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _load("flash_bwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, s, h, k.shape[1], d, _DTYPES[q.dtype], int(causal),
            *_strides(q, k, v, out, dout, dq), 1.0 / d**0.5, _stream(q))
    if rc != 0:
        _raise_launch("flash_bwd_dq", rc, q, k, v, out, dout)
    launch_count["flash_bwd_dq"] += 1
    return dq, delta


def flash_bwd_dkv(q, k, v, lse, delta, dout, causal: bool = True):
    """Launch the dk/dv kernel: (dk like k, dv like v), the GQA group
    summed in f32 before one cast. CUDA tensors only."""
    _check_kernel(q, k, v, dout)
    _check_stats(q, lse, delta)
    b, h, s, d = q.shape
    dk, dv = _empty_bshd(k), _empty_bshd(v)
    lib = _load("flash_bwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, h, k.shape[1], d, _DTYPES[q.dtype], int(causal),
            *_strides(q, k, v, dout, dk, dv), 1.0 / d**0.5, _stream(q))
    if rc != 0:
        _raise_launch("flash_bwd_dkv", rc, q, k, v, dout)
    launch_count["flash_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True):
    """(dq, dk, dv) of the forward's (q, k, v) for the cotangent ``dout``
    of ``out``. CPU tensors run the plain version; CUDA tensors launch
    the dq kernel, then the dk/dv kernel, or raise."""
    _check(q, k, v)
    if dout.shape != q.shape or dout.device != q.device:
        raise ValueError(f"dout {tuple(dout.shape)} on {dout.device} does "
                         f"not match q {tuple(q.shape)} on {q.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal)
    if not q.is_cuda:
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    # autograd may hand over any layout: strides are read as they are,
    # one copy only where head_dim is not contiguous, the rows are not
    # 16-byte aligned, or the dtype differs
    dout = dout.to(q.dtype)
    if dout.stride(-1) != 1 or not rows_aligned(dout):
        dout = dout.clone(memory_format=torch.contiguous_format)
    lse = lse.contiguous()
    dq, delta = flash_bwd_dq(q, k, v, out, lse, dout, causal)
    dk, dv = flash_bwd_dkv(q, k, v, lse, delta, dout, causal)
    return dq, dk, dv


@torch.library.custom_op("tpu_docker_api_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_fwd(q, k, v, causal)


def _setup_context(ctx, inputs, output):
    q, k, v, causal = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal = causal
    ctx.mark_non_differentiable(lse)


def _backward(ctx, dout, _dlse):
    # lse is not differentiated (the JAX custom_vjp returns out only)
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal)
    return dq, dk, dv, None


torch.library.register_autograd("tpu_docker_api_torch::flash_fwd", _backward,
                                setup_context=_setup_context)

#: the forward as one dispatcher op: a selective-checkpoint policy that
#: marks it MUST_SAVE keeps (out, lse) and never re-runs the kernel
FLASH_OP = torch.ops.tpu_docker_api_torch.flash_fwd.default


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Tiled causal (or full) attention, differentiable. Any seq >= 1:
    the kernels mask the ragged edge of their last tile themselves."""
    _check(q, k, v)
    return FLASH_OP(q, k, v, causal)[0]

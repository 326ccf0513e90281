"""Optimizers of the port (counterpart of ``tpu_docker_api/train/optim.py``
and the optax transforms that ``train/trainer.py`` chains).

The JAX package builds its optimizers from optax. The port writes the
same transforms as plain functions on tensors, in optax's order and
rounding: moments in the parameter dtype, weight decay on every leaf
(norms included), the clip as ``optax.clip_by_global_norm`` computes it.
``torch.optim.AdamW`` and ``clip_grad_norm_`` differ (they add 1e-6 to
the norm and decay in another order), so they are not used. Parameter
trees are nested dicts of tensors; a transform is a pair of pure
functions, as in optax: ``init(params) -> state`` and ``update(updates,
state, params) -> (updates, state)``.

``adamw_int8`` stores both Adam moments as int8 with one f32 scale per
quantization block of ``b <= 256`` elements along each leaf's last dim
(``mu`` linear, ``nu`` linear in the sqrt domain). Its update is one
kernel launch per leaf (``csrc/adam8.cu``) on a CUDA tensor, the plain
version (``adam8_plain``, the JAX ``one_xla``) on a CPU tensor.

Scale layout: the port keeps a leaf's scales as ``(rows, last_dim // b)``
f32 — block i of the flattened leaf has scale i. The JAX package's
``(segments, blocks_per_segment, rows)`` is a TPU lane-density trick;
``scales_to_jax`` / ``scales_from_jax`` convert between the two.

Sharded leaves (the mesh path, parallel/): params, gradients and
moments are ``DTensor``s. Every element-wise transform runs on the local
shards (``_lmap``); ``global_norm`` sums each leaf's local squares and
all-reduces them over the mesh dims that shard it. The int8 moments keep
JAX's blocks along the GLOBAL last dim (b from the global width), so a
leaf's update does not depend on the mesh: where the shards of the last
dim hold whole blocks, the kernel runs on each shard and the scales
shard with it; where a shard boundary falls inside a block (tiny widths,
a vocab of 128256 = 501 blocks of 256 split over tp), that leaf's
gradient, moments and param are gathered along the last dim, the kernel
runs on the whole rows, each rank keeps its slice, and its scales stay
whole on every rank. A sharded leaf's scales are ``(*lead, blocks)``, the
leaf's leading dims kept so that they shard like it; on disk they are
the same ``(rows, blocks)`` as on one device.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from tpu_docker_api_torch import _build

#: kernel launches by ``adam8_update_leaf`` (the plain version never
#: counts)
launch_count = {"adam8": 0}

_lib = None
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BLOCK = 256  # the kernel keeps at most 8 elements a lane


def reset_launch_count() -> None:
    launch_count["adam8"] = 0


# ------------------------------------------------------------ DTensors


def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def _is_dt(x) -> bool:
    return (type(x).__name__ == "DTensor"
            and isinstance(x, _dtensor_type()))


def _wrap(local: torch.Tensor, like, placements=None, shape=None):
    """``local`` as the DTensor of ``like``'s mesh (and placements and
    global shape unless given)."""
    shape = torch.Size(like.shape if shape is None else shape)
    return _dtensor_type().from_local(
        local, like.device_mesh,
        like.placements if placements is None else placements,
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def _lmap(fn: Callable, *xs):
    """``fn`` on the local shards of DTensor leaves (rewrapped like the
    first), or on plain tensors as they are."""
    if not _is_dt(xs[0]):
        return fn(*xs)
    return _wrap(fn(*(x.to_local() if _is_dt(x) else x for x in xs)), xs[0])


def _shard_dims(x, dim: int) -> list[int]:
    """Mesh dims that shard tensor dim ``dim`` of DTensor ``x``."""
    return [i for i, pl in enumerate(x.placements)
            if pl.is_shard() and pl.dim == dim]


# ---------------------------------------------------------------- trees


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _unzip(tree, n: int) -> list:
    """A tree of n-tuples → n trees."""
    return [tree_map(lambda t, i=i: t[i], tree) for i in range(n)]


# ------------------------------------------------------------ transforms


class GradientTransformation(NamedTuple):
    init: Callable[[dict], Any]
    update: Callable[..., tuple[dict, Any]]


class EmptyState(NamedTuple):
    pass


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, each leaf summed
    in its own dtype (``optax.global_norm``). A device tensor: reading it
    is the caller's choice. DTensor leaves sum their local squares, and
    the sums are all-reduced over the mesh dims that shard them (one
    all-reduce for each set of such dims); the result is a plain tensor
    of the same value on every rank."""
    leaves = tree_leaves(tree)
    if not leaves or not _is_dt(leaves[0]):
        return torch.sqrt(sum((x * x).sum() for x in leaves))
    import torch.distributed as dist

    by_dims: dict = {}
    for x in leaves:
        loc = x.to_local()
        dims = tuple(i for i, pl in enumerate(x.placements) if pl.is_shard())
        sq = (loc * loc).sum().float()
        by_dims[dims] = by_dims[dims] + sq if dims in by_dims else sq
    total = None
    mesh = leaves[0].device_mesh
    for dims, sq in by_dims.items():
        for i in dims:
            if mesh.size(i) > 1:
                dist.all_reduce(sq, group=mesh.get_group(i))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm

        def clip(t):
            return torch.where(trigger, t, (t / g_norm.to(t.dtype)) * max_norm)

        return tree_map(lambda t: _lmap(clip, t), updates), state

    return GradientTransformation(lambda params: EmptyState(), update)


class ScaleByAdamState(NamedTuple):
    count: int
    mu: dict
    nu: dict


def _bias_correction(decay: float, count: int) -> np.float32:
    """1 - decay**count in f32, as optax and the JAX int8 path compute it."""
    return np.float32(1.0) - np.float32(decay) ** np.float32(count)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """``optax.scale_by_adam`` with ``eps_root=0``: moments in the
    parameter dtype, the bias correction rounded to that dtype before it
    divides."""
    def zeros(p):
        return _lmap(torch.zeros_like, p)

    def init(params):
        return ScaleByAdamState(0, tree_map(zeros, params),
                                tree_map(zeros, params))

    def update(updates, state, params=None):
        mu = tree_map(lambda g, t: _lmap(lambda g, t: (1 - b1) * g + b1 * t,
                                         g, t), updates, state.mu)
        nu = tree_map(lambda g, t: _lmap(
            lambda g, t: (1 - b2) * (g * g) + b2 * t, g, t), updates,
            state.nu)
        count = state.count + 1
        bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)

        def step(m, v):
            m_hat = m / _in_dtype(bc1, m.dtype)
            v_hat = v / _in_dtype(bc2, v.dtype)
            return m_hat / (torch.sqrt(v_hat) + eps)

        return (tree_map(lambda m, v: _lmap(step, m, v), mu, nu),
                ScaleByAdamState(count, mu, nu))

    return GradientTransformation(init, update)


def _in_dtype(x: np.float32, dtype: torch.dtype) -> float:
    """The f32 scalar ``x`` rounded to ``dtype`` (``.astype(t.dtype)``)."""
    return float(torch.tensor(float(x), dtype=torch.float32).to(dtype))


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs params")
        return tree_map(lambda g, p: _lmap(lambda g, p: g + weight_decay * p,
                                           g, p), updates, params), state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_learning_rate(lr: float) -> GradientTransformation:
    def update(updates, state, params=None):
        return tree_map(lambda g: _lmap(lambda g: -lr * g, g), updates), state

    return GradientTransformation(lambda params: EmptyState(), update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """``optax.adamw`` with a constant learning rate and no mask."""
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(lr))


def apply_updates(params: dict, updates: dict) -> dict:
    return tree_map(lambda p, u: _lmap(lambda p, u: (p + u).to(p.dtype),
                                       p, u), params, updates)


# ------------------------------------------------------ int8 quantization


def _block_of(last_dim: int, block: int) -> int:
    b = min(block, last_dim)
    while last_dim % b:
        b -= 1
    return b


def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1] if x.ndim > 1 else 1


def _quant_signed(x: torch.Tensor, block: int):
    """x (any shape) → (int8 like x, f32 scales (rows, last_dim // b))."""
    b = _block_of(x.shape[-1], block)
    xb = x.reshape(_rows(x), -1, b)
    s = xb.abs().amax(dim=-1) / 127.0 + 1e-30
    q = torch.round(xb * (1.0 / s)[..., None]).to(torch.int8)
    return q.reshape(x.shape), s


def _dequant_signed(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    qb = q.reshape(scale.shape[0], scale.shape[1], -1)
    return (qb.float() * scale[..., None]).reshape(q.shape)


def _quant_sqrt(x: torch.Tensor, block: int):
    """Non-negative x stored as int8 in the sqrt domain."""
    return _quant_signed(torch.sqrt(x), block)


def _dequant_sqrt(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    r = _dequant_signed(q, scale)
    return r * r


def _jax_segment(last_dim: int, block: int) -> int:
    """The JAX layout's lane-segment width: the largest multiple of b
    dividing last_dim that is at most 1536 (``_layout_of``)."""
    b = _block_of(last_dim, block)
    for mult in range(last_dim // b, 0, -1):
        if last_dim % (b * mult) == 0 and b * mult <= 1536:
            return b * mult
    return b


def scales_to_jax(scale: torch.Tensor, last_dim: int,
                  block: int = 256) -> torch.Tensor:
    """(rows, last_dim // b) → the JAX (segs, blocks_per_seg, rows)."""
    b, lb = _block_of(last_dim, block), _jax_segment(last_dim, block)
    rows = scale.shape[0]
    return scale.reshape(rows, last_dim // lb, lb // b).permute(1, 2, 0)


def scales_from_jax(scale: torch.Tensor) -> torch.Tensor:
    """The JAX (segs, blocks_per_seg, rows) → (rows, last_dim // b)."""
    segs, bpseg, rows = scale.shape
    return scale.permute(2, 0, 1).reshape(rows, segs * bpseg)


class Adam8Scalars(NamedTuple):
    """One step's f32 scalars, computed on the host (no device sync)."""
    b1: float
    b2: float
    eps: float
    inv_bc1: float       # 1 / (1 - b1^t)
    inv_sqrt_bc2: float  # 1 / sqrt(1 - b2^t)
    lr: float
    wd: float


def adam8_scalars(count: int, b1: float, b2: float, eps: float,
                  lr: float = 0.0, wd: float = 0.0) -> Adam8Scalars:
    bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
    return Adam8Scalars(b1, b2, eps, float(np.float32(1.0) / bc1),
                        float(np.float32(1.0) / np.sqrt(bc2)), lr, wd)


def adam8_plain(g, mq, ms, vq, vs, p=None, *, sc: Adam8Scalars,
                block: int = 256):
    """Plain PyTorch version of the kernel (the JAX ``one_xla``): returns
    (update like g, mq', ms', vq', vs'). Without ``p`` the update is the
    bias-corrected Adam step; with it, ``-lr·(step + wd·p)``."""
    gf = g.float()
    m = sc.b1 * _dequant_signed(mq, ms) + (1.0 - sc.b1) * gf
    v = sc.b2 * _dequant_sqrt(vq, vs) + (1.0 - sc.b2) * gf * gf
    upd = (m * sc.inv_bc1) / (torch.sqrt(v) * sc.inv_sqrt_bc2 + sc.eps)
    if p is not None:
        upd = -sc.lr * (upd + sc.wd * p.float())
    mq2, ms2 = _quant_signed(m, block)
    vq2, vs2 = _quant_sqrt(v, block)
    return upd.to(g.dtype), mq2, ms2, vq2, vs2


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("adam8")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.adam8.argtypes = (
            [ptr] * 11                   # g, p, mq, ms, vq, vs, upd,
            #                              mq', ms', vq', vs'
            + [ctypes.c_int64, i32, i32]  # n_blocks, b, is_bf16
            + [f32] * 9                  # b1, 1-b1, b2, 1-b2, eps,
            #                              1/bc1, 1/sqrt(bc2), -lr, wd
            + [ptr])                     # stream
        lib.adam8.restype = i32
        _lib = lib
    return _lib


def adam8_update_leaf(g, mq, ms, vq, vs, p=None, *, sc: Adam8Scalars,
                      block: int = 256):
    """(update like g, mq', ms', vq', vs') for one leaf. A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel or raises."""
    b = _block_of(g.shape[-1], block)
    if mq.shape != g.shape or vq.shape != g.shape or (
            p is not None and p.shape != g.shape):
        raise ValueError("g, the int8 moments and p must share one shape")
    if ms.shape != (_rows(g), g.shape[-1] // b) or vs.shape != ms.shape:
        raise ValueError(f"scales {tuple(ms.shape)} do not fit a leaf of "
                         f"shape {tuple(g.shape)} in blocks of {b}")
    if g.device.type == "cpu":
        return adam8_plain(g, mq, ms, vq, vs, p, sc=sc, block=block)
    if not g.is_cuda:
        raise ValueError(f"adam8 runs on cuda or cpu, not {g.device}")
    if g.dtype not in _KERNEL_DTYPES or (p is not None
                                         and p.dtype != g.dtype):
        raise ValueError(f"adam8 kernel takes bf16 or f32 g and p of one "
                         f"dtype, got {g.dtype}/{p.dtype if p is not None else None}")
    if b > _MAX_BLOCK:
        raise ValueError(f"adam8 kernel takes blocks of at most "
                         f"{_MAX_BLOCK}, got {b}")
    ts = [g, mq, ms, vq, vs] + ([p] if p is not None else [])
    if any(t.device != g.device or not t.is_contiguous() for t in ts):
        raise ValueError("adam8 kernel needs contiguous tensors on one "
                         "device")
    if mq.dtype != torch.int8 or vq.dtype != torch.int8 or \
            ms.dtype != torch.float32 or vs.dtype != torch.float32:
        raise ValueError("adam8 kernel takes int8 moments, f32 scales")
    upd = torch.empty_like(g)
    mq2, vq2 = torch.empty_like(mq), torch.empty_like(vq)
    ms2, vs2 = torch.empty_like(ms), torch.empty_like(vs)
    lib = _load()
    f32 = np.float32
    with torch.cuda.device(g.device):
        rc = lib.adam8(
            g.data_ptr(), p.data_ptr() if p is not None else None,
            mq.data_ptr(), ms.data_ptr(), vq.data_ptr(), vs.data_ptr(),
            upd.data_ptr(), mq2.data_ptr(), ms2.data_ptr(), vq2.data_ptr(),
            vs2.data_ptr(), g.numel() // b, b, _KERNEL_DTYPES[g.dtype],
            sc.b1, float(f32(1.0 - sc.b1)), sc.b2, float(f32(1.0 - sc.b2)),
            sc.eps, sc.inv_bc1, sc.inv_sqrt_bc2, -sc.lr, sc.wd,
            torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adam8 launch failed: CUDA error {rc}")
    launch_count["adam8"] += 1
    return upd, mq2, ms2, vq2, vs2


def _scale_layout(p, block: int):
    """For a DTensor leaf ``p``: (b, aligned, scale shape, scale
    placements). b is the block of the GLOBAL last dim; ``aligned`` is
    whether every shard of the last dim holds whole blocks."""
    from torch.distributed.tensor import Replicate, Shard

    last = p.ndim - 1
    b = _block_of(p.shape[-1], block)
    n_last = 1
    for i in _shard_dims(p, last):
        n_last *= p.device_mesh.size(i)
    aligned = (p.shape[-1] // n_last) % b == 0
    nb = p.shape[-1] // b
    if p.ndim == 1:
        if n_last > 1:
            raise ValueError("adam8: a 1-D leaf sharded on its only dim")
        return b, True, (1, nb), [Replicate()] * p.device_mesh.ndim
    pls = [Shard(pl.dim) if pl.is_shard() and (pl.dim < last or aligned)
           else Replicate() for pl in p.placements]
    return b, aligned, (*p.shape[:-1], nb), pls


def adam8_route(shape, last_ranks: int, block: int = 256) -> str:
    """How the int8 moments of a leaf of global ``shape`` update when
    its last dim is split over ``last_ranks`` ranks: ``"shard"`` (each
    shard holds whole blocks: the kernel runs on it) or ``"gather"``
    (a boundary falls inside a block: the leaf's rows are gathered)."""
    b = _block_of(shape[-1], block)
    return "shard" if (shape[-1] // last_ranks) % b == 0 else "gather"


def _last_dim_index(p) -> tuple[list[int], int, int]:
    """(mesh dims sharding ``p``'s last dim, this rank's index along
    them (the first major), their size)."""
    dims = _shard_dims(p, p.ndim - 1)
    mesh, idx, n = p.device_mesh, 0, 1
    coord = mesh.get_coordinate()
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
        n *= mesh.size(i)
    return dims, idx, n


def _adam8_sharded(g, mq, ms, vq, vs, p, *, sc: Adam8Scalars, block: int):
    """``adam8_update_leaf`` on DTensor leaves: the kernel on each local
    shard where the last dim's shards hold whole blocks, else on the
    leaf's rows gathered along the last dim (module docstring)."""
    from tpu_docker_api_torch.parallel import comm

    b, aligned, _, _ = _scale_layout(g, block)  # adam8_route's rule
    loc = [x.to_local() if x is not None else None
           for x in (g, mq, ms, vq, vs, p)]
    gl, mql, msl, vql, vsl, pl = loc
    if aligned:
        upd, mq2, ms2, vq2, vs2 = adam8_update_leaf(
            gl, mql, msl.reshape(-1, msl.shape[-1]), vql,
            vsl.reshape(-1, vsl.shape[-1]), pl, sc=sc, block=b)
    else:
        dims, idx, n = _last_dim_index(g)
        mesh, last = g.device_mesh, g.ndim - 1

        def whole(x):
            if x is None:
                return None
            for i in reversed(dims):
                x = comm.gather_nograd(x, last, mesh.get_group(i))
            return x

        upd, mq2, ms2, vq2, vs2 = adam8_update_leaf(
            whole(gl), whole(mql), msl.reshape(-1, msl.shape[-1]),
            whole(vql), vsl.reshape(-1, vsl.shape[-1]), whole(pl),
            sc=sc, block=b)
        width = gl.shape[-1]

        def mine(x):
            return x.narrow(-1, idx * width, width).contiguous()

        upd, mq2, vq2 = mine(upd), mine(mq2), mine(vq2)
    return (_wrap(upd, g), _wrap(mq2, mq),
            _wrap(ms2.reshape(msl.shape), ms),
            _wrap(vq2, vq), _wrap(vs2.reshape(vsl.shape), vs))


class ScaleByAdamInt8State(NamedTuple):
    count: int
    mu_q: dict
    mu_scale: dict
    nu_q: dict
    nu_scale: dict


def scale_by_adam_int8(
    b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, block: int = 256,
    fused_wd_lr: tuple[float, float] | None = None,
) -> GradientTransformation:
    """Adam with int8 moments. ``fused_wd_lr=(weight_decay, lr)`` folds
    decoupled weight decay and the learning rate into the update (the
    transform then emits the FINAL ``-lr·(adam + wd·p)`` step and needs
    ``params`` at update time)."""
    def init(params):
        def zs(p):
            if _is_dt(p):
                _, _, shape, pls = _scale_layout(p, block)
                local_shape = list(shape)
                for i, pl in enumerate(pls):
                    if pl.is_shard():
                        local_shape[pl.dim] //= p.device_mesh.size(i)
                return _wrap(torch.zeros(local_shape, dtype=torch.float32,
                                         device=p.to_local().device),
                             p, pls, shape)
            return torch.zeros((_rows(p), p.shape[-1]
                                // _block_of(p.shape[-1], block)),
                               dtype=torch.float32, device=p.device)

        def zq(p):
            return _lmap(lambda t: torch.zeros(t.shape, dtype=torch.int8,
                                               device=t.device), p)

        return ScaleByAdamInt8State(0, tree_map(zq, params),
                                    tree_map(zs, params),
                                    tree_map(zq, params),
                                    tree_map(zs, params))

    def update(updates, state, params=None):
        if fused_wd_lr is not None and params is None:
            raise ValueError("fused_wd_lr requires params at update time")
        count = state.count + 1
        wd, lr = fused_wd_lr if fused_wd_lr is not None else (0.0, 0.0)
        sc = adam8_scalars(count, b1, b2, eps, lr, wd)

        def one(g, mq, ms, vq, vs, p=None):
            if _is_dt(g):
                return _adam8_sharded(g, mq, ms, vq, vs, p, sc=sc,
                                      block=block)
            return adam8_update_leaf(g, mq, ms, vq, vs, p, sc=sc,
                                     block=block)

        trees = [updates, state.mu_q, state.mu_scale, state.nu_q,
                 state.nu_scale]
        if fused_wd_lr is not None:
            trees.append(params)
        upd, mq, ms, vq, vs = _unzip(tree_map(one, *trees), 5)
        return upd, ScaleByAdamInt8State(count, mq, ms, vq, vs)

    return GradientTransformation(init, update)


def adamw_int8(
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
    block: int = 256,
) -> GradientTransformation:
    """Drop-in for ``trainer.default_optimizer`` with int8 moments; weight
    decay and lr are folded into the update kernel."""
    return chain(clip_by_global_norm(clip_norm),
                 scale_by_adam_int8(b1, b2, eps, block,
                                    fused_wd_lr=(weight_decay, lr)))

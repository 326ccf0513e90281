"""Sharding rules: parameter-path patterns → partition specs
(counterpart of ``tpu_docker_api/parallel/sharding.py``).

The rules are the JAX package's, row for row: a leaf's spec is the first
(glob over ``"path/like/this"``, spec) rule that matches; column-parallel
weights shard their output dim on ``tp``, row-parallel their input dim,
and every weight also shards a non-tp dim on ``fsdp`` (ZeRO-3).

The port's :class:`P` is a tuple with one entry a tensor dim: an axis
name, a tuple of axis names (the first major) or None. A leaf lives on
every rank as a ``DTensor`` whose placements come from its spec: an
entry naming an axis is ``Shard(dim)`` on that mesh dim, every other
mesh dim is ``Replicate``. Each rank cuts its own slice out of a full
tensor (:func:`local_slice`), so distributing a leaf moves no bytes
between ranks.

The sharded model code computes on the local shards (``to_local``) and
issues its collectives itself (parallel/comm.py): :func:`unshard`
gathers the axes a product needs whole, :func:`grad_reduce_axes` names
the axes a leaf's gradient is summed over after the backward.
"""

from __future__ import annotations

import fnmatch
from typing import Any

import torch

from tpu_docker_api_torch.parallel import comm
from tpu_docker_api_torch.parallel.mesh import AXES, Mesh


class P(tuple):
    """A partition spec: ``P("tp", None)``, ``P(("dp", "fsdp"), "sp")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


#: (glob, spec), first match wins; stacked per-layer leaves get a leading
#: None so the layer axis is never sharded
LLAMA_RULES: list[tuple[str, P]] = [
    ("embed/tokens",        P("tp", "fsdp")),            # (vocab, d)
    ("layers/attn/wq",      P(None, "fsdp", "tp")),      # (L, d, qh*hd) column
    ("layers/attn/wk",      P(None, "fsdp", "tp")),      # (L, d, kvh*hd) column
    ("layers/attn/wv",      P(None, "fsdp", "tp")),
    ("layers/attn/wo",      P(None, "tp", "fsdp")),      # (L, qh*hd, d) row
    ("layers/mlp/w_gate",   P(None, "fsdp", "tp")),      # (L, d, ff) column
    ("layers/mlp/w_up",     P(None, "fsdp", "tp")),
    ("layers/mlp/w_down",   P(None, "tp", "fsdp")),      # (L, ff, d) row
    ("*norm*",              P()),                        # replicated vectors
    ("lm_head",             P("fsdp", "tp")),            # (d, vocab)
    ("*",                   P()),                        # fallback: replicate
]

#: the axes a batch's rows split over; activations (batch, seq, ...)
BATCH_AXES = ("dp", "fsdp")
#: the axes whose ranks each compute a part of the loss: a gradient is
#: summed over those that do not shard its leaf (grad_reduce_axes)
SPLIT_AXES = ("pp",) + BATCH_AXES + ("sp",)


def flatten_paths(params: dict, prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_paths(v, path))
        else:
            out[path] = v
    return out


def spec_for(path: str, rules: list[tuple[str, P]] | None = None) -> P:
    for pattern, spec in rules or LLAMA_RULES:
        if fnmatch.fnmatch(path, pattern):
            return spec
    return P()


def param_specs(params: dict, rules: list[tuple[str, P]] | None = None):
    """Tree of specs matching ``params``. A ``QuantizedLinear`` leaf
    expands into specs for both its children: the int8 weight takes the
    rule's spec, the per-out-channel scales the spec without the
    contracted (in) axis."""
    from tpu_docker_api_torch.ops.quant import QuantizedLinear

    def leaf_spec(path: str, v):
        spec = spec_for(path, rules)
        if isinstance(v, QuantizedLinear):
            scale_spec = P(*spec[:-2], spec[-1]) if len(spec) >= 2 else P()
            return QuantizedLinear(w_int8=spec, scale=scale_spec)
        return spec

    def walk(subtree: dict, prefix: str):
        out = {}
        for k, v in subtree.items():
            path = f"{prefix}/{k}" if prefix else k
            out[k] = walk(v, path) if isinstance(v, dict) else leaf_spec(path, v)
        return out

    return walk(params, "")


def batch_spec() -> P:
    """Activations (batch, seq, ...): batch over dp+fsdp, seq over sp."""
    return P(BATCH_AXES, "sp")


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None → ())."""
    if entry is None:
        return ()
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    for a in axes:
        if a not in AXES:
            raise ValueError(f"unknown mesh axis {a!r}")
    if list(axes) != sorted(axes, key=AXES.index):
        raise ValueError(f"axes {axes} must follow the mesh order {AXES}")
    return axes


def padded(spec, ndim: int) -> tuple:
    """``spec`` right-padded with None to ``ndim`` entries."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return spec + (None,) * (ndim - len(spec))


def sharded_axes(spec) -> set[str]:
    return {a for e in spec for a in entry_axes(e)}


def placements(spec, mesh: Mesh, ndim: int | None = None) -> list:
    """``DTensor`` placements of a leaf with ``spec``: one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    spec = padded(spec, ndim if ndim is not None else len(spec))
    out = [Replicate() for _ in AXES]
    for d, entry in enumerate(spec):
        for a in entry_axes(entry):
            out[AXES.index(a)] = Shard(d)
    return out


def local_slice(full: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``full`` under ``spec`` (a view; no
    communication). Every sharded dim must divide evenly."""
    out = full
    for d, entry in enumerate(padded(spec, full.ndim)):
        axes = entry_axes(entry)
        n = mesh.size_of(axes)
        if n == 1:
            continue
        if full.shape[d] % n:
            raise ValueError(f"dim {d} of a {tuple(full.shape)} leaf is not "
                             f"divisible by {axes} = {n}")
        size = full.shape[d] // n
        out = out.narrow(d, mesh.index(axes) * size, size)
    return out


def to_dtensor(local: torch.Tensor, spec, mesh: Mesh, full_shape):
    """Wrap this rank's ``local`` slice as the DTensor of ``full_shape``."""
    from torch.distributed.tensor import DTensor

    full_shape = torch.Size(full_shape)
    stride = torch.empty(full_shape, device="meta").stride()
    return DTensor.from_local(local, mesh.device_mesh,
                              placements(spec, mesh, len(full_shape)),
                              run_check=False, shape=full_shape,
                              stride=stride)


def distribute(full: torch.Tensor, spec, mesh: Mesh):
    """The DTensor of ``full`` under ``spec``: this rank keeps a copy of
    its slice only."""
    return to_dtensor(local_slice(full, spec, mesh).contiguous().clone(),
                      spec, mesh, full.shape)


def param_shardings(params: dict, mesh: Mesh,
                    rules: list[tuple[str, P]] | None = None):
    """Tree of ``DTensor`` placements for ``params``."""
    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        return placements(s, mesh, p.ndim)

    return walk(params, param_specs(params, rules))


def distribute_params(params: dict, mesh: Mesh,
                      rules: list[tuple[str, P]] | None = None) -> dict:
    """``params`` (full tensors on every rank, e.g. from
    models/convert.py) as a tree of DTensors under ``rules``."""
    specs = param_specs(params, rules)

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        return distribute(p, s, mesh)

    return walk(params, specs)


def constrain(x, mesh: Mesh | None, spec):
    """Redistribute a DTensor to ``spec``; a no-op off a mesh or on a
    plain tensor (the sharded model code keeps activations local)."""
    from torch.distributed.tensor import DTensor

    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh.device_mesh, placements(spec, mesh, x.ndim))


def full_tensor(x) -> torch.Tensor:
    """The whole tensor of a DTensor (a gather on every rank), or ``x``."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def local(x) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


# --------------------------------------------------- sharded compute


def unshard(w: torch.Tensor, spec, mesh: Mesh | None,
            keep: tuple[str, ...] = ("tp", "ep")) -> torch.Tensor:
    """The local shard ``w`` gathered whole along every axis of ``spec``
    outside ``keep``. A gather over ``fsdp`` (an axis that splits the
    batch) reduce-scatters its gradient; over any other axis the
    computation after it is replicated there, so the backward keeps the
    rank's own slice."""
    if mesh is None:
        return w
    for d, entry in enumerate(padded(spec, w.ndim)):
        axes = [a for a in entry_axes(entry) if a not in keep]
        # gather the innermost axis first: the major axis then
        # concatenates whole blocks of the minor one
        for a in reversed(axes):
            bwd = "sum" if a in SPLIT_AXES else "slice"
            w = comm.all_gather(w, d, mesh.group(a), bwd=bwd)
    return w


def grad_reduce_axes(spec, extra: tuple[str, ...] = ()) -> tuple[str, ...]:
    """The axes a leaf's local gradient is summed over after the
    backward: every axis that splits the batch, the sequence or the
    layers (dp, fsdp, sp, pp) and does not shard the leaf (a gather over
    an axis that shards it already reduce-scattered there), plus
    ``extra`` axes the caller knows it is partial over (a LoRA factor of
    a tp-sharded base). A leaf replicated over pp is touched by one
    pipeline stage, or by each stage in its own rows (the stacked norms
    of ``pipeline_rules``): the sum over pp is the whole gradient."""
    have = sharded_axes(spec)
    return tuple(a for a in AXES
                 if (a in SPLIT_AXES or a in extra) and a not in have)


def reduce_grad(g: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    import torch.distributed as dist

    for a in axes:
        grp = mesh.group(a)
        if grp is not None:
            dist.all_reduce(g, group=grp)
    return g


def split_batch(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """This rank's rows of a global batch: rows ``[r·B/n, (r+1)·B/n)``
    for its index r of n along (dp, fsdp)."""
    if mesh is None:
        return x
    n = mesh.size_of(BATCH_AXES)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} is not divisible by "
                         f"dp*fsdp = {n}")
    rows = x.shape[0] // n
    return x.narrow(0, mesh.index(BATCH_AXES) * rows, rows)

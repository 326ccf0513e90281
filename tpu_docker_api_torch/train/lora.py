"""LoRA fine-tuning: frozen base weights + trainable low-rank adapters
(counterpart of ``tpu_docker_api/train/lora.py``).

- **Two forwards, one model.** ``forward="merged"`` computes
  ``W' = W + (alpha/rank)·A@B`` for each adapted projection and runs the
  ordinary model loss on the merged tree; autograd through the merge
  gives exactly the LoRA gradients. ``forward="attached"`` (QLoRA) wraps
  each adapted projection in an ``ops.quant.LoraLinear`` leaf that
  evaluates ``Wx + s·(xA)B`` unmerged, so the merged tree never exists;
  over an int8 base (``quantize_base``) gradients reach the adapters
  through ``int8_linear``'s straight-through backward.
- **The base is frozen by construction.** The step's ``loss_fn`` closes
  over the base, outside ``state.params`` (the JAX step's
  ``const_args``): it never requires a gradient and gets no optimizer
  moments; they exist for the rank-sized adapters only.
- **Adapter-only checkpoints.** The ``TrainState`` under training holds
  only the adapters; train/checkpoint.py saves it in the port's format
  and ``restore_with_target`` reads it back into ``lora_abstract_state``
  (meta tensors). Serving merges or attaches them at load (serve
  ``--lora-ckpt``).

Targets match by leaf name anywhere in the tree (default ``("wq",
"wv")``). The adapters are a pure function of the seed: pair i of the
matched projections draws from its own generator seeded from ``(seed,
i)``.

- **Adapters shard like their base.** On a mesh ``A (L, d_in, r)``
  keeps the base weight's leading and input axes and ``B (L, r, d_out)``
  its leading and output axes (``lora_specs``), so the merge and the
  attached branch run on local shards: ``A_loc @ B_loc`` is the merged
  weight's local block. A factor is partial over the base's axes that
  do not shard it (A of a column-parallel base over tp, B over fsdp):
  its gradient is summed over them too (``mesh_lora_specs``).
"""

from __future__ import annotations

import os

import torch

from tpu_docker_api_torch.models import model_fns, param_dtypes, param_shapes
from tpu_docker_api_torch.models.common import trunc_normal_init
from tpu_docker_api_torch.ops.quant import LoraLinear
from tpu_docker_api_torch.parallel import sharding
from tpu_docker_api_torch.parallel.sharding import P
from tpu_docker_api_torch.train.trainer import (TrainState,
                                                default_optimizer,
                                                make_train_step,
                                                step_generator)

DEFAULT_TARGETS = ("wq", "wv")


def _walk_matched(params: dict, targets, prefix: str = ""):
    """Yield (path, leaf) for every matched projection, in traversal
    order (dict order is insertion order wherever param trees are
    built)."""
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _walk_matched(v, targets, path)
        elif k in targets and len(getattr(v, "shape", ())) >= 2:
            yield path, v


def _adapter_shapes(params: dict, rank: int, targets) -> tuple[dict, dict]:
    """(the adapter tree with ``{"a": shape, "b": shape}`` at every
    matched projection, each matched path's index in traversal order)."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    index = {p: i for i, (p, _) in enumerate(_walk_matched(params, targets))}
    if not index:
        raise ValueError(f"no parameters matched targets {targets!r}")

    def build(subtree: dict, prefix: str = "") -> dict:
        out = {}
        for k, v in subtree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                sub = build(v, path)
                if sub:
                    out[k] = sub
            elif path in index:
                *lead, d_in, d_out = v.shape
                out[k] = {"a": (*lead, d_in, rank), "b": (*lead, rank, d_out)}
        return out

    return build(params), index


def lora_init(params: dict, rank: int, generator: torch.Generator,
              targets=DEFAULT_TARGETS, dtype: torch.dtype = torch.float32
              ) -> dict:
    """Adapter tree mirroring the matched projections of ``params``: each
    matched ``(…, d_in, d_out)`` weight gets ``{"a": (…, d_in, rank),
    "b": (…, rank, d_out)}`` on ``generator``'s device, A fan-in-scaled
    truncated normal and B zero (so the merged model starts exactly at
    the base). Pair i draws from a generator seeded from
    ``(generator.initial_seed(), i)``, never from ``generator``'s own
    stream. ``params`` may hold meta tensors: only shapes are read.
    Adapters default to f32: they are small, and Adam updates accumulate
    without bf16 rounding."""
    shapes, index = _adapter_shapes(params, rank, targets)
    seed, device = generator.initial_seed(), generator.device
    pair = iter(range(len(index)))

    def build(tree: dict) -> dict:
        if "a" not in tree:
            return {k: build(v) for k, v in tree.items()}
        a_shape = tree["a"]
        return {"a": trunc_normal_init(
                    step_generator(seed, next(pair), device), a_shape,
                    a_shape[-2], dtype),
                "b": torch.zeros(tree["b"], dtype=dtype, device=device)}

    return build(shapes)


def _is_pair(a) -> bool:
    return isinstance(a, dict) and "a" in a and not isinstance(a["a"], dict)


def merge_lora(params: dict, adapters: dict, alpha: float = 16.0) -> dict:
    """Base tree with ``W + (alpha/rank)·A@B`` at every adapted leaf (rank
    read off A). The delta computes in the adapter dtype (f32) and casts
    to the base dtype at the add, so a bf16 base keeps its dtype. An int8
    base raises: merging would quantize the delta away."""
    def walk(p: dict, a: dict) -> dict:
        out = {}
        for k, v in p.items():
            if k in a and _is_pair(a[k]) and not isinstance(v, dict):
                if not isinstance(v, torch.Tensor):
                    raise ValueError(
                        f"cannot merge adapters into a {type(v).__name__}"
                        f" base at {k!r} — int8 bases need the unmerged "
                        f"forward (attach_lora / forward='attached')")
                pa, pb = a[k]["a"], a[k]["b"]
                delta = (alpha / pa.shape[-1]) * torch.matmul(pa, pb)
                out[k] = (v.to(delta.dtype) + delta).to(v.dtype)
            elif isinstance(v, dict):
                out[k] = walk(v, a.get(k, {}))
            else:
                out[k] = v
        return out

    return walk(params, adapters)


def attach_lora(params: dict, adapters: dict, alpha: float = 16.0) -> dict:
    """Base tree with ``ops.quant.LoraLinear`` leaves at every adapted
    projection: the unmerged (QLoRA) forward, ``linear(x, W) +
    (alpha/r)·(x@A)@B`` per projection. Over an int8 base
    (``quantize_base``) the merged tree never materializes."""
    def walk(p: dict, a: dict) -> dict:
        out = {}
        for k, v in p.items():
            if k in a and _is_pair(a[k]) and not isinstance(v, dict):
                pa = a[k]["a"]
                out[k] = LoraLinear(v, pa, a[k]["b"], alpha / pa.shape[-1])
            elif isinstance(v, dict):
                out[k] = walk(v, a.get(k, {}))
            else:
                out[k] = v
        return out

    return walk(params, adapters)


def quantize_base(base_params: dict) -> dict:
    """Int8-quantize a Llama frozen base for QLoRA: the serving quantizer
    itself (infer/quantize.py), so ``serve --quantize --lora-forward
    attached`` runs the base numerics the adapters were trained on."""
    from tpu_docker_api_torch.infer.quantize import quantize_llama_params

    return quantize_llama_params(base_params)


def init_base_params(cfg, generator: torch.Generator, mesh=None) -> dict:
    """Random base params on ``generator``'s device: the params-only half
    of ``trainer.create_train_state`` (the base is frozen, so it has no
    optimizer state); DTensors of this rank's slices on a ``mesh``."""
    model_init, _, rules = model_fns(cfg)
    if mesh is None:
        return model_init(cfg, generator)
    return model_init(cfg, generator, place=lambda path, t: (
        sharding.distribute(t, sharding.spec_for(path, rules), mesh)))


def lora_specs(adapters: dict, rules=None, prefix: str = "") -> dict:
    """Specs of an adapter tree, from the BASE weight's rule: A keeps the
    base's leading and input axes (rank dim unsharded), B its leading
    and output axes."""
    out = {}
    for k, v in adapters.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) and "a" in v and not isinstance(v["a"], dict):
            base = sharding.spec_for(path, rules)
            nd = len(v["a"].shape)
            spec = (None,) * (nd - len(base)) + tuple(base)
            out[k] = {"a": P(*spec[:-1], None),
                      "b": P(*spec[:-2], None, spec[-1])}
        elif isinstance(v, dict):
            out[k] = lora_specs(v, rules, path)
    return out


def lora_shardings(adapters: dict, mesh, rules=None) -> dict:
    """Tree of DTensor placements for an adapter tree."""
    def walk(a, s):
        if isinstance(a, dict):
            return {k: walk(a[k], s[k]) for k in a}
        return sharding.placements(s, mesh, a.ndim)

    return walk(adapters, lora_specs(adapters, rules))


def mesh_lora_specs(adapters: dict, rules=None, prefix: str = "") -> dict:
    """(spec, gradient-reduction axes) of every adapter leaf
    (``trainer.mesh_specs``): the batch axes, and the axes that shard
    the base but not the factor, over which the factor's local gradient
    is a partial sum."""
    out = {}
    for k, v in adapters.items():
        path = f"{prefix}/{k}" if prefix else k
        if _is_pair(v):
            specs = lora_specs({k: v}, rules, prefix)[k]
            base = sharding.sharded_axes(sharding.spec_for(path, rules))
            out[k] = {n: (specs[n], sharding.grad_reduce_axes(
                specs[n], tuple(base - sharding.sharded_axes(specs[n]))))
                for n in ("a", "b")}
        else:
            out[k] = mesh_lora_specs(v, rules, path)
    return out


def _distribute_adapters(adapters: dict, mesh, rules) -> dict:
    specs = lora_specs(adapters, rules)

    def walk(a, s):
        if isinstance(a, dict):
            return {k: walk(a[k], s[k]) for k in a}
        return sharding.distribute(a, s, mesh)

    return walk(adapters, specs)


def _meta_base(cfg) -> dict:
    """``cfg``'s param tree as meta tensors (shapes and dtype only)."""
    def walk(shapes, dtypes):
        if isinstance(shapes, dict):
            return {k: walk(v, dtypes[k]) for k, v in shapes.items()}
        return torch.empty(shapes, dtype=dtypes, device="meta")

    return walk(param_shapes(cfg), param_dtypes(cfg))


def create_lora_state(cfg, generator: torch.Generator, rank: int,
                      targets=DEFAULT_TARGETS, optimizer=None, mesh=None
                      ) -> tuple[TrainState, object]:
    """(TrainState over the adapters, optimizer): the trainable half, on
    ``generator``'s device (DTensors under ``lora_specs`` on a
    ``mesh``). The frozen base comes separately (``init_base_params``,
    ``restore_base_params``)."""
    optimizer = optimizer or default_optimizer()
    adapters = lora_init(_meta_base(cfg), rank, generator, targets)
    if mesh is not None:
        adapters = _distribute_adapters(adapters, mesh, model_fns(cfg)[2])
    return TrainState(0, adapters, optimizer.init(adapters)), optimizer


def make_lora_train_step(cfg, optimizer, base_params: dict,
                         alpha: float = 16.0, forward: str = "merged",
                         mesh=None):
    """(state, tokens) → (state, metrics) where ``state.params`` are the
    adapters. ``"merged"`` merges every step and runs the family's
    ordinary loss (a transient weight-sized copy); ``"attached"`` runs
    the unmerged forward through ``attach_lora``, the one that is exact
    over an int8 base. ``base_params`` is closed over: no gradient, no
    moments, never copied."""
    if forward not in ("merged", "attached"):
        raise ValueError(f"forward must be merged|attached, got {forward!r}")
    _, model_loss, rules = model_fns(cfg)
    combine = merge_lora if forward == "merged" else attach_lora
    if mesh is None:
        def loss_fn(adapters, tokens):
            return model_loss(combine(base_params, adapters, alpha), tokens,
                              cfg)

        return make_train_step(cfg, optimizer, loss_fn=loss_fn)
    base_local = _map_leaves(sharding.local, base_params)

    def mesh_loss(adapters, tokens):
        return model_loss(combine(base_local, adapters, alpha), tokens, cfg,
                          mesh=mesh)

    return make_train_step(cfg, optimizer, loss_fn=mesh_loss, mesh=mesh,
                           specs=lambda a: mesh_lora_specs(a, rules))


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def lora_abstract_state(cfg, rank: int, targets, optimizer) -> TrainState:
    """The adapter-only ``TrainState`` as meta tensors: the target
    ``CheckpointManager.restore_with_target`` restores into."""
    adapters = _meta_adapters(cfg, rank, targets)
    return TrainState(0, adapters, optimizer.init(adapters))


def _meta_adapters(cfg, rank: int, targets) -> dict:
    shapes, _ = _adapter_shapes(_meta_base(cfg), rank, targets)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return torch.empty(tree, dtype=torch.float32, device="meta")

    return walk(shapes)


def restore_adapters(directory, cfg, device: str | torch.device, rank: int,
                     targets=DEFAULT_TARGETS) -> dict:
    """The adapters of the latest step of an adapter-only checkpoint,
    params only, whichever optimizer trained them; raises
    FileNotFoundError for a missing or empty directory."""
    from tpu_docker_api_torch.train.checkpoint import CheckpointManager

    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    return CheckpointManager(directory).restore_params_with_target(
        _meta_adapters(cfg, rank, targets), device=device)


def restore_base_params(directory, cfg, device: str | torch.device,
                        mesh=None) -> dict:
    """The frozen base from a full training checkpoint: params only, so a
    base trained under any optimizer (``adamw-int8`` too) loads; raises
    FileNotFoundError for a missing or empty directory, so an explicit
    base never falls back to random weights."""
    from tpu_docker_api_torch.train.checkpoint import restore_model_params

    params, _ = restore_model_params(directory, cfg, device, mesh=mesh)
    return params


def lora_resume_or_init(directory, cfg, device: str | torch.device,
                        generator: torch.Generator, rank: int,
                        targets=DEFAULT_TARGETS, optimizer=None,
                        max_to_keep: int = 3, mesh=None):
    """(state, optimizer, manager): the latest adapter checkpoint of
    ``directory`` if there is one, else fresh adapters from
    ``generator`` (``train.checkpoint.resume_or_init`` for adapters)."""
    from tpu_docker_api_torch.train.checkpoint import CheckpointManager

    optimizer = optimizer or default_optimizer()
    mgr = CheckpointManager(directory, max_to_keep=max_to_keep)
    if mgr.latest_step() is not None:
        if mesh is not None:
            # a target of this mesh's shards: the fresh state, overwritten
            fresh, _ = create_lora_state(cfg, generator, rank, targets,
                                         optimizer, mesh)
            return (mgr.restore_with_target(fresh, device=device), optimizer,
                    mgr)
        target = lora_abstract_state(cfg, rank, targets, optimizer)
        return mgr.restore_with_target(target, device=device), optimizer, mgr
    state, optimizer = create_lora_state(cfg, generator, rank, targets,
                                         optimizer, mesh)
    return state, optimizer, mgr

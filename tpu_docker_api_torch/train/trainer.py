"""Training step (counterpart of ``tpu_docker_api/train/trainer.py``).

The JAX step is one jitted function over sharded state. The port's step
runs eagerly: autograd through the model's loss, then the optimizer's
pure update and ``apply_updates``, all under the caller's stream with no
host sync. The JAX step's ``const_args`` (a frozen tree passed as a jit
operand, LoRA's base) is a closure here: train/lora.py's ``loss_fn``
closes over the base, outside ``state.params``, so it never requires a
gradient and gets no moments.

With a ``mesh`` (parallel/mesh.py; one process a device) the params and
the optimizer state are ``DTensor``s placed by the family's rules, the
moments like their params. Each rank takes its rows of the same global
batch, runs the family's sharded loss on its local shards (its share of
the global mean), and sums each gradient over the axes that split the
batch where the leaf is not sharded (``grad_reduce_axes``) before the
optimizer sees it, exactly once. A ``grad_fn`` in place of the loss
(parallel/pipeline.py's 1F1B schedule) hands back the loss and the
gradients itself; they are reduced the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from tpu_docker_api_torch.models import model_fns
from tpu_docker_api_torch.models.common import seeded_generator
from tpu_docker_api_torch.parallel import sharding
from tpu_docker_api_torch.telemetry.profile import span
from tpu_docker_api_torch.train.optim import (GradientTransformation,
                                              adamw, apply_updates, chain,
                                              clip_by_global_norm,
                                              global_norm, tree_leaves,
                                              tree_map)

#: profiler ranges of a train step: the loss (autograd path only), its
#: ``torch.autograd.grad``, and the optimizer's whole no-grad block
#: (update, ``apply_updates``, the metrics' norm)
FORWARD_RANGE = "train_step.forward"
BACKWARD_RANGE = "train_step.backward"
OPTIMIZER_RANGE = "train_step.optimizer"
STEP_RANGES = (FORWARD_RANGE, BACKWARD_RANGE, OPTIMIZER_RANGE)


@dataclasses.dataclass
class TrainState:
    step: int          # host counter: reading it never syncs the device
    params: dict
    opt_state: Any


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      clip_norm: float = 1.0) -> GradientTransformation:
    return chain(clip_by_global_norm(clip_norm),
                 adamw(lr, b1=0.9, b2=0.95, weight_decay=weight_decay))


def create_train_state(
    cfg,
    device: str | torch.device,
    generator: torch.Generator | None = None,
    optimizer: GradientTransformation | None = None,
    mesh=None,
    rules=None,
) -> tuple[TrainState, GradientTransformation]:
    """Random parameters on ``device`` (from ``generator``, seed 0 if
    None) and the optimizer's initial state. ``cfg`` may be any
    registered model config. On a ``mesh`` every rank draws each leaf
    as the single-device init does, keeps its slice as a DTensor and
    lets the rest go (models/common.py ``init_tree``), so the params are
    the single-device ones bit for bit and no rank holds more than one
    whole leaf. ``rules`` overrides the family's sharding rules (e.g.
    parallel/pipeline.py's pp-aware ``pipeline_rules``)."""
    device = torch.device(device)
    optimizer = optimizer or default_optimizer()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, state asked "
                         f"on {device}")
    model_init, _, model_rules = model_fns(cfg)
    rules = model_rules if rules is None else rules
    if mesh is None:
        params = model_init(cfg, generator)
    else:
        params = model_init(cfg, generator, place=lambda path, t: (
            sharding.distribute(t, sharding.spec_for(path, rules), mesh)))
    return TrainState(0, params, optimizer.init(params)), optimizer


def mesh_specs(params: dict, rules) -> dict:
    """(spec, gradient-reduction axes) for every leaf of ``params``: the
    rule's spec and its ``grad_reduce_axes``."""
    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = walk(v, path)
            else:
                spec = sharding.spec_for(path, rules)
                out[k] = (spec, sharding.grad_reduce_axes(spec))
        return out

    return walk(params, "")


def make_train_step(
    cfg,
    optimizer: GradientTransformation,
    loss_fn: Callable | None = None,
    mesh=None,
    specs: Callable | None = None,
    grad_fn: Callable | None = None,
    rules=None,
) -> Callable:
    """(state, batch) → (state, metrics). ``batch`` is whatever the
    model's loss takes: a token tensor for the decoder families, a tuple
    of tensors ((images, labels) for ViT, (src, tgt) for the
    encoder-decoder), each moved to the params' device, as the JAX step
    shards every leaf of a batch pytree on its leading axis. ``metrics``
    holds ``loss`` and ``grad_norm`` as device tensors (reading them
    waits for the device, so a caller reads them only where it needs the
    value) and ``step`` as an int. Every parameter must receive a
    gradient: an unused one raises rather than training on silently.
    ``grad_fn(params, batch) -> (loss, grads)`` bypasses autograd for
    schedules that hand-compute their backward (parallel/pipeline.py's
    1F1B); it excludes ``loss_fn``, as in JAX.

    With a ``mesh`` the state's leaves are DTensors; ``loss_fn(local
    params, local batch)`` (default: the family's loss with ``mesh``)
    returns this rank's share of the global mean, or ``grad_fn`` that
    share and the local gradients, and ``specs(params)`` (default:
    :func:`mesh_specs` under ``rules``, the family's if None), read at
    the first step, names each leaf's gradient reduction.
    ``metrics["loss"]`` is the global loss on every rank; on a pp mesh
    the last stage holds it and broadcasts it over pp. A pp mesh needs
    the pipeline's ``loss_fn`` or ``grad_fn``: the family's loss would
    run the whole model on every stage."""
    if grad_fn is not None and loss_fn is not None:
        raise ValueError("pass loss_fn or grad_fn, not both")
    if mesh is not None:
        return _make_mesh_step(cfg, optimizer, loss_fn, grad_fn, mesh,
                               specs, rules)
    if loss_fn is None and grad_fn is None:
        _, model_loss, _ = model_fns(cfg)

        def loss_fn(params, batch):
            return model_loss(params, batch, cfg)

    def step(state: TrainState, batch):
        device = tree_leaves(state.params)[0].device
        if isinstance(batch, (tuple, list)):
            batch = tuple(t.to(device, non_blocking=True) for t in batch)
        else:
            batch = batch.to(device, non_blocking=True)
        loss, grads = _loss_and_grads(loss_fn, grad_fn, state.params,
                                      batch)
        with span(OPTIMIZER_RANGE), torch.no_grad():
            updates, new_opt = optimizer.update(grads, state.opt_state,
                                                state.params)
            new_params = apply_updates(state.params, updates)
            metrics = {"loss": loss.detach(),
                       "grad_norm": global_norm(grads),
                       "step": state.step + 1}
        return TrainState(state.step + 1, new_params, new_opt), metrics

    return step


def _loss_and_grads(loss_fn, grad_fn, params, batch):
    """(loss, grads) at the params' local shards: ``grad_fn``'s own, or
    ``torch.autograd.grad`` of ``loss_fn``."""
    local = sharding.local
    if grad_fn is not None:
        return grad_fn(tree_map(lambda p: local(p).detach(), params), batch)
    live = tree_map(lambda p: local(p).detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    with span(FORWARD_RANGE):
        loss = loss_fn(live, batch)
    with span(BACKWARD_RANGE):
        flat = iter(torch.autograd.grad(loss, leaves))
    return loss, tree_map(lambda _: next(flat), live)


def _make_mesh_step(cfg, optimizer, loss_fn, grad_fn, mesh, specs, rules):
    import torch.distributed as dist

    _, model_loss, model_rules = model_fns(cfg)
    rules = model_rules if rules is None else rules
    if loss_fn is None and grad_fn is None:
        if mesh.shape["pp"] > 1:
            raise ValueError("a pp mesh needs the pipeline's loss_fn or "
                             "grad_fn (parallel/pipeline.py)")

        def loss_fn(params, batch):
            return model_loss(params, batch, cfg, mesh=mesh)
    if specs is None:
        def specs(params):
            return mesh_specs(params, rules)
    known: dict = {}
    pp_group = mesh.group("pp")
    last_stage = (None if pp_group is None else
                  dist.get_global_rank(pp_group, mesh.shape["pp"] - 1))

    def step(state: TrainState, batch):
        device = sharding.local(tree_leaves(state.params)[0]).device
        if "reduce" not in known:
            known["reduce"] = specs(state.params)
        reduce = known["reduce"]

        def mine(t):
            return sharding.split_batch(t, mesh).to(device,
                                                    non_blocking=True)

        batch = (tuple(mine(t) for t in batch)
                 if isinstance(batch, (tuple, list)) else mine(batch))
        loss, grads = _loss_and_grads(loss_fn, grad_fn, state.params, batch)
        with span(OPTIMIZER_RANGE), torch.no_grad():
            grads = tree_map(
                lambda g, p, r: sharding.to_dtensor(
                    sharding.reduce_grad(g.contiguous(), r[1], mesh),
                    r[0], mesh, p.shape),
                grads, state.params, reduce)
            loss = loss.detach().clone()
            for a in sharding.BATCH_AXES + ("sp",):
                if mesh.group(a) is not None:
                    dist.all_reduce(loss, group=mesh.group(a))
            if pp_group is not None:
                dist.broadcast(loss, src=last_stage, group=pp_group)
            updates, new_opt = optimizer.update(grads, state.opt_state,
                                                state.params)
            new_params = apply_updates(state.params, updates)
            metrics = {"loss": loss, "grad_norm": global_norm(grads),
                       "step": state.step + 1}
        return TrainState(state.step + 1, new_params, new_opt), metrics

    return step


def synthetic_batch(generator: torch.Generator, batch: int, seq: int,
                    vocab: int) -> torch.Tensor:
    """Synthetic token stream, (batch, seq + 1) on the generator's device
    (the data layer for the smoke run and tests)."""
    return torch.randint(0, vocab, (batch, seq + 1), generator=generator,
                         device=generator.device)


def step_generator(seed: int, step: int,
                   device: str | torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)`` alone, so a
    step's batch is a pure function of the two, as the JAX trainer's
    ``synthetic_batch(PRNGKey(step), ...)``: a run resumed at step N
    draws the batch the stopped run would have drawn at step N."""
    return seeded_generator(device, seed, step)

"""Shared model-construction helpers (counterpart of
``tpu_docker_api/models/common.py``), and the selective-checkpoint
policy every family trains under (the JAX package's
``TRAIN_REMAT_POLICY``, ``tpu_docker_api/ops/flash_pallas.py``)."""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from tpu_docker_api_torch.ops import flash


def trunc_normal_init(generator: torch.Generator, shape, fan_in: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """Truncated-normal fan-in initializer: N(0, 1/fan_in) clipped at ±2σ,
    drawn in f32 on the generator's device and cast to the storage dtype.
    torch and jax.random draw different numbers from one seed; weights
    cross between the two packages through models/convert.py instead."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * fan_in**-0.5).to(dtype)


def seeded_generator(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``key`` alone
    (mixed by numpy's ``SeedSequence``): the port's ``fold_in``. A
    synthetic batch drawn from ``(seed, step)`` is a pure function of
    the two, and a row drawn from ``(seed, step, row)`` of the three,
    whatever the batch around it."""
    mixed = np.random.SeedSequence(list(key)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(
        int(mixed[0]) & (2**63 - 1))


def draw_stacked(generator: torch.Generator, shape, fan_in: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """``trunc_normal_init`` of a stacked leaf, one (…, in, out) matrix
    at a time into a tensor allocated once in ``dtype``: the f32
    temporaries are one matrix, never the whole leaf (a Mixtral-width
    ``w_gate`` of 16 layers is 7.5 G elements)."""
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    mats = out.view(-1, *shape[-2:]) if len(shape) > 2 else out[None]
    for m in mats:
        m.copy_(trunc_normal_init(generator, m.shape, fan_in, dtype))
    return out


def init_tree(specs: dict, draw, place=None, prefix: str = "") -> dict:
    """The param tree of ``specs`` with every leaf ``draw(spec)`` in the
    specs' order (the order each family's generator stream follows).
    ``place(path, leaf)``, if given, replaces a leaf as soon as it is
    drawn: the sharded init keeps a rank's slice there and lets the rest
    go, so a rank never holds more than one whole leaf."""
    out = {}
    for k, v in specs.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out[k] = init_tree(v, draw, place, path)
        else:
            leaf = draw(v)
            out[k] = leaf if place is None else place(path, leaf)
    return out


def remat_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep ONLY the flash forward's
    (out, lse) and recompute every other op, matmuls included — the JAX
    package's ``TRAIN_REMAT_POLICY``. The backward then runs the flash
    backward kernels on the kept residuals and never re-runs the forward
    kernel, which plain checkpointing would (once more per layer)."""
    return (CheckpointPolicy.MUST_SAVE if op is flash.FLASH_OP
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_context():
    return create_selective_checkpoint_contexts(remat_policy)


def remat_call(fn, *args):
    """``fn(*args)`` checkpointed under :func:`remat_policy` (the block of
    a family whose config has ``remat``, while autograd is on)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=remat_context)

"""Single-device training-throughput harness (counterpart of
``tpu_docker_api/train/benchlib.py``): the ViT-B/16 images/s and
encdec-base pairs/s measurements go through it.

The JAX harness builds a one-device mesh; the port's step is
single-device already. Warm-up steps first (the first call builds the
kernels and grows the allocator), then a timed loop closed by a
device-to-host read of the loss: the host cannot read the value before
every queued step has run.
"""

from __future__ import annotations

import time

import torch


def time_train_steps(cfg, batch_data, steps: int = 8, warmup: int = 2,
                     device: str | torch.device = "cuda",
                     optimizer=None) -> dict:
    """{"steps_per_sec", "loss"} for ``cfg`` trained on ``batch_data``
    (a token tensor or a tuple batch) on ``device``, from seed-0 random
    weights; ``optimizer`` defaults to the trainer's AdamW."""
    from tpu_docker_api_torch.train.trainer import (create_train_state,
                                                    make_train_step)

    device = torch.device(device)
    state, opt = create_train_state(
        cfg, device, torch.Generator(device=device).manual_seed(0),
        optimizer=optimizer)
    step = make_train_step(cfg, opt)
    for _ in range(max(warmup, 1)):
        state, metrics = step(state, batch_data)
    float(metrics["loss"])  # host read: every warm-up step has run
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, batch_data)
    loss = float(metrics["loss"])
    dt = time.perf_counter() - t0
    return {"steps_per_sec": steps / dt, "loss": loss}

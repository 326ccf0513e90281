"""MNIST MLP, BASELINE.json config #2, the single-card smoke workload
(counterpart of ``tpu_docker_api/models/mlp.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mlp_init(generator: torch.Generator, sizes=(784, 512, 256, 10),
             dtype: torch.dtype = torch.float32) -> dict:
    """``dense_i`` layers of N(0, 1/fan_in) weights and zero biases on the
    generator's device."""
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn(fan_in, fan_out, generator=generator,
                        device=generator.device) * fan_in**-0.5
        params[f"dense_{i}"] = {
            "w": w.to(dtype),
            "b": torch.zeros(fan_out, dtype=dtype, device=generator.device),
        }
    return params


def mlp_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(batch, 784) → (batch, 10) logits."""
    n = len(params)
    for i in range(n):
        layer = params[f"dense_{i}"]
        x = x @ layer["w"] + layer["b"]
        if i < n - 1:
            x = F.relu(x)
    return x


def mlp_loss(params: dict, x: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(mlp_forward(params, x), dim=-1)
    return -logp.gather(-1, labels[:, None].long()).mean()

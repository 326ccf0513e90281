"""PyTorch/CUDA port of ``tpu_docker_api``: the model, training and
serving stack, and the single-host container control plane
(``python -m tpu_docker_api_torch -c cfg.toml``).

The module layout and function names mirror the JAX package
(``ops/``, ``models/``, ``infer/``, ``serve/``, ``state/``,
``service/``, ``api/``), so each function has its counterpart one path
away. The port imports ``torch`` only: nothing
from JAX and nothing from ``tpu_docker_api``.

Hand-written CUDA kernels live in ``csrc/`` and are built at first use
by ``_build.py``. Entry points run on ``cuda`` unless the caller asks
for the CPU; without a card they raise instead of carrying on there.
"""

from __future__ import annotations


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Asking for CUDA on a machine without a card raises —
    no entry point silently carries on on the CPU."""
    # imported here, not with the package: the control-plane daemon needs
    # no torch, and importing it costs its boot seconds
    import torch

    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but no CUDA device is available; pass "
            "device='cpu' (or --device cpu) to run on the CPU")
    return dev

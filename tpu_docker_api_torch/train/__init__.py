"""Training (counterpart of ``tpu_docker_api/train``): the single-device
train step, its optimizers and the ``python -m tpu_docker_api_torch.train``
entry point."""

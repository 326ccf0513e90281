"""Service / orchestration layer (parity: reference L2 — ``internal/service/``):
the port's container and volume services, the health watcher, the
reconciler, the store's health machine and the invariants the chaos tests
judge by. The job, admission, serving, workflow, gateway, leader and shard
services come with the rest of the control plane (ROADMAP Queue 1 item
10)."""

from tpu_docker_api_torch.service.container import ContainerService  # noqa: F401
from tpu_docker_api_torch.service.volume import VolumeService  # noqa: F401

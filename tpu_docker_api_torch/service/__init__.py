"""Service / orchestration layer (parity: reference L2 — ``internal/service/``):
the port's container, volume and job services, the job supervisor and
host monitor, the capacity market (admission), the Service resource
(serving), workflows, leader election, the sharded writer plane, the
history compactor, the serving gateway, the health watcher, the
reconciler, the store's health machine and the invariants the chaos
tests judge by."""

from tpu_docker_api_torch.service.container import ContainerService  # noqa: F401
from tpu_docker_api_torch.service.volume import VolumeService  # noqa: F401

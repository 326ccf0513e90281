"""Container runtime adapter layer (parity: reference L5 — ``internal/docker/``).

The reference exposes a raw global docker SDK client with no seam
(docker/client.go:7-14), which is why it has zero tests (SURVEY.md §4). Here
the docker surface the service layer actually uses (enumerated from the call
stacks in SURVEY.md §3) is an abstract ``ContainerRuntime`` with two
implementations: ``DockerRuntime`` (Engine REST API over the unix socket, no
SDK dependency; GPUs attached as nvidia ``DeviceRequests``) and
``FakeRuntime`` (in-memory, real tmp dirs, optional real exec) for hermetic
tests; ``faulty`` wraps either with scripted faults for the chaos tests, and
``fanout`` runs a batch of engine calls on a bounded pool.
"""

from tpu_docker_api_torch.runtime.base import (  # noqa: F401
    ContainerInfo,
    ContainerRuntime,
    ExecResult,
    VolumeInfo,
)
from tpu_docker_api_torch.runtime.fake import FakeRuntime  # noqa: F401
from tpu_docker_api_torch.runtime.faulty import FaultPlan, FaultRule, FaultyRuntime, fail_nth  # noqa: F401
from tpu_docker_api_torch.runtime.spec import ContainerSpec, PortBinding, render_gpu_attachment  # noqa: F401


def open_runtime(backend: str, **kwargs):
    if backend == "fake":
        return FakeRuntime(**kwargs)
    if backend == "docker":
        from tpu_docker_api_torch.runtime.docker_http import DockerRuntime

        return DockerRuntime(**kwargs)
    raise ValueError(f"unknown runtime backend {backend!r}")

"""Wire formats of the port (parity: reference ``internal/model/``): the
GPU telemetry schema. Request and state DTOs come with the rest of the
control plane (ROADMAP Queue 1 item 10)."""

from tpu_docker_api_torch.schemas.gpu import ChipInfo, HostTopologyInfo  # noqa: F401

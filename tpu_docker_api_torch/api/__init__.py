"""HTTP API layer of the port (parity: reference L1 — ``internal/api/``)."""

from tpu_docker_api_torch.api.app import ApiServer, build_handler  # noqa: F401

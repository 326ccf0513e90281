"""Wire formats of the port (parity: reference ``internal/model/``): the
GPU telemetry schema and the container, volume and state DTOs; the job,
service and workflow DTOs in ``schemas/job.py``, ``schemas/service.py``
and ``schemas/workflow.py``."""

from tpu_docker_api_torch.schemas.container import (  # noqa: F401
    Bind,
    ContainerCommit,
    ContainerDelete,
    ContainerExecute,
    ContainerPatchChips,
    ContainerPatchVolume,
    ContainerPort,
    ContainerRun,
    ContainerStop,
)
from tpu_docker_api_torch.schemas.gpu import ChipInfo, HostTopologyInfo  # noqa: F401
from tpu_docker_api_torch.schemas.state import ContainerState, VolumeState  # noqa: F401
from tpu_docker_api_torch.schemas.volume import (  # noqa: F401
    VOLUME_SIZE_UNITS,
    VolumeCreate,
    VolumeDelete,
    VolumeSize,
)

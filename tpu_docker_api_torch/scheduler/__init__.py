"""Resource schedulers of the port (parity: reference L3 —
``internal/scheduler/``).

The port scheduler is a near-direct functional port. The GPU scheduler
keeps the JAX package's shape-aware allocator over a host's line of NVML
indices and hands out their UUIDs (``ChipScheduler.uuids_of``), where the
reference hands out arbitrary UUIDs by nondeterministic map iteration
(gpuscheduler/scheduler.go:64-90).
"""

from tpu_docker_api_torch.scheduler.ports import PortScheduler  # noqa: F401
from tpu_docker_api_torch.scheduler.slices import ChipScheduler  # noqa: F401
from tpu_docker_api_torch.scheduler.topology import (  # noqa: F401
    GENERATIONS,
    Generation,
    HostTopology,
    parse_accelerator_type,
)

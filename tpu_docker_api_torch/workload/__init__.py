"""Workload layer of the port (counterpart of
``tpu_docker_api/workload/``): the distributed environment the control
plane renders into a job's containers, and the bootstrap the trainer
and the server run from it."""

from tpu_docker_api_torch.workload.torchenv import (  # noqa: F401
    DistributedJob,
    ProcessPlacement,
    bootstrap_torch,
    launch_workers,
    render_distributed_env,
)

"""One rank of the job end-to-end test (tests/test_torch_job_e2e.py): joins
the world its environment describes through the port's bootstrap, sums its
rank + 1 over every rank with one gloo ``all_reduce``, and writes what it
saw to ``$JOB_RANK_OUT/rank<RANK>.json``. Run as ``python -m
torch_job_rank`` by ``workload.torchenv.launch_workers``; imports no JAX."""

import json
import os

import torch
import torch.distributed as dist

from tpu_docker_api_torch.workload.torchenv import bootstrap_torch


def main() -> None:
    _, rank, world = bootstrap_torch("cpu", timeout_s=60.0)
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    with open(os.path.join(os.environ["JOB_RANK_OUT"],
                           f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "world": world, "sum": x.item(),
                   "master": f"{os.environ['MASTER_ADDR']}:"
                             f"{os.environ['MASTER_PORT']}"}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()

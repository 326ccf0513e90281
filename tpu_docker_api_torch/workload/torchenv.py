"""Distributed bootstrap of the port's workloads (counterpart of
``tpu_docker_api/workload/jaxenv.py``).

JAX drives every chip of a job from one process per host and
assembles the mesh through ``jax.distributed.initialize`` (the
``JAX_*`` variables) and libtpu (``TPU_*``, ``MEGASCALE_*``). The port
runs one process per GPU and reads what ``torchrun`` and every other
PyTorch launcher set:

- ``MASTER_ADDR`` / ``MASTER_PORT``: the rendezvous of rank 0;
- ``WORLD_SIZE`` / ``RANK``: the job's processes and this one's index;
- ``LOCAL_RANK``: the GPU of this process among those its container
  sees (``cuda:LOCAL_RANK``).

:func:`render_distributed_env` emits them for one process of a
:class:`DistributedJob`, one process a granted GPU; the TPU-only
``TPU_*`` and ``MEGASCALE_*`` variables have no counterpart (NCCL finds
NVLink and the network itself). :func:`bootstrap_torch` reads them in
the workload; :func:`launch_workers` is the launcher the trainer and
the server use when one command is given several GPUs (or, on the CPU,
``--nproc-per-node`` gloo ranks).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import time

@dataclasses.dataclass
class ProcessPlacement:
    """One process (= one container) of a distributed job."""
    process_id: int
    host: str                 # routable address of the host running it
    gpu_uuids: list[str]      # the GPUs its container is granted
    local_rank: int = 0       # its GPU among those (cuda:local_rank)


@dataclasses.dataclass
class DistributedJob:
    """A placement of N processes forming one torch.distributed job."""
    name: str
    placements: list[ProcessPlacement]
    master_port: int

    @property
    def master_address(self) -> str:
        # rank 0 hosts the rendezvous store; placements order is not
        # assumed
        return next(p.host for p in self.placements if p.process_id == 0)


def render_distributed_env(job: DistributedJob,
                           placement: ProcessPlacement) -> list[str]:
    """The ``KEY=value`` environment of one process of ``job``."""
    if len(placement.gpu_uuids) != 1:
        raise ValueError(f"process {placement.process_id} of {job.name} "
                         f"holds {len(placement.gpu_uuids)} GPUs: the "
                         f"port runs one process a GPU")
    return [
        f"MASTER_ADDR={job.master_address}",
        f"MASTER_PORT={job.master_port}",
        f"WORLD_SIZE={len(job.placements)}",
        f"RANK={placement.process_id}",
        f"LOCAL_RANK={placement.local_rank}",
    ]


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_size() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def bootstrap_torch(device: str = "cuda", force: bool = False,
                    timeout_s: float = 600.0):
    """Join the job the environment describes: ``(device, rank,
    world_size)``. With ``WORLD_SIZE`` above 1, or ``force`` (the mesh
    path at one rank), ``init_process_group`` runs, NCCL on ``cuda``
    (device ``cuda:LOCAL_RANK``) and gloo on ``cpu``; without
    ``MASTER_ADDR`` a one-rank group rendezvous on a free local port.
    A collective that waits ``timeout_s`` for a rank that fell out
    raises instead of hanging."""
    import datetime

    import torch
    import torch.distributed as dist

    from tpu_docker_api_torch import resolve_device

    dev = resolve_device(device)
    ws, rank = world_size(), int(os.environ.get("RANK", "0"))
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if (ws > 1 or force) and not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ.get("MASTER_PORT") or str(free_port())
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{addr}:{port}", rank=rank, world_size=ws,
            timeout=datetime.timedelta(seconds=timeout_s),
            **({"device_id": dev} if dev.type == "cuda" else {}))
    return dev, rank, ws


def launch_workers(module: str, argv: list[str], nproc: int,
                   device: str) -> int:
    """Run ``python -m module *argv`` as ``nproc`` ranks of one job on
    this host (``cuda:0..nproc-1``, or gloo ranks on the CPU) and wait.
    Rank 0 keeps this process's standard output; SIGTERM and SIGINT are
    passed on to every rank (the quiesce contract). When a rank exits
    with an error, the others are stopped and its code is returned. As
    ``torchrun`` does, a rank gets ``OMP_NUM_THREADS=1`` unless the
    caller set it: N ranks of the host's core count each would
    oversubscribe it N times."""
    port = free_port()
    procs = []
    for rank in range(nproc):
        env = {"OMP_NUM_THREADS": "1", **os.environ,
               "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "WORLD_SIZE": str(nproc),
               "RANK": str(rank), "LOCAL_RANK": str(rank if device ==
                                                    "cuda" else 0)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv], env=env,
            stdout=None if rank == 0 else subprocess.DEVNULL))

    def forward(signum, _frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    old = {s: signal.signal(s, forward) for s in (signal.SIGTERM,
                                                  signal.SIGINT)}
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
                for p in procs:
                    try:
                        p.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        p.kill()
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.1)
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def without_flag(argv: list[str], flag: str) -> list[str]:
    """``argv`` without ``flag`` and its value (either spelling): the
    workers' command line, once the launcher has read ``flag``."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == flag:
            skip = True
        elif not a.startswith(flag + "="):
            out.append(a)
    return out


def workers_wanted(device: str, nproc_per_node: int) -> int:
    """Ranks one command starts on this host: none where a launcher
    already set ``RANK`` (this process is one of its workers); else
    ``--nproc-per-node`` on the CPU, and every visible GPU on ``cuda``."""
    if "RANK" in os.environ:
        return 1
    if device == "cpu":
        return max(1, nproc_per_node)
    import torch

    return max(1, torch.cuda.device_count())

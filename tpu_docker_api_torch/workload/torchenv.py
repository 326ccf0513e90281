"""Distributed bootstrap of the port's workloads (counterpart of
``tpu_docker_api/workload/jaxenv.py``).

JAX drives every chip of a host from one process and assembles the mesh
through ``jax.distributed.initialize`` (the ``JAX_*`` variables) and
libtpu (``TPU_*``, ``MEGASCALE_*``). The port keeps JAX's member model —
one container per host per slice, named ``<job>-p<pid>`` — and runs one
rank per granted GPU inside it, as ``torchrun`` does on a node. It reads
what ``torchrun`` and every other PyTorch launcher set:

- ``MASTER_ADDR`` / ``MASTER_PORT``: the rendezvous of rank 0 (process
  0's host, and the port JAX's coordinator held);
- ``WORLD_SIZE``: the job's ranks, one a GPU;
- a member with one GPU: ``RANK`` (its process id) and ``LOCAL_RANK`` 0,
  the rank itself;
- a member with k > 1 GPUs: ``NODE_RANK`` (its process id) and
  ``LOCAL_WORLD_SIZE`` = k, no ``RANK``: :func:`launch_workers` starts k
  ranks, numbered ``NODE_RANK·k + i``, at the job's master.

:func:`render_distributed_env` emits them for one member of a
:class:`DistributedJob`; :func:`render_job_specs` renders the whole gang's
container specs (the counterpart of JAX's ``render_job_specs``). The
TPU-only ``TPU_*`` and ``MEGASCALE_*`` variables have no counterpart:
NCCL finds NVLink and the network itself, and a multislice job is one
larger world. JAX's per-member mesh port and its multislice port are still
claimed and published, so the schedulers' books equal JAX's, but no GPU
variable reads them. :func:`bootstrap_torch` reads the variables in the
workload.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import time

from tpu_docker_api_torch.runtime.spec import ContainerSpec
from tpu_docker_api_torch.scheduler.topology import HostTopology


@dataclasses.dataclass
class ProcessPlacement:
    """One member (= one container) of a distributed job."""
    process_id: int
    host: str                 # routable address of the host running it
    gpu_uuids: list[str] = dataclasses.field(default_factory=list)
    local_rank: int = 0       # a one-GPU member's GPU (cuda:local_rank)
    #: host-local NVML indices granted to the member (render_job_specs
    #: names them through the host's topology)
    chip_ids: list[int] = dataclasses.field(default_factory=list)
    #: the member's published port: JAX's libtpu mesh port, read by no
    #: GPU variable (NCCL picks its own)
    member_port: int = 0
    #: the member host's topology; None ⇒ the one passed to
    #: render_job_specs
    topology: HostTopology | None = None
    #: which slice the member belongs to in a multislice job
    slice_id: int = 0

    @property
    def n_gpus(self) -> int:
        return len(self.gpu_uuids or self.chip_ids)


@dataclasses.dataclass
class DistributedJob:
    """A placement of N members forming one torch.distributed job."""
    name: str
    placements: list[ProcessPlacement]
    master_port: int
    num_slices: int = 1
    #: JAX's megascale port, claimed on process 0's host for a multislice
    #: job and published there; read by no GPU variable
    multislice_port: int = 0

    @property
    def master_address(self) -> str:
        # process 0 hosts the rendezvous store; placements order is not
        # assumed
        return next(p.host for p in self.placements if p.process_id == 0)

    @property
    def world_size(self) -> int:
        return sum(p.n_gpus for p in self.placements)


def render_distributed_env(job: DistributedJob,
                           placement: ProcessPlacement) -> list[str]:
    """The ``KEY=value`` environment of one member of ``job``. Every member
    holds the same number of GPUs (the ranks are ``NODE_RANK·k + i``)."""
    k = placement.n_gpus
    if k < 1:
        raise ValueError(f"process {placement.process_id} of {job.name} "
                         "holds no GPU: a member runs one rank a GPU")
    if any(p.n_gpus != k for p in job.placements):
        raise ValueError(f"the members of {job.name} hold "
                         f"{sorted({p.n_gpus for p in job.placements})} "
                         "GPUs: every member must hold as many")
    env = [
        f"MASTER_ADDR={job.master_address}",
        f"MASTER_PORT={job.master_port}",
        f"WORLD_SIZE={job.world_size}",
    ]
    if k == 1:
        return env + [f"RANK={placement.process_id}",
                      f"LOCAL_RANK={placement.local_rank}"]
    return env + [f"NODE_RANK={placement.process_id}",
                  f"LOCAL_WORLD_SIZE={k}"]


def render_job_specs(
    job: DistributedJob,
    topology: HostTopology,
    image: str,
    cmd: list[str],
    base_env: list[str] | None = None,
) -> list[ContainerSpec]:
    """ContainerSpecs for every member of a distributed job — what the
    service layer submits to the runtime, one container per member.

    GPUs and ``CUDA_VISIBLE_DEVICES`` come from the renderer the container
    flows use (runtime.spec.render_gpu_attachment, by the names of the
    member host's topology). Ports are JAX's: every member publishes its
    member port; process 0 also publishes the master port, and the first
    member of slice 0 the multislice port of a multislice job.
    """
    from tpu_docker_api_torch.runtime.spec import (PortBinding,
                                                   render_gpu_attachment)

    slice0 = min((p for p in job.placements if p.slice_id == 0),
                 key=lambda p: p.process_id, default=None)
    specs = []
    for p in job.placements:
        spec = ContainerSpec(
            name=f"{job.name}-p{p.process_id}",
            image=image,
            cmd=list(cmd),
            env=list(base_env or []) + render_distributed_env(job, p),
            port_bindings=[PortBinding(p.member_port, p.member_port)],
        )
        if p.process_id == 0:
            spec.port_bindings.append(
                PortBinding(job.master_port, job.master_port))
        if job.num_slices > 1 and p is slice0:
            spec.port_bindings.append(
                PortBinding(job.multislice_port, job.multislice_port))
        render_gpu_attachment(spec, sorted(p.chip_ids),
                              p.topology or topology)
        specs.append(spec)
    return specs


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
    In a member the job service rendered (``NODE_RANK`` set), the ranks
    are ``NODE_RANK·nproc + i`` of the job's ``WORLD_SIZE`` and meet at its
    ``MASTER_ADDR:MASTER_PORT``; elsewhere they are the whole job and meet
    on a free local port.
    Rank 0 keeps this process's standard output; SIGTERM and SIGINT are
    passed on to every rank (the quiesce contract). When a rank exits
    with an error, the others are stopped and its code is returned. As
    ``torchrun`` does, a rank gets ``OMP_NUM_THREADS=1`` unless the
    caller set it: N ranks of the host's core count each would
    oversubscribe it N times."""
    if "NODE_RANK" in os.environ:
        addr, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
        world, first = (int(os.environ["WORLD_SIZE"]),
                        int(os.environ["NODE_RANK"]) * nproc)
    else:
        addr, port, world, first = "127.0.0.1", str(free_port()), nproc, 0
    procs = []
    for i in range(nproc):
        env = {"OMP_NUM_THREADS": "1", **os.environ,
               "MASTER_ADDR": addr, "MASTER_PORT": port,
               "WORLD_SIZE": str(world), "RANK": str(first + i),
               "LOCAL_RANK": str(i if device == "cuda" else 0)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv], env=env,
            stdout=None if first + i == 0 else subprocess.DEVNULL))

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
    already set ``RANK`` (this process is one of its workers); a rendered
    member's ``LOCAL_WORLD_SIZE``; else ``--nproc-per-node`` on the CPU,
    and every visible GPU on ``cuda``."""
    if "RANK" in os.environ:
        return 1
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if device == "cpu":
        return max(1, nproc_per_node)
    import torch

    return max(1, torch.cuda.device_count())

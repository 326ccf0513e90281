"""Device mesh of the port (counterpart of
``tpu_docker_api/parallel/mesh.py``).

JAX drives every chip of a host from one process and names a mesh over
them. The port runs one process per device (``torch.distributed``: NCCL
on ``cuda``, gloo on ``cpu``) and names a ``DeviceMesh`` over the ranks
with the JAX axes, outermost first: ``pp`` (stage-to-stage traffic),
``dp``/``fsdp`` (gradient all-reduce, parameter all-gather), ``ep``
(experts), then ``tp``/``sp`` innermost, where the latency-critical
collectives ride (ranks next to each other share a host and NVLink).

:class:`Mesh` wraps the ``DeviceMesh`` with what the sharded model code
asks of it: each axis's size, this rank's index on it and the process
group of its line through the mesh (None where the axis has size 1, so
a collective over a size-1 axis is never issued).
"""

from __future__ import annotations

import dataclasses
import math

AXES = ("pp", "dp", "fsdp", "ep", "tp", "sp")


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Axis sizes; -1 on dp means 'absorb remaining devices'."""
    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    def _sizes(self) -> tuple[int, ...]:
        """Sizes in AXES order."""
        return (self.pp, self.dp, self.fsdp, self.ep, self.tp, self.sp)

    def resolve(self, n_devices: int) -> tuple[int, ...]:
        for name, size in zip(("fsdp", "tp", "sp", "pp", "ep"),
                              (self.fsdp, self.tp, self.sp, self.pp, self.ep)):
            if size < 1:
                raise ValueError(f"axis {name} must be ≥1 (only dp may be -1)")
        known = [s for s in self._sizes() if s != -1]
        prod = math.prod(known)
        if self.dp == -1:
            if n_devices % prod:
                raise ValueError(
                    f"{n_devices} devices not divisible by "
                    f"pp*fsdp*ep*tp*sp={prod}"
                )
            dp = n_devices // prod
            return (self.pp, dp, self.fsdp, self.ep, self.tp, self.sp)
        if prod != n_devices:
            raise ValueError(
                f"mesh plan {self} needs {prod} devices, have {n_devices}"
            )
        return self._sizes()


class Mesh:
    """A ``DeviceMesh`` named :data:`AXES`, with per-axis sizes, this
    rank's coordinates and groups."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.device_type = device_mesh.device_type
        self.shape = dict(zip(AXES, device_mesh.mesh.shape))
        self.coords = dict(zip(AXES, device_mesh.get_coordinate()))
        self._groups = {ax: (device_mesh.get_group(ax)
                             if self.shape[ax] > 1 else None)
                        for ax in AXES}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        """The process group of ``axis`` through this rank, or None for a
        size-1 axis."""
        return self._groups[axis]

    def size_of(self, axes) -> int:
        """Ranks along ``axes`` (one name or a tuple of names)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes) -> int:
        """This rank's index along ``axes``, the first axis major (JAX's
        order for a tuple entry of a ``PartitionSpec``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"


def build_mesh(plan: MeshPlan | None = None, device_type: str | None = None
               ) -> Mesh:
    """A (pp, dp, fsdp, ep, tp, sp) mesh over every rank of the default
    process group (``init_device_mesh``). ``device_type`` defaults to
    ``cuda`` under NCCL and ``cpu`` otherwise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialized process group "
                           "(workload.torchenv.bootstrap_torch)")
    plan = plan or MeshPlan()
    shape = plan.resolve(dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(init_device_mesh(device_type, shape, mesh_dim_names=AXES))


def single_device_mesh(device_type: str | None = None) -> Mesh:
    """The all-ones mesh over a process group of one rank (the mesh path
    at world size 1, as ``chip_smoke.py`` drives it)."""
    import torch.distributed as dist

    if dist.get_world_size() != 1:
        raise ValueError(f"single_device_mesh needs a world of 1 rank, "
                         f"have {dist.get_world_size()}")
    return build_mesh(MeshPlan(dp=1), device_type)

"""GPU topology model.

The reference has no topology concept — its GPU scheduler is a flat
UUID→bit map (gpuscheduler/scheduler.go:27-32). The port's counterpart of
``tpu_docker_api/scheduler/topology.py`` keeps the JAX package's model (a
mesh of chips with coordinates, shape-aware allocation) and fills it with
NVIDIA parts: a chip is one whole GPU, and an HGX host joins its 8 GPUs
all to all through NVSwitch, so a host is a **line** of NVML indices,
``(i, 0, 0)``, and hosts tile along y. Each part knows its GPUs a host,
HBM, peak bf16 FLOP/s (the MFU denominator) and HBM bytes/s (the roofline
denominator of ``infer/servebench.py`` and ``chip_smoke.py``).

Accelerator-type strings follow the JAX convention, ``<part>-<N>`` with N
the GPU count (one core per GPU): ``"h100-8"``.
"""

from __future__ import annotations

import dataclasses
import itertools

from tpu_docker_api_torch import errors


@dataclasses.dataclass(frozen=True)
class Generation:
    name: str
    cores_per_chip: int            # 1: CUDA addresses a GPU whole
    host_mesh: tuple[int, int, int]  # GPUs per host as (x, y, z)
    hbm_bytes_per_chip: int
    peak_bf16_flops: float         # per GPU, dense
    torus_dims: int                # 2 ⇒ hosts tile along y
    hbm_bytes_per_s: float         # per GPU


_GB = 1024**3

#: ``torch.cuda.get_device_name`` / NVML product-name substrings →
#: generation key ("NVIDIA H100 80GB HBM3" → h100)
_KIND_PROBE = {"h100": ("h100",), "a100": ("a100",)}

GENERATIONS: dict[str, Generation] = {
    # H100 SXM5 80GB: NVIDIA H100 Tensor Core GPU data sheet (dense bf16
    # 989 TFLOP/s, HBM3 3.35 TB/s); HGX H100 8-GPU board
    "h100": Generation("h100", 1, (8, 1, 1), 80 * _GB, 989e12, 2, 3.35e12),
    # A100 SXM4 80GB: NVIDIA A100 Tensor Core GPU data sheet (dense bf16
    # 312 TFLOP/s, HBM2e 2.04 TB/s); HGX A100 8-GPU board
    "a100": Generation("a100", 1, (8, 1, 1), 80 * _GB, 312e12, 2, 2.04e12),
}


def generation_for_name(name: str) -> "Generation | None":
    """The Generation of a device or NVML product name, or None for a
    part this module does not know."""
    name = name.lower()
    for gen_key, gen in GENERATIONS.items():
        if any(p in name for p in _KIND_PROBE.get(gen_key, ())):
            return gen
    return None


def generation_for(device) -> "Generation | None":
    """The Generation a torch device belongs to (by
    ``torch.cuda.get_device_name``), or None off the card or for an
    unknown part — THE device probe (servebench and chip_smoke read the
    card's peaks off the result)."""
    import torch  # here: the control-plane daemon imports this module

    device = torch.device(device)
    if device.type != "cuda":
        return None
    return generation_for_name(torch.cuda.get_device_name(device))


def peak_bf16_flops_for(device) -> float | None:
    """Per-GPU peak bf16 FLOP/s for a torch device, or None if it is no
    known part."""
    gen = generation_for(device)
    return gen.peak_bf16_flops if gen else None


def parse_accelerator_type(acc_type: str) -> tuple[Generation, int]:
    """``"h100-8"`` → (Generation(h100), 8 GPUs).

    Raises ValueError on unknown generation (mapped to TopologyUnknown by
    callers).
    """
    try:
        gen_name, _, n = acc_type.partition("-")
        gen = GENERATIONS[gen_name]
        count = int(n)
    except (KeyError, ValueError) as e:
        raise ValueError(f"unknown accelerator type {acc_type!r}") from e
    chips = count // gen.cores_per_chip if gen.cores_per_chip > 1 else count
    return gen, max(chips, 1)


def default_mesh_shape(gen: Generation, n_chips: int) -> tuple[int, int, int]:
    """A plausible physical mesh for ``n_chips`` of ``gen``.

    Hosts tile along y then z: 16 GPUs of (8, 1, 1) hosts are (8, 2, 1).
    For odd counts, fall back to an n×1×1 line. Used when the telemetry
    sidecar cannot report real coordinates (CPU dev hosts, tests).
    """
    hx, hy, hz = gen.host_mesh
    per_host = hx * hy * hz
    if n_chips <= per_host:
        # sub-host: cut the host mesh along x then y
        for shape in _sub_shapes((hx, hy, hz)):
            if shape[0] * shape[1] * shape[2] == n_chips:
                return shape
        return (n_chips, 1, 1)
    if n_chips % per_host == 0:
        k = n_chips // per_host
        if gen.torus_dims == 3:
            return (hx, hy, hz * k)
        return (hx, hy * k, 1)
    return (n_chips, 1, 1)


def _sub_shapes(host: tuple[int, int, int]):
    hx, hy, hz = host
    shapes = set()
    for x, y, z in itertools.product(range(1, hx + 1), range(1, hy + 1), range(1, hz + 1)):
        shapes.add((x, y, z))
    # smallest-volume first, then most cubic
    return sorted(shapes, key=lambda s: (s[0] * s[1] * s[2], -min(s), s))


def parse_slice_shape(shape: str) -> tuple[int, int, int]:
    """``"2x2"`` → (2,2,1); ``"2x2x4"`` → (2,2,4)."""
    parts = [int(p) for p in shape.lower().split("x")]
    if not 1 <= len(parts) <= 3 or any(p < 1 for p in parts):
        raise ValueError(f"bad slice shape {shape!r}")
    while len(parts) < 3:
        parts.append(1)
    return (parts[0], parts[1], parts[2])


def fake_uuid(index: int) -> str:
    """A stable, well-formed GPU UUID for a synthesized topology."""
    return f"GPU-00000000-0000-0000-0000-{index:012d}"


@dataclasses.dataclass
class HostTopology:
    """The scheduler's world: a mesh of GPUs with ids, coordinates and
    the UUIDs the runtime attaches."""

    generation: Generation
    mesh_shape: tuple[int, int, int]
    # chip_id → (x, y, z); chip ids are NVML indices
    coords: dict[int, tuple[int, int, int]]
    # chip_id → "GPU-..." UUID
    uuids: dict[int, str] = dataclasses.field(default_factory=dict)

    @staticmethod
    def build(acc_type: str) -> "HostTopology":
        """Synthesize a topology from an accelerator-type string (the path
        used when no telemetry sidecar is configured), with fake UUIDs."""
        gen, n_chips = parse_accelerator_type(acc_type)
        shape = default_mesh_shape(gen, n_chips)
        coords: dict[int, tuple[int, int, int]] = {}
        cid = 0
        for z in range(shape[2]):
            for y in range(shape[1]):
                for x in range(shape[0]):
                    if cid >= n_chips:
                        break
                    coords[cid] = (x, y, z)
                    cid += 1
        return HostTopology(generation=gen, mesh_shape=shape, coords=coords,
                            uuids={c: fake_uuid(c) for c in coords})

    @staticmethod
    def from_chips(gen: Generation, chips: dict[int, tuple[int, int, int]],
                   uuids: dict[int, str] | None = None) -> "HostTopology":
        """Build from real sidecar-reported coordinates and UUIDs."""
        if not chips:
            return HostTopology(gen, (0, 0, 0), {})
        shape = tuple(max(c[d] for c in chips.values()) + 1 for d in range(3))
        return HostTopology(gen, shape, dict(chips),  # type: ignore[arg-type]
                            dict(uuids or {}))

    def uuids_for(self, chip_ids: list[int]) -> list[str]:
        """The UUIDs of ``chip_ids``, in their order. Raises
        TopologyUnknown for a GPU the topology has no UUID for (a host
        probed without NVML): its grant cannot be attached."""
        missing = [c for c in chip_ids if c not in self.uuids]
        if missing:
            raise errors.TopologyUnknown(f"no UUID for GPUs {missing}")
        return [self.uuids[c] for c in chip_ids]

    @property
    def n_chips(self) -> int:
        return len(self.coords)

    def chip_at(self, coord: tuple[int, int, int]) -> int | None:
        for cid, c in self.coords.items():
            if c == coord:
                return cid
        return None

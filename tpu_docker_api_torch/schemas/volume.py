"""Volume request DTOs (parity: reference ``internal/model/volume.go:7-35``).

The port's copy of ``tpu_docker_api/schemas/volume.py``.
"""

from __future__ import annotations

import dataclasses

#: allowed size units → bytes multiplier (model/volume.go VolumeSizeMap)
VOLUME_SIZE_UNITS: dict[str, int] = {
    "KB": 1024,
    "MB": 1024**2,
    "GB": 1024**3,
    "TB": 1024**4,
}


@dataclasses.dataclass
class VolumeCreate:
    """POST /volumes body (model/volume.go VolumeCreate)."""
    volume_name: str
    size: str = ""  # e.g. "10GB"; empty ⇒ unsized


@dataclasses.dataclass
class VolumeSize:
    """PATCH /volumes/{name}/size body (model/volume.go VolumeSize)."""
    size: str = ""


@dataclasses.dataclass
class VolumeDelete:
    """DELETE /volumes/{name} body."""
    del_etcd_info_and_version_record: bool = False


def parse_size(size: str) -> int:
    """``"10GB"`` → bytes. Raises ValueError on unknown unit or bad number.

    Parity: utils/file.go:21-45 ``ToBytes`` + the unit validation at
    api/volume.go:118-124.
    """
    s = size.strip().upper()
    for unit, mult in VOLUME_SIZE_UNITS.items():
        if s.endswith(unit):
            # multiply before int() so fractional sizes ("1.5GB") keep precision
            return int(float(s[: -len(unit)]) * mult)
    raise ValueError(f"size {size!r} must end with one of {list(VOLUME_SIZE_UNITS)}")


@dataclasses.dataclass
class VolumeRollback:
    """PATCH /volumes/{name}/rollback body (see ContainerRollback)."""
    version: int
    data_from: str = "latest"

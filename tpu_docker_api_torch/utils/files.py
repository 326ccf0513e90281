"""Filesystem helpers.

Parity: reference ``utils/file.go`` (``DirSize`` walk for the volume shrink
guard) plus the data-migration copy the reference shells out for
(``cp -rf -p old/* new/``, workQueue/copy.go:16,25-31).

The port's copy of ``tpu_docker_api/utils/files.py`` without ``to_bytes``,
which no caller of the port has (``schemas/volume.py`` ``parse_size`` is
the unit conversion).
"""

from __future__ import annotations

import os
import shutil
import subprocess


def dir_size(path: str) -> int:
    """Total bytes under ``path`` (reference DirSize, utils/file.go:10-19)."""
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            fp = os.path.join(root, f)
            try:
                total += os.lstat(fp).st_size
            except OSError:
                continue  # raced with deletion
    return total


def copy_dir_contents(src: str, dst: str) -> None:
    """Copy the *contents* of ``src`` into ``dst``, preserving metadata.

    The data-migration primitive behind rolling replacement (reference:
    ``cp -rf -p src/* dst/`` between overlay MergedDirs / volume Mountpoints,
    workQueue/copy.go:34-85). Uses ``cp -a`` when available (preserves
    hardlinks/sparseness, and on xfs/btrfs reflinks where supported), falling
    back to shutil.
    """
    os.makedirs(dst, exist_ok=True)
    if not os.path.isdir(src):
        raise FileNotFoundError(src)
    entries = os.listdir(src)
    if not entries:
        return
    cp = shutil.which("cp")
    if cp:
        subprocess.run(
            [cp, "-a", "--reflink=auto", *[os.path.join(src, e) for e in entries], dst],
            check=True,
            capture_output=True,
        )
    else:  # pragma: no cover — cp exists everywhere we run
        shutil.copytree(src, dst, dirs_exist_ok=True, symlinks=True)

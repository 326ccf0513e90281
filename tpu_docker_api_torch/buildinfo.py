"""Build identification — the reference's ldflags-injected vars.

Parity: ``cmd/gpu-docker-api/main.go:25-31`` + ``Makefile:15`` inject
``BRANCH/VERSION/COMMIT`` at link time. The Python analog: values come from
``TPU_DOCKER_API_{VERSION,BRANCH,COMMIT}`` env — the root Makefile's
``BUILDINFO_ENV`` renders them for packaged/imaged deployments (see the
``run`` target) — falling back to a best-effort git probe of the source
checkout, else "dev"/"unknown". Surfaced in the startup log line and
``/healthz``. The port's copy of ``tpu_docker_api/buildinfo.py``.
"""

from __future__ import annotations

import functools
import os
import pathlib
import subprocess


@functools.lru_cache(maxsize=1)
def build_info() -> dict[str, str]:
    def from_git(*args: str) -> str:
        try:
            out = subprocess.run(
                ["git", *args], capture_output=True, text=True, timeout=2.0,
                cwd=str(pathlib.Path(__file__).resolve().parent),
            )
            return out.stdout.strip() if out.returncode == 0 else ""
        except (OSError, subprocess.TimeoutExpired):
            return ""

    return {
        "version": os.environ.get("TPU_DOCKER_API_VERSION")
        or from_git("describe", "--tags", "--always") or "dev",
        "branch": os.environ.get("TPU_DOCKER_API_BRANCH")
        or from_git("rev-parse", "--abbrev-ref", "HEAD") or "unknown",
        "commit": os.environ.get("TPU_DOCKER_API_COMMIT")
        or from_git("rev-parse", "--short", "HEAD") or "unknown",
    }

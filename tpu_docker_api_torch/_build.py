"""Build and load the port's CUDA kernels and its host library.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
by ``nvcc`` into a shared library under ``build/kernels/`` at the root of
the checkout and loaded with ``ctypes``. The library's file name carries
a hash of its source, so an edited source builds anew and a stale
library is never loaded. Nothing is built at import time: the first
``load`` of a kernel builds it, and ``build_all`` builds every kernel
with one ``nvcc`` process per source, all started together.

The host library (``csrc/dataloader.cc``, the data loader's native batch
path) is built the same way by the host C++ compiler (``$CXX``, else
``g++``) into ``build/host/`` at its first ``load_host``. Every build
writes a name of its own and ``os.replace``s it into place, so processes
that race on a first build each finish with a whole library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

#: kernel name → source file under csrc/
KERNELS = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "adam8": "adam8.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_PTXAS_KEEP = ("Compiling entry", "registers", "arning", "(C75")

#: host library name → C++ source under csrc/
HOST_LIBS = {"tpudata": "dataloader.cc"}
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
#: the flags the JAX package's loader library is built with
CXX_FLAGS = ["-O2", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_host_lock = threading.Lock()  # a g++ build never waits on an nvcc one
_host_libs: dict[str, ctypes.CDLL] = {}
#: per kernel: {"seconds": nvcc wall time, "ptxas": [register/smem lines,
#: warnings, and ptxas's notes (C75xx) on wgmma it had to serialize]}
#: for the builds this process ran (empty for a library found on disk)
build_info: dict[str, dict] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source and of every
    header under csrc/ (which it may include)."""
    h = hashlib.sha256((_SRC_DIR / KERNELS[name]).read_bytes())
    for header in sorted(_SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path, float]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC_DIR / KERNELS[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def build_all(names: list[str] | None = None) -> dict[str, dict]:
    """Build every kernel not yet on disk, one nvcc per source, all in
    parallel. Returns ``build_info``. Raises with nvcc's output if a
    build fails."""
    names = list(KERNELS) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _lock:
        running = [(n, *_start(n)) for n in names
                   if not library_path(n).exists()]
        errors = []
        for name, proc, tmp, out, t0 in running:
            log, _ = proc.communicate()
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name} "
                              f"(exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, out)  # atomic: no reader sees a partial file
            build_info[name] = {
                "seconds": secs,
                "ptxas": [ln.strip() for ln in log.splitlines()
                          if any(key in ln for key in _PTXAS_KEEP)]}
        if errors:
            raise RuntimeError("\n".join(errors))
    return build_info


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if it is not on disk."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if not library_path(name).exists():
        build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


def host_library_path(name: str) -> Path:
    """The host library's path, named by a hash of its source."""
    h = hashlib.sha256((_SRC_DIR / HOST_LIBS[name]).read_bytes())
    return HOST_BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build_host(name: str, out: Path) -> None:
    cxx = os.environ.get("CXX") or "g++"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(_SRC_DIR / HOST_LIBS[name]), "-o", str(tmp),
           "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{cxx} could not run for {name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for {name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: no reader sees a partial file


def load_host(name: str) -> ctypes.CDLL:
    """The host library, built first if it is not on disk. Raises with
    the compiler's output if the build fails, and ``OSError`` if the
    library does not load."""
    with _host_lock:
        lib = _host_libs.get(name)
        if lib is None:
            path = host_library_path(name)
            if not path.exists():
                _build_host(name, path)
            lib = _host_libs[name] = ctypes.CDLL(str(path))
        return lib


def _sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library, by the toolkit beside
    nvcc."""
    tool = Path(nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True).stdout


def _count(sass: str, ops: tuple[str, ...]) -> dict[str, int]:
    return {op: len(re.findall(rf"\b{op}\.", sass)) for op in ops}


def sass_counts(name: str, ops: tuple[str, ...] = ("HGMMA", "HMMA")
                ) -> dict[str, int]:
    """How many of each tensor-core instruction (HGMMA: wgmma; HMMA:
    mma.sync) the built library's machine code holds."""
    return _count(_sass(name), ops)


def sass_counts_by_function(name: str,
                            ops: tuple[str, ...] = ("HGMMA", "HMMA")
                            ) -> dict[str, dict[str, int]]:
    """``sass_counts`` for each kernel of the library, by its (mangled)
    function name."""
    chunks = re.split(r"^\s*Function : ", _sass(name), flags=re.M)[1:]
    return {fn.strip(): _count(body, ops)
            for fn, _, body in (c.partition("\n") for c in chunks)}

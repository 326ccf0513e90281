"""Token-stream data layer (counterpart of
``tpu_docker_api/data/loader.py``).

- **Stateless step → batch.** A batch is a pure function of ``(seed,
  step)``: window indices come from an affine permutation of the window
  space, so a run resumed at step N reads exactly the batch the stopped
  run would have read at step N. No iterator state goes into a
  checkpoint.
- **Process-sharded rows.** Each process owns a contiguous row range of
  the global batch (``rows_for_process``).
- **Zero-copy reads.** Token files are memory-mapped; a batch gathers
  its windows without reading the corpus.
- **Waits counted.** ``wait_count`` sums the calls of every batch
  function, on both paths, and the host seconds spent in them.

File format: flat little-endian token ids, ``.bin`` (uint16 when the
vocab is below 65536, else int32) or ``.npy``. Several files concatenate
in sorted order into one stream, diced into non-overlapping
``seq + 1``-token windows (the trainer shifts inputs and targets off one
array). Batches are bit-identical to the JAX package's.

**Native batch path.** When every source is a ``.bin`` of ``uint16`` or
``int32``, the seed is not negative and ``TPU_DOCKER_API_NATIVE_DATA``
is not ``0``, ``make_batch_fn`` returns a ``_NativeBatcher``: the port's
own copy of the C++ loader (``csrc/dataloader.cc``: mmap and a tight
widen loop, and a worker that computes step+1 for the same rows while
the trainer runs step s), bit-identical to the numpy path. The library
is built from that source at first use (``_build.load_host``); nothing
from the default library search path is loaded. Where JAX quietly falls
back to numpy when its library is unbuilt, the port raises: a failed
build, load or ``tpudata_open`` is an error, never a slower path.
``int16`` (which shares ``uint16``'s width) and ``.npy`` sources stay on
numpy, as in JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import pathlib
import time
from typing import Callable, Sequence

import numpy as np

#: calls of every batch function this process made (both paths) and the
#: host seconds the callers waited in them
wait_count = {"batches": 0, "wait_s": 0.0}


def _waited(t0: float) -> None:
    wait_count["batches"] += 1
    wait_count["wait_s"] += time.perf_counter() - t0


def _coprime_stride(n: int, seed: int) -> int:
    """Deterministic multiplier coprime to n (an affine permutation of
    Z_n needs gcd(a, n) == 1); scans odd offsets from a seed-mixed start."""
    if n == 1:
        return 1
    a = (0x9E3779B1 * (seed + 1)) % n
    a = a | 1
    while np.gcd(int(a), int(n)) != 1:
        a = (a + 2) % n or 1
    return int(a)


@dataclasses.dataclass(frozen=True)
class TokenSource:
    """A logical token stream diced into fixed windows."""

    arrays: tuple[np.ndarray, ...]  # memory-mapped, 1-D
    window: int                     # tokens per window (seq + 1)
    #: set by open_token_files when every file is a plain .bin: the
    #: precondition of the native batch path (no npy header to skip)
    bin_paths: tuple[str, ...] | None = None
    bin_dtype: str = "uint16"

    def __post_init__(self):
        if self.window < 2:
            raise ValueError(f"window must be >= 2, got {self.window}")
        if not self.arrays or sum(a.size for a in self.arrays) < self.window:
            total = sum(a.size for a in self.arrays) if self.arrays else 0
            raise ValueError(
                f"need at least {self.window} tokens, have {total}")

    @property
    def n_tokens(self) -> int:
        return sum(a.size for a in self.arrays)

    @property
    def n_windows(self) -> int:
        return self.n_tokens // self.window

    def read_window(self, index: int) -> np.ndarray:
        """Window ``index`` (mod n_windows ⇒ infinite epochs) as int32."""
        index = int(index) % self.n_windows
        start = index * self.window
        out = np.empty(self.window, np.int32)
        filled = 0
        for arr in self.arrays:
            if start >= arr.size:
                start -= arr.size
                continue
            take = min(arr.size - start, self.window - filled)
            out[filled:filled + take] = arr[start:start + take]
            filled += take
            start = 0
            if filled == self.window:
                return out
        raise AssertionError("unreachable: n_windows bounds the index")


def open_token_files(
    paths: Sequence[str | pathlib.Path] | str | pathlib.Path,
    window: int,
    bin_dtype: str = "uint16",
) -> TokenSource:
    """Memory-map token files into a TokenSource. ``paths`` may be a single
    file, a directory (all ``*.bin``/``*.npy`` inside, sorted), or a list."""
    if isinstance(paths, (str, pathlib.Path)):
        p = pathlib.Path(paths)
        if p.is_dir():
            paths = sorted(
                q for q in p.iterdir() if q.suffix in (".bin", ".npy"))
        else:
            paths = [p]
    arrays = []
    all_bin: list[str] | None = []
    for p in map(pathlib.Path, paths):
        if p.suffix == ".npy":
            arr = np.load(p, mmap_mode="r")
            if arr.ndim != 1:
                raise ValueError(
                    f"{p}: token arrays must be 1-D, got {arr.shape}")
            all_bin = None
        elif p.suffix == ".bin":
            arr = np.memmap(p, dtype=np.dtype(bin_dtype), mode="r")
            if all_bin is not None:
                all_bin.append(str(p))
        else:
            raise ValueError(f"{p}: expected .bin or .npy")
        arrays.append(arr)
    return TokenSource(arrays=tuple(arrays), window=window,
                       bin_paths=tuple(all_bin) if all_bin else None,
                       bin_dtype=bin_dtype)


def rows_for_process(
    global_batch: int, process_index: int, process_count: int
) -> range:
    """The contiguous row range of the global batch a process owns."""
    if global_batch % process_count:
        raise ValueError(
            f"global batch {global_batch} must divide by process count "
            f"{process_count}")
    per = global_batch // process_count
    return range(process_index * per, (process_index + 1) * per)


def _native_lib() -> ctypes.CDLL:
    """The C++ loader library, built from ``csrc/dataloader.cc`` at first
    use (``_build.load_host`` keeps one a process) and bound; raises if
    it does not build, load or speak ABI 1."""
    from tpu_docker_api_torch import _build

    lib = _build.load_host("tpudata")
    lib.tpudata_abi_version.restype = ctypes.c_int32
    if lib.tpudata_abi_version() != 1:
        raise OSError(f"{_build.host_library_path('tpudata')}: ABI "
                      f"{lib.tpudata_abi_version()}, want 1")
    lib.tpudata_open.restype = ctypes.c_int64
    lib.tpudata_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.c_int32, ctypes.c_int64,
                                 ctypes.c_int32]
    for fn in (lib.tpudata_n_windows, lib.tpudata_n_tokens,
               lib.tpudata_hits):
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_int64]
    lib.tpudata_batch.restype = ctypes.c_int32
    lib.tpudata_batch.argtypes = [ctypes.c_int64] * 6 + [
        ctypes.POINTER(ctypes.c_int32)]
    lib.tpudata_close.argtypes = [ctypes.c_int64]
    return lib


class _NativeBatcher:
    """Owns one native source handle; ``__call__(step)`` fills this
    process's rows. The handle is closed on GC (the worker thread joins
    there), so the object must outlive the returned batch fn: it IS the
    batch fn."""

    def __init__(self, lib, paths: tuple[str, ...], window: int,
                 bin_dtype: str, global_batch: int, rows: range,
                 seed: int):
        self._lib = lib
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = lib.tpudata_open(arr, len(paths), window,
                                        np.dtype(bin_dtype).itemsize)
        if self._handle < 0:
            raise OSError(f"tpudata_open failed for {paths}")
        self._window = window
        self._global_batch = global_batch
        self._rows = rows
        self._seed = seed

    def __call__(self, step: int) -> np.ndarray:
        t0 = time.perf_counter()
        out = np.empty((len(self._rows), self._window), np.int32)
        rc = self._lib.tpudata_batch(
            self._handle, int(step), self._global_batch, self._rows.start,
            self._rows.stop, self._seed,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise RuntimeError(f"tpudata_batch failed rc={rc}")
        _waited(t0)
        return out

    @property
    def hits(self) -> int:
        """Calls served from the step+1 lookahead buffer so far."""
        return int(self._lib.tpudata_hits(self._handle))

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_handle", -1) >= 0:
            lib.tpudata_close(self._handle)
            self._handle = -1


def native_wanted(source: TokenSource, seed: int) -> bool:
    """JAX's conditions for the native path: every source a ``.bin`` of
    a dtype its widen loop knows (``int16`` shares ``uint16``'s width
    and would be widened sign-blind), a seed the C ABI takes, and the
    switch not off."""
    return (source.bin_paths is not None and seed >= 0
            and source.bin_dtype in ("uint16", "int32")
            and os.environ.get("TPU_DOCKER_API_NATIVE_DATA", "1") != "0")


def make_batch_fn(
    source: TokenSource,
    global_batch: int,
    *,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
) -> Callable[[int], np.ndarray]:
    """``fn(step) -> (local_batch, window) int32``, a pure function.

    Window selection for (step, row): position ``p = step·B + row`` in the
    visitation order, mapped through the affine permutation
    ``w = (a·p + b) mod n_windows``, a full-period shuffle that changes
    per epoch (b advances by the epoch index) while staying O(1) and
    stateless. Under ``native_wanted`` it is a ``_NativeBatcher``.
    """
    n = source.n_windows
    a = _coprime_stride(n, seed)
    rows = rows_for_process(global_batch, process_index, process_count)
    if native_wanted(source, seed):
        return _NativeBatcher(_native_lib(), source.bin_paths, source.window,
                              source.bin_dtype, global_batch, rows, seed)

    def batch_at(step: int) -> np.ndarray:
        t0 = time.perf_counter()
        out = np.empty((len(rows), source.window), np.int32)
        for i, row in enumerate(rows):
            p = step * global_batch + row
            epoch, pos = divmod(p, n)
            w = (a * pos + seed + epoch) % n
            out[i] = source.read_window(w)
        _waited(t0)
        return out

    return batch_at


def write_token_file(
    tokens: np.ndarray, path: str | pathlib.Path, bin_dtype: str = "uint16"
) -> pathlib.Path:
    """Write a 1-D token array in the loader's ``.bin`` format."""
    path = pathlib.Path(path)
    arr = np.asarray(tokens)
    if arr.ndim != 1:
        raise ValueError(f"tokens must be 1-D, got {arr.shape}")
    info = np.iinfo(np.dtype(bin_dtype))
    if arr.min() < info.min or arr.max() > info.max:
        raise ValueError(f"token ids do not fit {bin_dtype}")
    arr.astype(np.dtype(bin_dtype)).tofile(path)
    return path

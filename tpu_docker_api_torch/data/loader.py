"""Token-stream data layer (counterpart of
``tpu_docker_api/data/loader.py``, its numpy path).

- **Stateless step → batch.** A batch is a pure function of ``(seed,
  step)``: window indices come from an affine permutation of the window
  space, so a run resumed at step N reads exactly the batch the stopped
  run would have read at step N. No iterator state goes into a
  checkpoint.
- **Process-sharded rows.** Each process owns a contiguous row range of
  the global batch (``rows_for_process``).
- **Zero-copy reads.** Token files are memory-mapped; a batch gathers
  its windows without reading the corpus.

File format: flat little-endian token ids, ``.bin`` (uint16 when the
vocab is below 65536, else int32) or ``.npy``. Several files concatenate
in sorted order into one stream, diced into non-overlapping
``seq + 1``-token windows (the trainer shifts inputs and targets off one
array). Batches are bit-identical to the JAX package's. Its native C++
batch path (``tpu_native/dataloader.cc``) is not ported (ROADMAP
Queue 1); this is the numpy path it falls back to.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable, Sequence

import numpy as np


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
    for p in map(pathlib.Path, paths):
        if p.suffix == ".npy":
            arr = np.load(p, mmap_mode="r")
            if arr.ndim != 1:
                raise ValueError(
                    f"{p}: token arrays must be 1-D, got {arr.shape}")
        elif p.suffix == ".bin":
            arr = np.memmap(p, dtype=np.dtype(bin_dtype), mode="r")
        else:
            raise ValueError(f"{p}: expected .bin or .npy")
        arrays.append(arr)
    return TokenSource(arrays=tuple(arrays), window=window)


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
    stateless.
    """
    n = source.n_windows
    a = _coprime_stride(n, seed)
    rows = rows_for_process(global_batch, process_index, process_count)

    def batch_at(step: int) -> np.ndarray:
        out = np.empty((len(rows), source.window), np.int32)
        for i, row in enumerate(rows):
            p = step * global_batch + row
            epoch, pos = divmod(p, n)
            w = (a * pos + seed + epoch) % n
            out[i] = source.read_window(w)
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

"""Time the bf16 flash dq kernel with 64- and with 128-key kv tiles.

    python -m tpu_docker_api_torch.tune_dq_tile      # on a machine with a card

``csrc/flash_bwd.cu`` fixes the kv tile of ``flash_bwd_dq_kernel_tc`` as
the constant ``kDqKeys``. This script copies the sources once for each
tile size, with only that constant changed, under ``build/tune_dq/``,
builds each copy, holds each build's dq against the plain backward at
ragged and d=128 shapes, and times each at the training shape (R=4,
s=2048, 32/8 heads, d=64, causal, bf16) in turns (64, 128, 128, 64): CUDA
events around back-to-back calls while the card sleeps through the
host's enqueueing, so the reading is device time. One JSON line a tile
(its readings and ptxas's lines for the library), then the card's name
and power limit.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
from pathlib import Path

import torch

from tpu_docker_api_torch import _build
from tpu_docker_api_torch.ops import flash

TILES = (64, 128)
_CONSTANT = re.compile(r"constexpr int kDqKeys = \d+;")
_CSRC = _build._SRC_DIR
_ROOT = _build.BUILD_DIR.parent / "tune_dq"


def _variant(keys: int) -> Path:
    """A copy of csrc/ whose dq kernel takes ``keys`` keys a kv tile."""
    src = _ROOT / str(keys) / "csrc"
    src.mkdir(parents=True, exist_ok=True)
    for f in _CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, src / f.name)
    path = src / _build.KERNELS["flash_bwd"]
    text, n = _CONSTANT.subn(f"constexpr int kDqKeys = {keys};",
                             path.read_text())
    if n != 1:
        raise RuntimeError("kDqKeys not found once in flash_bwd.cu")
    path.write_text(text)
    return src


def _use(src: Path) -> None:
    """Load the dq kernel from the copy at ``src`` from now on."""
    _build._SRC_DIR, _build.BUILD_DIR = src, src.parent / "kernels"
    _build._libs.clear()
    flash._libs.clear()


def _inputs(gen, R, s, h, hk, d):
    def mk(n):  # the model's (R, s, heads, d) layout, as views
        return torch.randn(R, s, n, d, generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)

    q, k, v, do = mk(h), mk(hk), mk(hk), mk(h)
    out, lse = flash.flash_attention_fwd_plain(q, k, v, True)
    return q, k, v, out, lse.contiguous(), do


def _check(gen) -> float:
    """max |dq - plain| / max |plain dq| over three shapes (tolerance
    2e-2, as chip_smoke.py's)."""
    worst = 0.0
    for shape in ((2, 257, 8, 2, 64), (2, 255, 8, 8, 64),
                  (1, 300, 8, 2, 128)):
        q, k, v, out, lse, do = _inputs(gen, *shape)
        dq, _ = flash.flash_bwd_dq(q, k, v, out, lse, do)
        ref = flash.flash_attention_bwd_plain(q, k, v, out, lse, do)[0]
        rel = ((dq.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        if not rel <= 2e-2:
            raise AssertionError(f"dq disagrees with plain at {shape}: "
                                 f"{rel}")
        worst = max(worst, rel)
    return worst


def _device_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000 * iters)  # ~1 ms a call at H100 clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tune_dq_tile: needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for keys in TILES:
        src = _variant(keys)
        _use(src)
        info = _build.build_all(["flash_bwd"])["flash_bwd"]
        rows[keys] = {"kv_tile": keys, "ptxas": info["ptxas"],
                      "dq_rel_err": _check(gen), "ms": []}
    train = _inputs(gen, 4, 2048, 32, 8, 64)
    for keys in TILES + TILES[::-1]:
        _use(_ROOT / str(keys) / "csrc")
        rows[keys]["ms"].append(
            _device_ms(lambda: flash.flash_bwd_dq(*train)))
    for row in rows.values():
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

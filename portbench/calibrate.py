"""Calibration of a cell's limits: the program's readings on many seeds
and the control's and the planted faults' on some, in one process.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds 1,2,3 [--control-seeds 1,2,3]

Each seed is one run of the cell as ``run.py`` makes it (the timed path
at the cell's own load, a window of ``--seconds``) followed by its
check; on a control seed the check also reads the float8 control and,
for training, the reference fed half of each batch. One JSON line a
seed on standard output. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import runner, spec
    from portbench.run import _caches

    _caches()
    cell = spec.find_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        out = runner.run_cell(cell, seed, args.seconds, False,
                              torch.device("cuda", 0), t,
                              controls=seed in controls)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "checks": out["checks"],
                          "controls": out.get("controls"),
                          "metrics": out["metrics"],
                          "attempted": out["attempted"],
                          "memory_peak_bytes":
                              out["device"]["memory_peak_bytes"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

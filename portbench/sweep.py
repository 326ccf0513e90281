"""Find the highest rate an open-loop mix's system sustains: the mix at
each of a few fixed rates, one window each, in one process (the weights
drawn once). The mix need not be in a cell yet.

    python3 portbench/sweep.py --config <config> --traffic <mix> \\
        --seconds 51 --rates 1,1.25,1.5 --seed 1

``--config`` and ``--traffic`` take a name under ``portbench/`` or the
path of a ``.json`` file.

Give ``--seconds`` the benchmark's ``run_seconds``: a backlog that grows
slowly shows only over the window the cell will run. A rate is
sustained when every request it sent finished and the median TTFT of
the last quarter of arrivals is within ``--growth`` (20%) of the first
quarter's: no backlog that grows through the window. One JSON line a
rate, with both quarters' medians. The benchmark's runs never run this;
the cell's rate, about four fifths of the highest sustained, is written
into the mix file as a number.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def sustained(ttft_ms: list[float], failed: int, growth: float) -> dict:
    """The first and last quarter's median TTFT and whether the rate is
    sustained (nothing failed, the last within ``growth`` of the first)."""
    q = max(1, len(ttft_ms) // 4)
    first = statistics.median(ttft_ms[:q])
    last = statistics.median(ttft_ms[-q:])
    return {"ttft_first_quarter_ms": first, "ttft_last_quarter_ms": last,
            "sustained": failed == 0 and last <= (1.0 + growth) * first}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--growth", type=float, default=0.2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from portbench.harness import model as hm
    from portbench.harness import serve, spec
    from portbench.run import _caches

    _caches()
    def part(kind, name):
        if name.endswith(".json"):
            return spec.load_json(Path(name))
        return spec.load_part(kind, name)
    conf = part("configs", args.config)
    mix0 = part("traffic", args.traffic)
    device = torch.device("cuda", 0)
    cfg = hm.port_config(conf, remat=False)
    params = hm.make_params(cfg, args.seed, device)
    for rate in [float(r) for r in args.rates.split(",")]:
        mix = {**mix0, "rate_per_s": rate}
        t = time.perf_counter()
        rec = serve.window(cfg, conf, params, mix, args.seed, args.seconds,
                           False)
        s = serve.summarize(rec)
        print(json.dumps({
            "rate": rate, "attempted": s["attempted"], "failed": s["failed"],
            "ttft_p50_ms": float(np.percentile(s["ttft_ms"], 50)),
            "ttft_p95_ms": float(np.percentile(s["ttft_ms"], 95)),
            "tpot_p95_ms": float(np.percentile(s["tpot_ms"], 95)),
            **sustained(s["ttft_ms"], s["failed"], args.growth),
            "seconds": time.perf_counter() - t}), flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

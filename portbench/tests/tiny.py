"""Tiny cells for the CPU tests: the port's ``tiny`` and ``moe-tiny``
sizes under each driver kind, written as a benchmark of their own into
a directory (its ``BENCHMARK.json`` and its config, traffic and limits
files; the metric readers, drivers and families are the real ones)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.harness import spec

BASE = {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16,
        "max_position_embeddings": 512, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5, "sliding_window": None,
        "torch_dtype": "float32", "source": "tiny", "reduced": []}

CONFIGS = {
    "tiny": {**BASE, "family": "llama", "assumed": {}},
    "moe-tiny": {**BASE, "family": "moe", "num_local_experts": 4,
                 "num_experts_per_tok": 2,
                 "assumed": {"capacity_factor": 1.25}},
}

TRAFFIC = {
    "chat": {"kind": "closed_serve", "clients": 4, "requests_per_client": 4,
             "ramp_s": 0.2, "slots": 4, "max_seq": 96, "chunk": 4,
             "prompt": {"dist": "uniform", "lo": 8, "hi": 40},
             "output": {"dist": "uniform", "lo": 4, "hi": 12},
             "warm_rows": [1, 2], "trace_s": 0.5, "check_requests": 6},
    "rag": {"kind": "open_serve", "rate_per_s": 6.0, "slots": 4,
            "max_seq": 160, "chunk": 4,
            "prompt": {"dist": "loguniform", "lo": 16, "hi": 128},
            "output": {"dist": "uniform", "lo": 2, "hi": 8},
            "warm_rows": [1, 2], "trace_s": 0.5, "check_requests": 3,
            "grace_s": 60.0},
    "train": {"kind": "train", "batch": 2, "seq": 32,
              "corpus_tokens": 65536,
              "optimizer": {"name": "adamw_int8", "lr": 3e-4, "b1": 0.9,
                            "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
                            "clip_norm": 1.0},
              "check_steps": 3, "trace_steps": 1},
}

LIMITS = {"closed_serve": {"served_gap": 1e-3}, "open_serve":
          {"served_gap": 1e-3},
          "train": {"loss_gap": 1e-3, "grad_diff": 1e-2, "change_gap": 0.05}}

CELLS = [("moe-tiny.chat", "moe-tiny", "chat"), ("tiny.rag", "tiny", "rag"),
         ("tiny.train", "tiny", "train")]


def write(root: Path) -> Path:
    """A benchmark of the tiny cells under ``root``; returns its
    ``portbench`` directory."""
    pb = root / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "drivers", "families", "reference/families"):
        shutil.copytree(spec.PORTBENCH / sub, pb / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name, conf in CONFIGS.items():
        (pb / "configs" / f"{name}.json").write_text(json.dumps(conf))
    for name, mix in TRAFFIC.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    real = spec.load_json(spec.ROOT / "BENCHMARK.json")
    workloads = []
    for cell, conf, mix in CELLS:
        workloads.append({"name": cell, "config": conf, "traffic": mix,
                          "chips": 1, "why": "tiny"})
        (pb / "limits" / f"{cell}.json").write_text(
            json.dumps(LIMITS[TRAFFIC[mix]["kind"]]))
    kinds = {"chat": "moe-tiny.chat", "train": "tiny.train", "rag": "tiny.rag"}

    def retarget(metric):
        m = dict(metric)
        if "workloads" in m:
            m["workloads"] = [kinds[w.split(".")[-1].split("-")[0]]
                              for w in m["workloads"]]
        return m

    # the open loop's tails, which no cell of the real benchmark reports
    tails = [{"name": n, "unit": "ms", "better": "lower", "bound": 0.25,
              "source": "host_clock", "workloads": ["tiny.rag"]}
             for n in ("ttft_p95_ms", "tpot_p95_ms")]
    bench = {**real, "workloads": workloads,
             "end_to_end": [retarget(m) for m in real["end_to_end"]] + tails,
             "per_layer": [retarget(m) for m in real["per_layer"]]}
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return pb

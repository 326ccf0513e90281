"""A new configuration, traffic mix or metric is found by its name: the
files are added and the benchmark's entries extended, and no existing
file is edited."""

import json
import time

import torch

from portbench.harness import spec
from portbench.harness.runner import run_cell
from portbench.tests.tiny import CONFIGS, TRAFFIC


def test_new_config_mix_and_metric(tiny_bench):
    root, pb = tiny_bench
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    conf = {**CONFIGS["tiny"], "num_hidden_layers": 3}
    (pb / "configs" / "tiny3.json").write_text(json.dumps(conf))
    mix = {**TRAFFIC["chat"], "clients": 2, "slots": 2}
    (pb / "traffic" / "duo.json").write_text(json.dumps(mix))
    (pb / "metrics" / "requests_done.duo.py").write_text(
        "def read(run):\n    return run.serve['completed_in_window']\n")
    (pb / "limits" / "tiny3.duo.json").write_text(
        json.dumps({"served_gap": 1e-3}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny3.duo", "config": "tiny3",
                               "traffic": "duo", "chips": 1, "why": "new"})
    bench["end_to_end"][0]["workloads"].append("tiny3.duo")
    bench["per_layer"].append({
        "name": "requests_done.duo", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "slot engine", "moves": "out_tok_s",
        "workloads": ["tiny3.duo"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p: p.read_bytes() for p in before}
    assert after == before

    cell = spec.find_cell("tiny3.duo", root=root, portbench=pb)
    assert cell.config["num_hidden_layers"] == 3
    assert cell.traffic["clients"] == 2
    assert set(cell.per_layer) == {"requests_done.duo"}
    out = run_cell(cell, 5, 4.0, True, torch.device("cpu"),
                   time.perf_counter(), portbench=pb)
    assert out["correct"]
    assert out["metrics"]["requests_done.duo"]["unit"] == "requests"
    out = run_cell(cell, 5, 4.0, False, torch.device("cpu"),
                   time.perf_counter(), portbench=pb)
    assert set(out["metrics"]) == {"out_tok_s", "setup_s"}


def test_a_metric_without_workloads_follows_what_it_moves(tiny_bench):
    root, pb = tiny_bench
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "device_idle.chat", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "device", "moves": "train_tok_s"})
    bench["per_layer"] = [m for m in bench["per_layer"]
                          if m.get("workloads") != ["moe-tiny.chat"]
                          or m["name"] != "device_idle.chat"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    train = spec.find_cell("tiny.train", root=root, portbench=pb)
    chat = spec.find_cell("moe-tiny.chat", root=root, portbench=pb)
    assert "device_idle.chat" in train.per_layer
    assert "device_idle.chat" not in chat.per_layer


def test_new_driver_kind_and_model_family(tiny_bench):
    """A driver for a new traffic kind and a new model family (its port
    config and its reference block) are found by their names."""
    root, pb = tiny_bench
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    (pb / "drivers" / "replay_serve.py").write_text(
        "from portbench.harness.serve import drive as _drive\n\n\n"
        "def drive(run, controls=False):\n"
        "    run.mix = {**run.mix, 'kind': 'closed_serve'}\n"
        "    return _drive(run, controls)\n")
    (pb / "families" / "dense2.py").write_text(
        "ROWS_COUPLED = False\n\n\n"
        "def port_config(conf, common):\n"
        "    from tpu_docker_api_torch.models import LlamaConfig\n"
        "    return LlamaConfig(**common)\n")
    (pb / "reference" / "families" / "dense2.py").write_text(
        "def ffn(dec, x, w, capacity):\n"
        "    return dec.swiglu(x, w('layers/mlp/w_gate'), "
        "w('layers/mlp/w_up'), w('layers/mlp/w_down'))\n")
    (pb / "configs" / "dense2.json").write_text(
        json.dumps({**CONFIGS["tiny"], "family": "dense2"}))
    (pb / "traffic" / "replay.json").write_text(
        json.dumps({**TRAFFIC["chat"], "kind": "replay_serve"}))
    (pb / "limits" / "dense2.replay.json").write_text(
        json.dumps({"served_gap": 1e-3}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dense2.replay", "config": "dense2",
                               "traffic": "replay", "chips": 1,
                               "why": "new"})
    bench["end_to_end"][0]["workloads"].append("dense2.replay")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert {p: p.read_bytes() for p in before} == before

    cell = spec.find_cell("dense2.replay", root=root, portbench=pb)
    out = run_cell(cell, 7, 3.0, False, torch.device("cpu"),
                   time.perf_counter(), portbench=pb)
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"out_tok_s", "setup_s"}


def test_an_unknown_kind_names_the_missing_file(tiny_bench):
    import pytest

    root, pb = tiny_bench
    with pytest.raises(FileNotFoundError, match="drivers"):
        spec.load_module("drivers", "no_such_kind", pb)

"""Each driver kind runs a cell end to end at the tiny sizes on the CPU
(the harness's look for a card skipped) and gives a well-formed result;
the program's outputs there equal the reference's (float32 on both
sides)."""

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench.harness import spec
from portbench.harness.runner import run_cell
from portbench.tests.tiny import CELLS

SEED = 2**31 + 29


def run(tiny_bench, name, trace, **kw):
    root, pb = tiny_bench
    cell = spec.find_cell(name, root=root, portbench=pb)
    out = run_cell(cell, SEED, 4.0, trace, torch.device("cpu"),
                   time.perf_counter(), portbench=pb, **kw)
    return cell, json.loads(json.dumps(out))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", [c[0] for c in CELLS])
def test_cell_line(tiny_bench, name, trace):
    cell, out = run(tiny_bench, name, trace)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    want = cell.per_layer if trace else cell.end_to_end
    # every metric the cell reports is there but the device's shares,
    # which a CPU run has nothing to read for
    missing = set(want) - set(out["metrics"])
    assert all("roofline" in m for m in missing), missing
    for name_, m in out["metrics"].items():
        assert m["unit"] == want[name_]["unit"]
        assert isinstance(m["value"], float)
    if trace:
        assert "busy_s" in out["device"] and "window_s" in out["device"]
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert out["metrics"]["setup_s"]["value"] > 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_run_refuses_without_a_card(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(spec.PORTBENCH / "run.py"), "--workload",
         "mixtral-8x7b-l16.chat-closed128", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_run_refuses_without_the_program(tmp_path):
    """A checkout of only BENCHMARK.json and portbench/ has no program to
    measure: no result and a non-zero exit."""
    import shutil

    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mixtral-8x7b-l16.chat-closed128", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_every_cell_of_the_benchmark_is_found():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in cell.per_layer.values():
            assert m["moves"] in cell.end_to_end
            assert (spec.PORTBENCH / "metrics" / f"{m['name']}.py").exists()
        assert cell.limits


def test_the_sweep_refuses_a_growing_backlog():
    from portbench.sweep import sustained

    flat = [6000.0 + (i % 3) * 100 for i in range(40)]
    growing = [6000.0 + 60 * i for i in range(40)]
    assert sustained(flat, 0, 0.2)["sustained"]
    assert not sustained(growing, 0, 0.2)["sustained"]
    assert not sustained(flat, 1, 0.2)["sustained"]

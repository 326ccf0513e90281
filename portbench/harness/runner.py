"""One run of a cell: the driver of its mix's kind, then the metrics.

The driver (``drivers/<kind>.py``, found by the mix's ``kind``) makes
the weights and inputs from the seed, warms up, runs the window and the
check, and fills in what the metric readers read on ``run``."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from portbench.harness import check, spec
from portbench.harness import model as hm


def _device_info(device, chips: int, peak: int) -> dict:
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": kind, "count": chips, "memory_peak_bytes": int(peak)}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             devices, t_start: float, portbench=spec.PORTBENCH,
             controls: bool = False) -> dict:
    """The result line's object for one run of ``cell`` on ``devices``
    (one device or a list of the cell's ``chips``). ``controls``
    (calibration only) adds the readings of the control and of the
    planted faults under ``"controls"``."""
    if isinstance(devices, torch.device):
        devices = [devices]
    device = devices[0]
    for d in devices:
        if d.type == "cuda":
            torch.cuda.set_device(d)
            torch.zeros(1, device=d)        # the allocator exists
            torch.cuda.reset_peak_memory_stats(d)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    run = SimpleNamespace(cell=cell.name, conf=cell.config, mix=cell.traffic,
                          kind=cell.traffic["kind"], seed=seed,
                          seconds=seconds, traced=trace, device=device,
                          devices=devices, portbench=portbench,
                          t_start=t_start, trace=None)
    driver = spec.load_module("drivers", run.kind, portbench)
    got = driver.drive(run, controls)
    hm.free(device)
    ok, shown = check.judge(got["readings"], cell.limits)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for name, entry in wanted.items():
        value = spec.metric_reader(name, portbench)(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": entry["unit"]}
    device_info = _device_info(device, cell.chips, got["peak"])
    out = {"correct": bool(ok and got["failed"] == 0),
           "attempted": int(got["attempted"]), "failed": int(got["failed"]),
           "metrics": metrics, "device": device_info}
    if trace and run.trace:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    if controls:
        out["controls"] = {**got["extra"], "readings": got["readings"]}
    out["checks"] = shown
    return out

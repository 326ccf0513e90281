"""Telemetry of the port: the metrics registry and profile summary of the
model stack, and the control plane's GPU telemetry (the reference's
external ``detect-gpu`` NVML sidecar, README.md:194-195, consumed at
gpuscheduler/scheduler.go:142-158):

- ``nvml``: ctypes binding to the driver's ``libnvidia-ml.so.1``;
- ``probe``: local GPU discovery through it (or a ``/dev/nvidia*`` walk);
- ``sidecar``: the HTTP service exporting ``GET /api/v1/detect/gpu``;
- ``trace``: the control plane's span tracer.
"""

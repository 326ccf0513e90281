"""Share of the traced window with no operation on the device, in %."""

from portbench.harness import readers


def read(run):
    return readers.device_idle(run)

"""The flash forward, dq and dk/dv kernels of the train step against their roofline, in %."""

from portbench.harness import readers


def read(run):
    return readers.flash_train_roofline(run)

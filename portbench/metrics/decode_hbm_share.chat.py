"""Bytes the decode steps must read over the window at the HBM rate, in %."""

from portbench.harness import readers


def read(run):
    return readers.decode_hbm_share(run)

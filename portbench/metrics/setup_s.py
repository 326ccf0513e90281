"""Set-up seconds: process start to the window's start (weights, engine or train step, warm-up, kernel loads)."""

from portbench.harness import readers


def read(run):
    return readers.setup_s(run)

"""The whole train step's share of the card's bf16 peak, in %."""

from portbench.harness import readers


def read(run):
    return readers.step_mfu(run)

"""Model operations of the window's prefill and decode tokens as a share of the bf16 peak, in %."""

from portbench.harness import readers


def read(run):
    return readers.serve_mfu(run)

"""The adam8 kernel against its roofline (bytes), in %."""

from portbench.harness import readers


def read(run):
    return readers.adam8_roofline(run)

"""95th percentile over requests of (last token - first token) / (n - 1), in ms."""

from portbench.harness import readers


def read(run):
    return readers.tpot_ms(run, 95)

"""95th percentile of every request's time from due to its first token, in ms."""

from portbench.harness import readers


def read(run):
    return readers.ttft_ms(run, 95)

"""Host milliseconds a step waits for the loader's batch."""

from portbench.harness import readers


def read(run):
    return readers.batch_wait_ms(run)

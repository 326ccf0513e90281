"""Host milliseconds a call of the loader's batch function takes, over every batch the run drew."""

from portbench.harness import phases


def read(run):
    return phases.loader_wait_ms(run)

"""Device milliseconds launched inside the train step's optimizer range, a traced step."""

from portbench.harness import phases


def read(run):
    return phases.optimizer_ms(run)

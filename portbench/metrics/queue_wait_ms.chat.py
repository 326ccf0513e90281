"""Mean milliseconds from submit to a slot of the requests admitted in the window."""

from portbench.harness import phases


def read(run):
    return phases.queue_wait_ms(run)

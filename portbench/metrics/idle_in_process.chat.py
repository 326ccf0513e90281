"""Share of the traced window the device sat idle inside a chunk's hand-off to the streams (SlotEngine.process), in %."""

from portbench.harness import phases


def read(run):
    return phases.idle_in(run, phases.PROCESS)

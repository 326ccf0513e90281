"""Share of the traced window the device sat idle inside the decode chunk's dispatch (SlotEngine.decode_launch): the card waiting on launches, in %."""

from portbench.harness import phases


def read(run):
    return phases.idle_in(run, phases.LAUNCH)

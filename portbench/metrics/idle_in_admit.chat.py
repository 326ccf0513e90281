"""Share of the traced window the device sat idle inside the engine's admission range (SlotEngine.admit), in %."""

from portbench.harness import phases


def read(run):
    return phases.idle_in(run, phases.ADMIT)

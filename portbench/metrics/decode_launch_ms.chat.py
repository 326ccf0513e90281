"""Host milliseconds the engine spends dispatching one decode chunk: decode_launch_s over decode_chunks."""

from portbench.harness import phases


def read(run):
    return phases.decode_launch_ms(run)

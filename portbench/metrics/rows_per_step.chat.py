"""Decode rows a step serves: decode tokens delivered over decode steps run."""

from portbench.harness import readers


def read(run):
    return readers.rows_per_step(run)

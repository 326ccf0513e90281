"""Tokens of every step of the window over the window's seconds."""

from portbench.harness import readers


def read(run):
    return readers.train_tok_s(run)

"""Output tokens a second that reached the clients in the window."""

from portbench.harness import readers


def read(run):
    return readers.out_tok_s(run)

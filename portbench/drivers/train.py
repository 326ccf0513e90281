"""Training: the port's train step fed by its loader
(``harness/train.py``)."""

from portbench.harness.train import drive  # noqa: F401

"""Open-loop serving: requests sent at their due times, Poisson at the
mix's fixed rate, whatever the engine's state (``harness/serve.py``)."""

from portbench.harness.serve import drive  # noqa: F401

"""Closed-loop serving: each client sends its next request when its last
completes (``harness/serve.py``)."""

from portbench.harness.serve import drive  # noqa: F401

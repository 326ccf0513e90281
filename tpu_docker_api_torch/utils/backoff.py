"""Capped, jittered exponential backoff — the one schedule every retry
loop shares (work-queue task retries, health-watcher container restarts,
job-supervisor gang restarts).

The port's copy of ``tpu_docker_api/utils/backoff.py``.
"""

from __future__ import annotations

import random


def backoff_delay_s(
    attempt: int,
    base_s: float,
    max_s: float,
    jitter: float = 0.0,
    rng: random.Random | None = None,
) -> float:
    """``min(max_s, base_s·2^attempt)``, then ±``jitter`` fraction drawn
    from ``rng`` (seedable — deterministic replays). ``attempt`` is
    0-based. The cap is applied BEFORE jitter, so even the clamped tail
    stays de-synchronized across daemons."""
    # cap the exponent too: 2**attempt overflows floats near 1024 attempts
    delay = min(max_s, base_s * (2 ** min(attempt, 63)))
    if jitter > 0:
        delay *= 1 + jitter * (2 * (rng or random).random() - 1)
    return delay

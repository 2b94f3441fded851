"""Exponential backoff with decorrelated jitter: the schedule half of the JAX
package's `common/retry.py`.

The device fault domains (common/devicehealth) space their half-open probes
with it, and the warmer its warm-pack retries. The JAX module's retry loop
(`RetryPolicy.call`, `RetryExhaustedError`) and its transport taxonomy
(`is_transient`) serve the write path's replica fan-out and come with
replicas and recovery (ROADMAP A5c).
"""

from __future__ import annotations

import random


class RetryPolicy:
    """Decorrelated-jitter backoff: sleep_n = min(cap, uniform(base, 3 * sleep_{n-1})).

    Jitter is load-bearing, not cosmetic — on a replica fan-out every peer
    retries at once, and synchronized retries re-create the spike that caused
    the first failure. `rng` is injectable so tests pin the schedule.
    """

    def __init__(self, base_s: float = 0.05, cap_s: float = 1.0,
                 rng: random.Random | None = None):
        self.base_s = base_s
        self.cap_s = cap_s
        self.rng = rng or random.Random()

    def next_backoff(self, prev_sleep_s: float | None) -> float:
        """One step of the decorrelated-jitter schedule. Always in
        [base_s, cap_s]; grows up to 3x the previous sleep."""
        prev = self.base_s if prev_sleep_s is None else prev_sleep_s
        return min(self.cap_s, self.rng.uniform(self.base_s,
                                                max(self.base_s, prev * 3.0)))

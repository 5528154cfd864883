"""Backoff, retry budget and circuit breaker.

A copy of ``karpenter_core_tpu/utils/retry.py`` for the tenant plane
(``service/tenant.py``): ``DeterministicRNG``, ``Backoff``, ``RetryBudget``
(with its exact ``next_token_s`` hint) and ``CircuitBreaker``, all timed
through an injected ``utils/clock.Clock``.  Left out with the metrics port
(ROADMAP 1.5): the ``BREAKER_STATE`` / ``BREAKER_TRANSITIONS`` /
``RETRY_BUDGET_EXHAUSTED`` metrics and the tracing event of a transition.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional

from karpenter_core_tpu_torch.utils.clock import Clock


class DeterministicRNG:
    """splitmix64-based uniform [0, 1) source: seeded, replayable, and free of
    the ``random`` module.  Thread-safe."""

    def __init__(self, seed: Optional[int] = None) -> None:
        if seed is None:
            seed = int.from_bytes(os.urandom(8), "little")
        self._state = seed & 0xFFFFFFFFFFFFFFFF
        self._lock = threading.Lock()

    def random(self) -> float:
        with self._lock:
            self._state = (self._state + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
            z = self._state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        z = z ^ (z >> 31)
        return (z >> 11) / float(1 << 53)


# jitter modes: NONE keeps the deterministic doubling; HALF is a (0.5 + u)
# multiplier in [0.5d, 1.5d); FULL is AWS-style full jitter, uniform in (0, d]
JITTER_NONE = "none"
JITTER_HALF = "half"
JITTER_FULL = "full"


class Backoff:
    """Exponential backoff: ``delay(n) = min(base * factor^min(n-1, max_exponent),
    cap)``, optionally jittered.  Stateful (``next()``/``reset()``) for loop
    call sites and stateless (``for_attempt(n)``) for tests pinning sequences."""

    def __init__(
        self,
        base_s: float,
        cap_s: float,
        *,
        factor: float = 2.0,
        max_exponent: int = 32,
        jitter: str = JITTER_NONE,
        rng: Optional[DeterministicRNG] = None,
    ) -> None:
        if jitter not in (JITTER_NONE, JITTER_HALF, JITTER_FULL):
            raise ValueError(f"unknown jitter mode {jitter!r}")
        self.base_s = base_s
        self.cap_s = cap_s
        self.factor = factor
        self.max_exponent = max_exponent
        self.jitter = jitter
        self.rng = rng or DeterministicRNG()
        self._failures = 0

    @property
    def failures(self) -> int:
        return self._failures

    def for_attempt(self, attempt: int) -> float:
        """Deterministic (pre-jitter) delay for 1-based ``attempt``."""
        if attempt < 1:
            return 0.0
        exponent = min(attempt - 1, self.max_exponent)
        return min(self.base_s * (self.factor ** exponent), self.cap_s)

    def next(self) -> float:
        """Record one more consecutive failure; return the delay to wait."""
        self._failures += 1
        delay = self.for_attempt(self._failures)
        if self.jitter == JITTER_HALF:
            delay *= 0.5 + self.rng.random()
        elif self.jitter == JITTER_FULL:
            delay *= self.rng.random() or 1e-9
        return delay

    def reset(self) -> None:
        self._failures = 0


class RetryBudget:
    """Token-bucket retry budget: at most ``budget`` retries per rolling
    ``window_s``.  A caller that burns the budget gets ``allow() == False``
    until tokens refill."""

    def __init__(
        self,
        clock: Clock,
        budget: int = 10,
        window_s: float = 60.0,
        name: str = "default",
    ) -> None:
        self.clock = clock
        self.budget = float(budget)
        self.refill_per_s = budget / window_s if window_s > 0 else float("inf")
        self.name = name
        self._tokens = float(budget)
        self._last = clock.now()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = self.clock.now()
        elapsed = max(0.0, now - self._last)
        self._last = now
        self._tokens = min(self.budget, self._tokens + elapsed * self.refill_per_s)

    def allow(self) -> bool:
        """Consume one retry token; False when the budget is exhausted."""
        with self._lock:
            self._refill()
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def remaining(self) -> float:
        with self._lock:
            self._refill()
            return self._tokens

    def reconfigure(self, budget: int, window_s: float) -> None:
        """Reshape the bucket in place (a tenant's weight changed).  The
        current fill carries over proportionally, and ``next_token_s()``
        hints stay exact because they read the same (budget, refill)
        fields."""
        with self._lock:
            self._refill()
            frac = self._tokens / self.budget if self.budget > 0 else 1.0
            self.budget = float(budget)
            self.refill_per_s = budget / window_s if window_s > 0 else float("inf")
            self._tokens = min(self.budget, frac * self.budget)

    def next_token_s(self) -> float:
        """Seconds until ``allow()`` would next succeed (0.0 = it would now):
        the retry-after hint a shed response carries."""
        with self._lock:
            self._refill()
            if self._tokens >= 1.0:
                return 0.0
            if self.refill_per_s <= 0:
                return float("inf")
            return (1.0 - self._tokens) / self.refill_per_s


# breaker states
CLOSED = "closed"
HALF_OPEN = "half-open"
OPEN = "open"


class CircuitBreaker:
    """closed → (``failure_threshold`` consecutive failures) → open →
    (``reset_timeout_s`` elapses) → half-open → one trial → closed on success,
    open again on failure.  ``allow()`` is the gate.  Thread-safe; all timing
    through the injected Clock."""

    def __init__(
        self,
        clock: Clock,
        *,
        failure_threshold: int = 2,
        reset_timeout_s: float = 30.0,
        name: str = "default",
        on_state_change: Optional[Callable[[str, str], None]] = None,
    ) -> None:
        self.clock = clock
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.name = name
        self.on_state_change = on_state_change
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._trial_inflight = False
        self._lock = threading.RLock()

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    @property
    def failure_count(self) -> int:
        with self._lock:
            return self._failures

    def _transition(self, state: str) -> None:
        if state == self._state:
            return
        old, self._state = self._state, state
        if self.on_state_change is not None:
            self.on_state_change(old, state)

    def _maybe_half_open(self) -> None:
        if (
            self._state == OPEN
            and self.clock.now() - self._opened_at >= self.reset_timeout_s
        ):
            self._transition(HALF_OPEN)
            self._trial_inflight = False

    def allow(self) -> bool:
        """True when the protected path may be tried: always while closed,
        never while open, and exactly once per half-open window."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._trial_inflight:
                self._trial_inflight = True
                return True
            return False

    def release_trial(self) -> None:
        """A granted half-open trial ended without exercising the protected
        backend: free the trial slot so a later caller can still probe."""
        with self._lock:
            self._trial_inflight = False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._trial_inflight = False
            self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == HALF_OPEN or self._failures >= self.failure_threshold:
                self._opened_at = self.clock.now()
                self._trial_inflight = False
                self._transition(OPEN)

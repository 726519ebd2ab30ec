"""Retry with exponential backoff + jitter, and deadline-bounded calls.

The policy follows the classic AWS/Google SRE shape: delay for attempt
k is ``min(max_delay, base * multiplier**k)`` stretched by a uniform
jitter factor in ``[1-jitter, 1+jitter]`` so a fleet of ranks retrying
the same dead coordinator does not stampede it in lockstep. A seeded
RNG makes the jittered schedule reproducible in tests.

``run_with_deadline`` turns an indefinitely-blocking call (a dist
barrier rendezvous, a native wait) into one that raises
``DeadlineExceeded`` after a timeout — the caller then attaches its
diagnosis (which ranks are missing, which ops are pending) instead of
hanging a pod forever. The blocked call keeps running on its daemon
thread; the contract is *diagnosability*, not cancellation — the same
trade the reference accepted by letting ps-lite's Van threads linger.
"""
from __future__ import annotations

import logging
import random
import threading
import time

from ..base import MXNetError

__all__ = ["RetryPolicy", "DeadlineExceeded", "run_with_deadline"]


class DeadlineExceeded(MXNetError):
    """A deadline-bounded call did not finish in time."""


class RetryPolicy:
    """Exponential backoff with jitter.

    Parameters
    ----------
    max_attempts : total tries including the first (>= 1).
    base_delay / multiplier / max_delay : backoff shape in seconds.
    jitter : fraction j; each delay is scaled by U[1-j, 1+j].
    deadline : optional wall-clock budget in seconds across ALL
        attempts; when the next sleep would cross it, the last error
        is re-raised instead (the deadline is never overshot by a
        sleep).
    retryable : exception classes worth retrying; anything else
        propagates immediately.
    on_retry : callback ``(attempt, delay, exc)`` before each sleep;
        defaults to a logging.warning so production retries are never
        silent.
    sleep / seed : injectable for tests (fake clock, fixed jitter).
    """

    def __init__(self, max_attempts=4, base_delay=0.05, multiplier=2.0,
                 max_delay=2.0, jitter=0.25, deadline=None,
                 retryable=(Exception,), on_retry=None, sleep=time.sleep,
                 seed=None):
        if max_attempts < 1:
            raise MXNetError("max_attempts must be >= 1, got %r"
                             % (max_attempts,))
        if not 0.0 <= jitter < 1.0:
            raise MXNetError("jitter must be in [0, 1), got %r" % (jitter,))
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.multiplier = float(multiplier)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.deadline = deadline
        self.retryable = tuple(retryable)
        self.on_retry = on_retry
        self._sleep = sleep
        self._rng = random.Random(seed)

    def backoff(self, attempt):
        """Jittered delay after the `attempt`-th failure (attempt >= 1).
        The pre-jitter envelope is monotone non-decreasing and capped
        at max_delay; jitter stretches each value independently."""
        raw = min(self.max_delay,
                  self.base_delay * (self.multiplier ** (attempt - 1)))
        if self.jitter:
            raw *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return raw

    def schedule(self):
        """The full jittered sleep schedule this policy would use
        (length max_attempts - 1). Consumes RNG state like a real run."""
        return [self.backoff(a) for a in range(1, self.max_attempts)]

    def call(self, fn, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` under this policy."""
        start = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except self.retryable as exc:
                if attempt >= self.max_attempts:
                    raise
                delay = self.backoff(attempt)
                if self.deadline is not None and \
                        time.monotonic() + delay - start > self.deadline:
                    raise
                # mxtel: every healed transient is an event operators
                # want counted (lazy import — telemetry must stay
                # import-independent of resilience)
                from .. import telemetry as _tel

                if _tel.ENABLED:
                    _tel.counter("retry.retries_total").inc()
                if self.on_retry is not None:
                    self.on_retry(attempt, delay, exc)
                else:
                    logging.warning(
                        "retry %d/%d after %s: %s (backing off %.3fs)",
                        attempt, self.max_attempts,
                        getattr(fn, "__name__", "call"), exc, delay)
                self._sleep(delay)

    def wrap(self, fn):
        """Decorator form of :meth:`call`."""
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped


def run_with_deadline(fn, timeout, what="operation"):
    """Run ``fn()`` on a daemon thread; return its result, re-raise its
    error, or raise DeadlineExceeded after `timeout` seconds. On
    timeout the thread is left running (Python cannot safely cancel a
    blocked native call) — callers use this to convert a hang into a
    diagnosable failure, and the process is expected to terminate soon
    after."""
    done = threading.Event()
    box = {}

    def _run():
        try:
            box["result"] = fn()
        except BaseException as exc:  # re-raised on the caller thread
            box["error"] = exc
        finally:
            done.set()

    t = threading.Thread(target=_run, daemon=True,
                         name="mxtpu-deadline-%s" % what)
    t.start()
    if not done.wait(timeout):
        raise DeadlineExceeded(
            "%s did not complete within %.1fs" % (what, timeout))
    if "error" in box:
        raise box["error"]
    return box.get("result")

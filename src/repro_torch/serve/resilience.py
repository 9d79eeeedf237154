"""Resilience primitives for the serve engines (torch counterpart of
``repro/serve/resilience.py``): terminal states, request validation, the
admission ``ShedPolicy`` and the ``WindowWatchdog``.  Host-side and free of
torch, so that the engines and the chaos plans (``serve/chaos.py``) share
them.

Every ``Request`` walks ``PENDING -> QUEUED -> RUNNING`` and ends in
exactly one of ``DONE / SHED / TIMED_OUT / FAILED``.  ``DONE`` is the only
state that sets ``Request.done``; the other three are served outcomes too
(a shed request was handled, not lost), so the drain loops and
``run_arrivals`` count any terminal request as finished work.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

PENDING = "PENDING"      # created, not yet submitted
QUEUED = "QUEUED"        # in an engine's admission queue
RUNNING = "RUNNING"      # admitted into a slot, decoding

DONE = "DONE"            # served to completion (the only state with done=True)
SHED = "SHED"            # rejected by admission control (backpressure/defers)
TIMED_OUT = "TIMED_OUT"  # deadline expired (queued or mid-decode)
FAILED = "FAILED"        # malformed request or retry budget exhausted

TERMINAL_STATES = frozenset({DONE, SHED, TIMED_OUT, FAILED})


@dataclasses.dataclass
class ShedPolicy:
    """Admission-control knobs for the serve engines.

    ``max_queue_depth`` sheds at submit once the queue holds that many
    requests; ``enforce_deadlines`` times out requests past their
    ``deadline`` while queued (before they admit) and mid-decode (the slot
    frees, the partial output stays); ``max_retries`` bounds the requeues
    of a request whose window output failed the health check;
    ``max_defers`` sheds a request the page pool could not take that many
    times (None: never).  The default is permissive: no backpressure and
    no defer cap, deadlines honoured where a request sets one.
    """
    max_queue_depth: Optional[int] = None
    enforce_deadlines: bool = True
    max_retries: int = 2
    max_defers: Optional[int] = None


def check_request(req, max_len: int) -> None:
    """Raise ValueError for a request no engine can serve."""
    if not req.prompt:
        raise ValueError(f"request {req.uid}: empty prompt")
    if len(req.prompt) > max_len:
        raise ValueError(
            f"request {req.uid}: prompt length {len(req.prompt)} exceeds "
            f"max_len {max_len}")
    if req.max_new_tokens < 1:
        raise ValueError(f"request {req.uid}: max_new_tokens must be >= 1")


class WatchdogError(RuntimeError):
    """Raised when every watchdog attempt failed and no fallback exists."""


@dataclasses.dataclass
class WindowWatchdog:
    """Bounded retry with backoff around one hazardous callable.

    ``call`` runs ``primary`` up to ``max_attempts`` times, sleeping
    ``backoff_s * backoff_factor**attempt`` between failures; when every
    attempt fails it runs ``fallback`` or raises ``WatchdogError`` chained
    to the last error.  With ``timeout_s`` set, each attempt runs on a
    daemon thread, and one that outlives the budget is abandoned and
    counted as a failure (the thread cannot be stopped; the caller stops
    waiting on it).  An ``Engine`` gives it only its launch gate, which
    runs before the window touches the device, so ``timeout_s`` there
    bounds the gate and never a hung window.
    """
    max_attempts: int = 3
    backoff_s: float = 0.01
    backoff_factor: float = 2.0
    timeout_s: Optional[float] = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_s < 0 or self.backoff_factor < 1.0:
            raise ValueError("backoff_s must be >= 0 and factor >= 1")

    def call(self, primary: Callable, fallback: Optional[Callable] = None,
             label: str = "", on_retry: Optional[Callable] = None):
        delay = self.backoff_s
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            try:
                return self._attempt(primary)
            except Exception as e:   # noqa: BLE001 - bounded, re-raised below
                last = e
                if on_retry is not None:
                    on_retry(attempt, e)
                if attempt + 1 < self.max_attempts and delay > 0:
                    time.sleep(delay)
                    delay *= self.backoff_factor
        if fallback is not None:
            return fallback()
        raise WatchdogError(
            f"{label or 'watchdog'}: all {self.max_attempts} attempts "
            f"failed ({last!r})") from last

    def _attempt(self, fn: Callable):
        if self.timeout_s is None:
            return fn()
        box: dict = {}

        def runner():
            try:
                box["value"] = fn()
            except BaseException as e:   # noqa: BLE001 - re-raised on caller
                box["error"] = e

        t = threading.Thread(target=runner, daemon=True)
        t.start()
        t.join(self.timeout_s)
        if t.is_alive():
            raise WatchdogError(
                f"attempt exceeded timeout {self.timeout_s}s "
                "(thread abandoned)")
        if "error" in box:
            raise box["error"]
        return box["value"]

"""Terminal states, request validation and the page-pool shed policy for
the serve engines (the part of ``repro/serve/resilience.py`` that
``Engine`` and ``PagedEngine`` need; queue-depth backpressure, deadlines,
the watchdog, quarantine and chaos injection are not ported yet, and with
them the TIMED_OUT state).

Every ``Request`` walks ``PENDING -> QUEUED -> RUNNING`` and ends in
exactly one terminal state.  ``DONE`` is the only state that sets
``Request.done``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

PENDING = "PENDING"      # created, not yet submitted
QUEUED = "QUEUED"        # in an engine's admission queue
RUNNING = "RUNNING"      # admitted into a slot, decoding

DONE = "DONE"            # served to completion (the only state with done=True)
SHED = "SHED"            # rejected by admission control (page-pool defers)
FAILED = "FAILED"        # malformed request, or non-finite logits

TERMINAL_STATES = frozenset({DONE, SHED, FAILED})


@dataclasses.dataclass
class ShedPolicy:
    """Admission control of ``PagedEngine``: a request whose page
    reservation cannot be met steps aside, and is shed once it has been
    passed over more than ``max_defers`` times (None: never shed)."""
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

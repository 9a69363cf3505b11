"""End-to-end request deadlines (the port's copy of the JAX package's
``DeadlineExceeded``, ``parse_deadline`` and ``remaining_s`` from
``langstream_tpu/serving/handoff.py`` and ``_deadline_from_options`` from
``langstream_tpu/serving/engine.py``; that module loads JAX, so the port
keeps its own).

A deadline is an absolute epoch stamp in seconds: wall clock, not
monotonic, because the value must mean the same on every replica that
reads it. Malformed values degrade to "no deadline", never to a refusal.
"""

from __future__ import annotations

import time
from typing import Any


class DeadlineExceeded(Exception):
    """The request's end-to-end budget is spent. The engine refuses such a
    request before it queues: never a silent late completion."""

    def __init__(self, detail: str = "", overrun_s: float = 0.0):
        super().__init__(detail or "deadline exceeded")
        self.overrun_s = overrun_s


def parse_deadline(value: Any) -> float | None:
    """An epoch-seconds deadline out of a header/option value, or None.
    Malformed and non-positive values are None."""
    if value is None:
        return None
    try:
        deadline = float(value)
    except (TypeError, ValueError):
        return None
    return deadline if deadline > 0 else None


def remaining_s(deadline: float | None, now: float | None = None) -> float | None:
    """Seconds of budget left (None = no deadline), clamped to >= 0: clock
    skew can put a fresh deadline in this host's past, which reads as
    "expired now", never as a negative budget."""
    if deadline is None:
        return None
    return max(0.0, deadline - (time.time() if now is None else now))


def deadline_from_options(options: dict) -> float | None:
    """The request's absolute epoch deadline out of its options:
    ``deadline`` (epoch seconds, the forwarded ``langstream-deadline``
    header) wins over ``deadline-s`` (a budget relative to now; a
    non-positive one is expired on arrival). Malformed values are None."""
    deadline = parse_deadline(options.get("deadline"))
    if deadline is not None:
        return deadline
    rel = options.get("deadline-s")
    if rel is None:
        return None
    try:
        rel = float(rel)
    except (TypeError, ValueError):
        return None
    return time.time() + max(0.0, rel)

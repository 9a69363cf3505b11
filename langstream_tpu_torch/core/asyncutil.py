"""Small asyncio helpers shared across the agent and runtime layers.

The port's copy of ``langstream_tpu/core/asyncutil.py``; it imports only the port.
"""

from __future__ import annotations

import asyncio
import logging


def spawn_retained(
    coro, tasks: set, log: logging.Logger, error_msg: str,
    level: int = logging.ERROR,
) -> asyncio.Task:
    """Schedule ``coro`` and retain its task handle in ``tasks``.

    The event loop keeps only a weak reference to scheduled tasks, so a
    fire-and-forget ``ensure_future`` can be garbage-collected mid-flight
    and a failure in it vanishes silently. The handle stays in ``tasks``
    until the task finishes; a non-cancellation exception is logged as
    ``error_msg`` at ``level`` — pass ``logging.DEBUG`` when another
    done-callback already reports the failure somewhere structured (a
    sink, a future) and the log line is just an audit trail.
    """
    task = asyncio.ensure_future(coro)
    tasks.add(task)

    def _done(t) -> None:
        tasks.discard(t)
        if not t.cancelled() and t.exception() is not None:
            log.log(level, error_msg, exc_info=t.exception())

    task.add_done_callback(_done)
    return task

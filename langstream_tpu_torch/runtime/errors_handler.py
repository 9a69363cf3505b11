"""Record-level error policy: fail | skip | dead-letter, with retries.

Parity: ``StandardErrorsHandler`` + ``ErrorsSpec``
(``langstream-runtime-impl/.../agent/errors/StandardErrorsHandler.java``;
``langstream-api/.../model/ErrorsSpec.java:28-37``). Retrying a single record
is inherently out-of-order relative to the rest of the batch (documented so in
the reference, ``AgentRunner.java:884-895``); commit contiguity still holds
because offsets commit by prefix.

The port's copy of ``langstream_tpu/runtime/errors_handler.py``; it imports only the port.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from enum import Enum

from langstream_tpu_torch.api.application import ErrorsSpec
from langstream_tpu_torch.api.record import Record

log = logging.getLogger(__name__)


class FailureAction(Enum):
    RETRY = "retry"
    SKIP = "skip"
    DEAD_LETTER = "dead-letter"
    FAIL = "fail"


@dataclass
class StandardErrorsHandler:
    spec: ErrorsSpec = field(default_factory=ErrorsSpec)
    _attempts: dict[int, int] = field(default_factory=dict)

    def handle(self, record: Record, error: Exception) -> FailureAction:
        rid = id(record)
        attempts = self._attempts.get(rid, 0) + 1
        self._attempts[rid] = attempts
        log.warning(
            "record failed (attempt %d/%d): %s", attempts, self.spec.retries + 1, error
        )
        if attempts <= self.spec.retries:
            return FailureAction.RETRY
        self._attempts.pop(rid, None)
        return self._final_action()

    def clear(self, record: Record) -> None:
        """Forget attempt state once a record reaches a terminal state —
        required because ``id()`` keys can be recycled by the allocator."""
        self._attempts.pop(id(record), None)

    def _final_action(self) -> FailureAction:
        if self.spec.on_failure == ErrorsSpec.SKIP:
            return FailureAction.SKIP
        if self.spec.on_failure == ErrorsSpec.DEAD_LETTER:
            return FailureAction.DEAD_LETTER
        return FailureAction.FAIL


def deadletter_record(record: Record, error: Exception) -> Record:
    """Annotate the failed record for the dead-letter topic (parity: the
    reference attaches error cause headers)."""
    return record.with_headers(
        {
            "langstream-error-message": str(error),
            "langstream-error-class": type(error).__name__,
        }
    )

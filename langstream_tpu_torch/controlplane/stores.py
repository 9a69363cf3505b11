"""The stored form of an application (the port's copy of
``StoredApplication`` from ``langstream_tpu/controlplane/stores.py``).

Stored per application: the raw YAML files (so redeploys re-parse
faithfully), the serialized instance/secrets, and deployment status. The
application stores that keep these records come with the control plane's
REST server, their reader.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class StoredApplication:
    tenant: str
    name: str
    files: dict[str, str]                  # filename → YAML content
    instance: str | None = None
    secrets: str | None = None
    status: str = "CREATED"                # CREATED | DEPLOYING | DEPLOYED | ERROR | DELETING
    error: str | None = None
    created_at: float = field(default_factory=time.time)

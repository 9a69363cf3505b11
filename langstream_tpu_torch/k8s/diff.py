"""Spec diffing + tenant resource limits (the port's copy of
``langstream_tpu/k8s/diff.py``).

Parity: ``SpecDiffer`` (``langstream-k8s-deployer-core/.../util/
SpecDiffer.java`` — decides whether a spec change requires a pod restart) and
``ApplicationResourceLimitsChecker``
(``.../limits/ApplicationResourceLimitsChecker.java`` — per-tenant unit
quotas; a unit is ``parallelism × size``).
"""

from __future__ import annotations

from typing import Any


def specs_equal(a: Any, b: Any) -> bool:
    """Structural equality with None ≡ {} ≡ absent (the reference treats
    missing maps and empty maps as the same spec)."""
    if a is None:
        a = {}
    if b is None:
        b = {}
    if isinstance(a, dict) and isinstance(b, dict):
        keys = set(a) | set(b)
        return all(specs_equal(a.get(k), b.get(k)) for k in keys)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(specs_equal(x, y) for x, y in zip(a, b))
    return a == b


def diff_paths(a: Any, b: Any, prefix: str = "") -> list[str]:
    """Dotted paths where two specs differ (for update-validation messages)."""
    if a is None:
        a = {}
    if b is None:
        b = {}
    if isinstance(a, dict) and isinstance(b, dict):
        out: list[str] = []
        for k in sorted(set(a) | set(b)):
            out.extend(diff_paths(a.get(k), b.get(k), f"{prefix}{k}."))
        return out
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        out = []
        for i, (x, y) in enumerate(zip(a, b)):
            out.extend(diff_paths(x, y, f"{prefix}{i}."))
        return out
    return [] if a == b else [prefix.rstrip(".") or "<root>"]


def agent_needs_restart(old_spec: dict[str, Any], new_spec: dict[str, Any]) -> bool:
    """An Agent CR change restarts pods only when pod-visible fields change
    (config checksum, image, resources, disk) — status/metadata churn
    doesn't."""
    relevant = (
        "agentConfigSecretRefChecksum",
        "image",
        "resources",
        "disk",
        "agentConfigSecretRef",
    )
    return any(
        not specs_equal(old_spec.get(k), new_spec.get(k)) for k in relevant
    )


class ResourceLimitsChecker:
    """Per-tenant unit quota: Σ over agents of parallelism × size ≤ max."""

    def __init__(self, max_units: int | None):
        self.max_units = max_units

    @staticmethod
    def units(agents: list[dict[str, Any]]) -> int:
        total = 0
        for spec in agents:
            resources = spec.get("resources") or {}
            total += int(resources.get("parallelism", 1)) * int(
                resources.get("size", 1)
            )
        return total

    def check(
        self,
        existing_agents_by_app: dict[str, list[dict[str, Any]]],
        new_app_id: str,
        new_agents: list[dict[str, Any]],
    ) -> None:
        """Raises ValueError when deploying/updating ``new_app_id`` would
        push the tenant over its quota (the app's own previous usage is
        released first)."""
        if self.max_units is None:
            return
        used = sum(
            self.units(agents)
            for app_id, agents in existing_agents_by_app.items()
            if app_id != new_app_id
        )
        wanted = self.units(new_agents)
        if used + wanted > self.max_units:
            raise ValueError(
                f"tenant quota exceeded: {used} units in use, application "
                f"{new_app_id!r} needs {wanted}, limit {self.max_units}"
            )

"""``${secrets.x.y}`` / ``${globals.x}`` placeholder resolution.

Parity: ``ApplicationPlaceholderResolver``
(``langstream-core/.../common/ApplicationPlaceholderResolver.java:59``) —
resolves placeholders across the whole application model after parsing, from
the secrets file and instance globals. Unresolvable placeholders raise, except
inside agent ``configuration`` blocks where unknown roots are left verbatim
(they may be runtime expressions).

The port's copy of ``langstream_tpu/core/placeholders.py``; it imports only the port.
"""

from __future__ import annotations

import re
from typing import Any

from langstream_tpu_torch.api.application import Application

_PLACEHOLDER = re.compile(r"\$\{\s*([a-zA-Z0-9_.-]+)\s*\}")


class PlaceholderError(ValueError):
    pass


def _build_context(application: Application) -> dict[str, Any]:
    secrets: dict[str, Any] = {}
    for sid, secret in application.secrets.secrets.items():
        secrets[sid] = secret.data
    return {
        "secrets": secrets,
        "globals": application.instance.globals_,
        "cluster": {
            "streaming": {
                "type": application.instance.streaming_cluster.type,
                **application.instance.streaming_cluster.configuration,
            },
            "compute": {
                "type": application.instance.compute_cluster.type,
            },
        },
    }


def _lookup(path: str, context: dict[str, Any]) -> Any:
    parts = path.split(".")
    cur: Any = context
    for p in parts:
        if isinstance(cur, dict) and p in cur:
            cur = cur[p]
        else:
            raise PlaceholderError(f"cannot resolve placeholder ${{{path}}}")
    return cur


def resolve_value(value: Any, context: dict[str, Any], strict: bool = True) -> Any:
    if isinstance(value, str):
        full = _PLACEHOLDER.fullmatch(value.strip())
        if full:
            # whole-string placeholder: preserve the resolved type
            try:
                return resolve_value(_lookup(full.group(1), context), context, strict)
            except PlaceholderError:
                if strict and full.group(1).split(".")[0] in context:
                    raise
                return value

        def _sub(m: re.Match) -> str:
            try:
                v = _lookup(m.group(1), context)
                return "" if v is None else str(v)
            except PlaceholderError:
                if strict and m.group(1).split(".")[0] in context:
                    raise
                return m.group(0)

        return _PLACEHOLDER.sub(_sub, value)
    if isinstance(value, dict):
        return {k: resolve_value(v, context, strict) for k, v in value.items()}
    if isinstance(value, list):
        return [resolve_value(v, context, strict) for v in value]
    return value


def resolve_placeholders(application: Application) -> Application:
    """Resolve placeholders in-place across resources, agent configurations,
    gateways, and instance configuration. Returns the same application."""
    context = _build_context(application)

    # instance globals may themselves reference secrets
    application.instance.globals_ = resolve_value(
        application.instance.globals_, context
    )
    context = _build_context(application)

    application.instance.streaming_cluster.configuration = resolve_value(
        application.instance.streaming_cluster.configuration, context
    )
    for resource in application.resources.values():
        resource.configuration = resolve_value(resource.configuration, context)
    for module in application.modules.values():
        for asset in module.assets:
            asset.config = resolve_value(asset.config, context)
        for pipeline in module.pipelines.values():
            for agent in pipeline.agents:
                agent.configuration = resolve_value(agent.configuration, context)
    for gateway in application.gateways:
        if gateway.authentication:
            gateway.authentication = resolve_value(gateway.authentication, context)
        for hm in gateway.produce_headers + gateway.consume_filters:
            if isinstance(hm.literal_value, str):
                hm.literal_value = resolve_value(hm.literal_value, context)
    return application

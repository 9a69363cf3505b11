"""The port's gateway: the client-facing WebSocket/HTTP front door (a copy
of ``langstream_tpu/gateway``) on the port's stdlib HTTP/WebSocket server.

WS endpoints ``/v1/{consume,produce,chat}/{tenant}/{application}/{gateway}``
and HTTP produce (with its server-sent-events variant), header injection
from client parameters and from the authenticated principal, gateway
authentication (``auth.py``: ``test``, ``http``, ``jwt``, ``google``,
``github``), server-side consume filters, the QoS limiter and its 429s,
deadline and adapter headers, disconnect as cancellation, the replica
router, the service gateways (topic round trips and the agent proxy), and
client lifecycle events to an events topic.

The server is imported on first use of its names, so the stdlib client
(``gateway.wire``) and the providers load without the serving stack (the
CLI's admin commands import no ``torch``).
"""

from typing import Any

__all__ = ["GatewayRegistry", "GatewayServer"]


def __getattr__(name: str) -> Any:
    if name in __all__:
        from langstream_tpu_torch.gateway import server

        return getattr(server, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

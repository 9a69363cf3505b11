"""The port's gateway: the client-facing WebSocket/HTTP front door (a copy
of ``langstream_tpu/gateway``) on the port's stdlib HTTP/WebSocket server.

WS endpoints ``/v1/{consume,produce,chat}/{tenant}/{application}/{gateway}``
and HTTP produce (with its server-sent-events variant), header injection
from client parameters, server-side consume filters, the QoS limiter and
its 429s, deadline and adapter headers, disconnect as cancellation, the
replica router, and client lifecycle events to an events topic.
Authentication and the service gateways answer 501 until their slice.
"""

from langstream_tpu_torch.gateway.server import GatewayRegistry, GatewayServer

__all__ = ["GatewayRegistry", "GatewayServer"]

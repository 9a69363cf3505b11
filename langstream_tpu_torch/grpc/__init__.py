"""The external-agent gRPC protocol (the sidecar lane), without grpcio or
protobuf.

The port's copy of ``langstream_tpu/grpc``: user agent code runs in a
sidecar interpreter (or any process that implements ``agent.proto``)
behind the five RPCs of ``ExternalAgent``. The card's machine has neither
grpcio nor protobuf, so the lane carries its own stack, wire-compatible
with theirs in both directions:

- :mod:`.proto`: the 14 messages as plain classes with protobuf's encoding;
- :mod:`.hpack`: RFC 7541 header compression (the static and dynamic
  tables, Huffman decoding);
- :mod:`.h2`: HTTP/2 in prior-knowledge cleartext over asyncio streams, and
  the gRPC call layer on it (a server and a client channel);
- :mod:`.codec`, :mod:`.server`, :mod:`.client`: copies of the JAX
  modules over those.
"""

from langstream_tpu_torch.grpc.proto import load_messages

__all__ = ["load_messages"]

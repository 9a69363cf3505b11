"""The port's gateway with authentication and service gateways against the
JAX package's: one app deployed behind each gateway, one client script
(the port's stdlib client, ``gateway/wire.py``), the answers equal apart
from ids, offsets and times.

Covered: authenticated produce, consume, chat and HTTP produce (jwt and
test providers) refuse missing, badly signed and expired credentials with
the JAX status and reason, and fill ``value-from-authentication`` headers
from the principal, which also becomes the QoS identity; the service
gateway in topic mode makes a round trip through the port's
``document-to-json`` agent; the agent proxy forwards every method, the tail
path, the query and the body to a local upstream registered with
``register_service_uri``, strips hop-by-hop headers both ways, undoes a
gzip body, and answers a dead upstream 502; ``LocalComputeRuntime`` registers
``service-port`` agents as the JAX runtime does."""

import asyncio
import contextlib
import gzip
import itertools
import json
import socket
from pathlib import Path

import pytest
import yaml

from langstream_tpu.controlplane.server import LocalComputeRuntime as JaxCompute
from langstream_tpu.controlplane.stores import StoredApplication as JaxStored
from langstream_tpu.gateway.server import GatewayRegistry as JaxRegistry
from langstream_tpu.gateway.server import GatewayServer as JaxGateway
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.auth.jwt import encode_hs256
from langstream_tpu_torch.controlplane.server import LocalComputeRuntime
from langstream_tpu_torch.controlplane.stores import StoredApplication
from langstream_tpu_torch.gateway import wire
from langstream_tpu_torch.gateway.server import GatewayRegistry, GatewayServer
from langstream_tpu_torch.serving.engine import TorchServingEngine

REPO = Path(__file__).resolve().parents[1]
APPS = REPO / "examples" / "applications"
SECRETS = (REPO / "examples" / "secrets" / "secrets.yaml").read_text()
#: the jwt secret the repository's secrets file resolves for ``gateway``:
#: both packages keep the file's ``${VAR:-default}`` text as it is
JWT_SECRET = "${GATEWAY_JWT_SECRET:-change-me}"
_CLUSTERS = itertools.count()
TIMEOUT = 30.0

PIPELINE = """
topics:
  - name: "in"
    creation-mode: create-if-not-exists
  - name: "out"
    creation-mode: create-if-not-exists
pipeline:
  - name: "to-json"
    type: "document-to-json"
    input: "in"
    output: "out"
    configuration:
      text-field: "q"
"""

GATEWAYS = {"gateways": [
    {"id": "jwt-produce", "type": "produce", "topic": "in",
     "authentication": {"provider": "jwt", "configuration": {
         "secret": "${secrets.gateway.jwt-secret}"}},
     "produce-options": {"headers": [
         {"key": "user", "value-from-authentication": "sub"},
         {"value-from-authentication": "role"}]}},
    {"id": "jwt-consume", "type": "consume", "topic": "out",
     "authentication": {"provider": "jwt", "configuration": {
         "secret": "${secrets.gateway.jwt-secret}"}},
     "consume-options": {"filters": {"headers": [
         {"key": "user", "value-from-authentication": "sub"}]}}},
    {"id": "test-produce", "type": "produce", "topic": "in",
     "authentication": {"provider": "test", "configuration": {"require-credentials": True}},
     "produce-options": {"headers": [{"key": "user", "value-from-authentication": "subject"}]}},
    {"id": "raw-in", "type": "consume", "topic": "in"},
    {"id": "svc", "type": "service", "service-options": {
        "input-topic": "in", "output-topic": "out", "timeout-seconds": 10}},
    {"id": "svc-auth", "type": "service",
     "authentication": {"provider": "jwt", "configuration": {"secret": "x"}},
     "service-options": {"input-topic": "in", "output-topic": "out"}},
    {"id": "proxy", "type": "service", "service-options": {"agent-id": "my-service"}},
    {"id": "nowhere", "type": "service", "service-options": {}},
]}

QOS_CONFIGURATION = {"configuration": {"resources": [{
    "type": "tpu-serving-configuration", "name": "tpu",
    "configuration": {"model": "tiny", "qos": {"tenants": {"u-1": {"requests-per-s": 100}}}}}]}}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def files(configuration=None) -> dict:
    out = {"pipeline.yaml": PIPELINE, "gateways.yaml": yaml.safe_dump(GATEWAYS)}
    if configuration is not None:
        out["configuration.yaml"] = yaml.safe_dump(configuration)
    return out


def _instance() -> str:
    return yaml.safe_dump({"instance": {
        "streamingCluster": {"type": "memory",
                             "configuration": {"cluster": f"ga-{next(_CLUSTERS)}"}},
        "globals": {"chat-model": "tiny"}}})


@contextlib.asynccontextmanager
async def deployed(side, app_files, name="app"):
    """``app_files`` deployed as ``t1/<name>`` behind ``side``'s gateway;
    yields (the gateway's ``host:port``, its registry)."""
    if side == "jax":
        registry = JaxRegistry()
        compute = JaxCompute(gateway_registry=registry)
        gateway = JaxGateway(registry=registry, port=free_port())
        stored = JaxStored(tenant="t1", name=name, files=app_files, instance=_instance(),
                           secrets=SECRETS)
    else:
        registry = GatewayRegistry()
        compute = LocalComputeRuntime(gateway_registry=registry)
        gateway = GatewayServer(registry=registry, port=0)
        stored = StoredApplication(tenant="t1", name=name, files=app_files,
                                   instance=_instance(), secrets=SECRETS)
    await gateway.start()
    try:
        await compute.deploy(stored)
        yield f"127.0.0.1:{gateway.port}", registry
    finally:
        await gateway.stop()
        await compute.close()
        for cls in (TorchServingEngine, TpuServingEngine):
            engines = list(cls._instances.values())
            cls.reset_instances()
            for engine in engines:
                await engine.close()


VOLATILE = {"langstream-trace", "trace", "offset", "stream-id", "langstream-service-request-id"}


def norm(obj):
    if isinstance(obj, dict):
        return {k: ("<volatile>" if k in VOLATILE else norm(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [norm(v) for v in obj]
    return obj


async def ws_or_refusal(url):
    try:
        return await wire.WebSocketClient.connect(url)
    except wire.HandshakeError as e:
        return (e.status, e.reason, e.body.decode())


def run_both(app_files, script):
    out = {}
    for side in ("jax", "port"):
        async def main():
            async with deployed(side, app_files) as (base, registry):
                return await script(base, registry)

        out[side] = norm(asyncio.run(main()))
    return out


# ---------------------------------------------------------------------------
# authentication
# ---------------------------------------------------------------------------

GOOD = encode_hs256({"sub": "u-1", "role": "admin"}, JWT_SECRET)
OTHER = encode_hs256({"sub": "u-2"}, JWT_SECRET)
BAD_SIGNATURE = encode_hs256({"sub": "u-1"}, "not-the-secret")
EXPIRED = encode_hs256({"sub": "u-1", "exp": 1000}, JWT_SECRET)
CREDENTIALS = {"none": None, "bad-signature": BAD_SIGNATURE, "expired": EXPIRED,
               "malformed": "abc", "good": GOOD}


def _q(credentials):
    return f"?credentials={credentials}" if credentials else ""


async def refusals(base, registry):
    out = {}
    for label, cred in CREDENTIALS.items():
        for route, gateway in (("produce", "jwt-produce"), ("consume", "jwt-consume"),
                               ("produce", "test-produce")):
            got = await ws_or_refusal(f"ws://{base}/v1/{route}/t1/app/{gateway}{_q(cred)}")
            if not isinstance(got, tuple):
                await got.close()
                got = "connected"
            out[f"{label} {route} {gateway}"] = got
        status, reason, _, body = await wire.http_request(
            "POST", f"http://{base}/api/gateways/produce/t1/app/jwt-produce{_q(cred)}",
            {"value": "hello"})
        out[f"{label} http-produce"] = (status, reason, json.loads(body) if status == 200
                                        else body.decode())
        status, reason, _, body = await wire.http_request(
            "POST", f"http://{base}/api/gateways/service/t1/app/svc-auth{_q(cred)}",
            {"value": "hi"})
        out[f"{label} service"] = (status, reason, body.decode() if status != 200 else "")
    return out


async def principal_headers(base, registry):
    """A good token's principal in the produced records' headers (and as
    the records' QoS identity), through the WebSocket and HTTP produce."""
    consumer = await wire.WebSocketClient.connect(
        f"ws://{base}/v1/consume/t1/app/raw-in?option:position=earliest")
    producer = await wire.WebSocketClient.connect(
        f"ws://{base}/v1/produce/t1/app/jwt-produce?credentials={GOOD}")
    await producer.send_json({"value": "one", "headers": {"client": "c"}})
    ack = await producer.receive_json(TIMEOUT)
    await producer.close()
    status, _, _, http_ack = await wire.http_request(
        "POST", f"http://{base}/api/gateways/produce/t1/app/jwt-produce?credentials={GOOD}",
        {"value": "two"})
    producer = await wire.WebSocketClient.connect(
        f"ws://{base}/v1/produce/t1/app/test-produce?credentials=alice")
    await producer.send_json({"value": "three"})
    await producer.receive_json(TIMEOUT)
    await producer.close()
    frames = [await consumer.receive_json(TIMEOUT) for _ in range(3)]
    await consumer.close()
    return ack, status, json.loads(http_ack), frames


async def consume_filter(base, registry):
    """``jwt-consume`` filters the answers on the principal's ``sub``: a
    consumer sees only records stamped with its own user."""
    consumers = {}
    for label, token in (("u-1", GOOD), ("u-2", OTHER)):
        consumers[label] = await wire.WebSocketClient.connect(
            f"ws://{base}/v1/consume/t1/app/jwt-consume?credentials={token}")
    for token, value in ((OTHER, "for two"), (GOOD, "for one")):
        producer = await wire.WebSocketClient.connect(
            f"ws://{base}/v1/produce/t1/app/jwt-produce?credentials={token}")
        await producer.send_json({"value": value})
        await producer.receive_json(TIMEOUT)
        await producer.close()
    seen = {label: (await ws.receive_json(TIMEOUT))["record"] for label, ws in consumers.items()}
    for ws in consumers.values():
        await ws.close()
    return seen


@pytest.mark.parametrize("script", ["refusals", "principal-headers", "consume-filter"])
def test_authenticated_gateways_answer_as_the_jax_gateway(script):
    fn = {"refusals": refusals, "principal-headers": principal_headers,
          "consume-filter": consume_filter}[script]
    out = run_both(files(), fn)
    assert out["port"] == out["jax"]
    port = out["port"]
    if script == "refusals":
        assert port["none produce jwt-produce"] == [401, "missing bearer token",
                                                     "401: missing bearer token"]
        assert port["bad-signature consume jwt-consume"][2] == (
            "401: signature verification failed")
        assert port["expired produce jwt-produce"][2] == "401: token expired"
        assert port["none produce test-produce"][2] == "401: credentials required"
        assert port["good produce jwt-produce"] == "connected"
        assert port["good http-produce"][0] == 200
        assert port["good service"][0] == 401  # svc-auth's own secret is "x"
    elif script == "principal-headers":
        headers = [f["record"]["headers"] for f in port[3]]
        assert headers[0]["user"] == "u-1" and headers[0]["langstream-client-role"] == "admin"
        assert headers[0]["client"] == "c" and headers[1]["user"] == "u-1"
        assert headers[2]["user"] == "alice"
    else:
        assert port["u-1"]["value"] == {"q": "for one"}
        assert port["u-2"]["value"] == {"q": "for two"}


def test_the_principal_is_the_qos_identity():
    """With a ``qos`` section the principal's subject is the stamped QoS
    tenant (a client cannot pick another tenant with ``param:tenant``)."""
    async def script(base, registry):
        consumer = await wire.WebSocketClient.connect(
            f"ws://{base}/v1/consume/t1/app/raw-in?option:position=earliest")
        producer = await wire.WebSocketClient.connect(
            f"ws://{base}/v1/produce/t1/app/jwt-produce?credentials={GOOD}&param:tenant=other")
        await producer.send_json({"value": "x"})
        await producer.receive_json(TIMEOUT)
        await producer.close()
        frame = await consumer.receive_json(TIMEOUT)
        await consumer.close()
        return frame["record"]["headers"]

    out = run_both(files(QOS_CONFIGURATION), script)
    assert out["port"] == out["jax"]
    assert out["port"]["langstream-qos-tenant"] == "u-1"


def test_the_chatbot_gateway_example_authenticates_its_chat():
    """The repository's ``chatbot-gateway`` example (the mock provider in
    place of its resource): ``authenticated-chat`` answers a good token
    with the token's ``sub`` on every answer record, and refuses no token,
    a bad signature and an expired token before the socket opens."""
    app_files = {
        "pipeline.yaml": (APPS / "chatbot-gateway" / "pipeline.yaml").read_text(),
        "gateways.yaml": (APPS / "chatbot-gateway" / "gateways.yaml").read_text(),
        "configuration.yaml": yaml.safe_dump({"configuration": {"resources": [{
            "type": "mock-serving-configuration", "name": "mock",
            "configuration": {"chunk-delay": 0.001}}]}})}

    async def script(base, registry):
        out = {}
        for label in ("none", "bad-signature", "expired"):
            out[label] = await ws_or_refusal(
                f"ws://{base}/v1/chat/t1/app/authenticated-chat{_q(CREDENTIALS[label])}")
        ws = await wire.WebSocketClient.connect(
            f"ws://{base}/v1/chat/t1/app/authenticated-chat?credentials={GOOD}")
        await ws.send_json({"value": "what is it?"})
        frames = [await ws.receive_json(TIMEOUT)]
        while not isinstance(frames[-1].get("record", {}).get("value"), dict):
            frames.append(await ws.receive_json(TIMEOUT))
        await ws.close()
        out["frames"] = frames
        return out

    out = run_both(app_files, script)
    assert out["port"] == out["jax"]
    frames = out["port"]["frames"]
    assert frames[0]["status"] == "OK"
    assert all(f["record"]["headers"]["langstream-client-user"] == "u-1" for f in frames[1:])
    assert out["port"]["none"][0] == out["port"]["expired"][0] == 401


# ---------------------------------------------------------------------------
# service gateways
# ---------------------------------------------------------------------------

def test_the_service_gateway_round_trips_through_the_agents():
    async def script(base, registry):
        out = []
        for path, payload in (("svc", {"value": "hello", "key": "k1", "headers": {"h": "v"}}),
                              ("svc/", {"value": "slash"}), ("svc", {"plain": "object"})):
            status, _, headers, body = await wire.http_request(
                "POST", f"http://{base}/api/gateways/service/t1/app/{path}", payload)
            out.append((status, json.loads(body), "langstream-trace" in headers))
        for path, payload in (("nowhere", {"value": 1}), ("raw-in", {"value": 1}),
                              ("nope", {"value": 1})):
            status, reason, _, body = await wire.http_request(
                "POST", f"http://{base}/api/gateways/service/t1/app/{path}", payload)
            out.append((status, reason, body.decode()))
        status, reason, _, _ = await wire.http_request(
            "POST", f"http://{base}/api/gateways/service/t1/app/svc", body=b"not json",
            headers={"Content-Type": "application/json"})
        out.append((status, reason))
        return out

    out = run_both(files(), script)
    assert out["port"] == out["jax"]
    first = out["port"][0]
    assert first[0] == 200 and first[2] is True
    assert first[1]["record"]["value"] == {"q": "hello"} and first[1]["record"]["key"] == "k1"
    assert first[1]["record"]["headers"]["h"] == "v"
    assert out["port"][1][1]["record"]["value"] == {"q": "slash"}
    assert [o[0] for o in out["port"][3:]] == [400, 400, 404, 400]


def _upstream(seen):
    """A local agent service: echoes what it got, with hop-by-hop headers of
    its own, a gzip body on ``/gz``, a chunked body on ``/chunked``."""
    async def handle(request):
        seen.append((request.method, request.path, request.query_string,
                     request.body.decode(),
                     sorted(k for k in request.headers if k.startswith("x-")),
                     sorted(k for k in ("connection", "keep-alive", "te", "upgrade",
                                        "proxy-authorization") if k in request.headers
                            and request.headers[k] != "close")))
        if request.path == "/gz":
            return wire.Response(200, gzip.compress(b'{"zipped": true}'),
                                 {"Content-Encoding": "gzip", "X-Agent": "gz"},
                                 content_type="application/json")
        return wire.json_response({"method": request.method, "tail": request.path,
                                   "query": request.query_string},
                                  status=201 if request.method == "POST" else 200,
                                  headers={"X-Agent": "yes", "Keep-Alive": "timeout=5",
                                           "Proxy-Authenticate": "Basic"})

    return wire.HttpServer([("*", "/{tail:.*}", handle)])


def test_the_agent_proxy_forwards_methods_tail_query_and_strips_hop_headers():
    async def script(base, registry):
        seen = []
        upstream = _upstream(seen)
        await upstream.start()
        try:
            registry.register_service_uri("t1", "app", "my-service",
                                          f"http://127.0.0.1:{upstream.port}/")
            out = []
            url = f"http://{base}/api/gateways/service/t1/app/proxy"
            for method, tail, body in (("GET", "", None), ("POST", "/v1/predict?x=1&y=two",
                                                          b'{"q": "hi"}'),
                                       ("PUT", "/a/b", b"put-body"), ("PATCH", "/p", b"{}"),
                                       ("DELETE", "/d?z=9", None), ("GET", "/gz", None)):
                status, _, headers, payload = await wire.http_request(
                    method, url + tail, body=body, headers={
                        "X-Client": "1", "Keep-Alive": "timeout=1", "TE": "trailers",
                        "Proxy-Authorization": "secret",
                        **({"Content-Type": "application/json"} if body else {})})
                out.append((status, json.loads(payload), headers.get("x-agent"),
                             sorted(k for k in ("keep-alive", "proxy-authenticate",
                                                "content-encoding", "transfer-encoding")
                                    if k in headers)))
            out.append(seen)
            registry.register_service_uri("t1", "app", "my-service", f"http://127.0.0.1:{free_port()}")
            status, reason, _, _ = await wire.http_request("GET", url + "/dead")
            out.append((status, reason.split(":")[0]))
            return out
        finally:
            await upstream.stop()

    out = run_both(files(), script)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port[1] == [201, {"method": "POST", "tail": "/v1/predict", "query": "x=1&y=two"},
                       "yes", []]
    assert port[5] == [200, {"zipped": True}, "gz", []]
    upstream_saw = port[6]
    assert [s[:4] for s in upstream_saw[:3]] == [
        ["GET", "/", "", ""], ["POST", "/v1/predict", "x=1&y=two", '{"q": "hi"}'],
        ["PUT", "/a/b", "", "put-body"]]
    assert all(s[4] == ["x-client"] and s[5] == [] for s in upstream_saw)
    assert port[7] == [502, "agent 'my-service' service unreachable"]


def test_service_port_agents_register_their_local_uri(monkeypatch):
    """``LocalComputeRuntime.deploy`` registers an agent that declares
    ``service-port`` at ``http://127.0.0.1:<port>`` (the JAX runtime's
    dev-mode proxy target). Another agent resolves in both packages to its
    in-cluster service name, ``http://<app>-<agent>.langstream-<tenant>.svc:
    <service-port or 8790>``; the port's proxy forwards to that name (here
    to a stand-in for the cluster's DNS that reaches no such host) and
    answers 502 naming the agent."""
    pipeline = PIPELINE.replace('      text-field: "q"\n',
                                '      text-field: "q"\n      service-port: 8123\n')
    app_files = {**files(), "pipeline.yaml": pipeline}

    async def script(base, registry):
        return (registry.service_uri("t1", "app", "to-json"),
                registry.service_uri("t1", "app", "other"))

    out = run_both(app_files, script)
    assert out["port"][0] == out["jax"][0] == "http://127.0.0.1:8123"
    assert out["port"][1] == out["jax"][1] == "http://app-other.langstream-t1.svc:8790"

    seen = []
    real = wire.http_request

    async def no_cluster_dns(method, url, *args, **kwargs):
        if ".svc:" in url:
            seen.append(url)
            raise wire.ConnectError(f"cannot connect to {url}")
        return await real(method, url, *args, **kwargs)

    monkeypatch.setattr(wire, "http_request", no_cluster_dns)

    async def unregistered():
        async with deployed("port", app_files) as (base, _):
            return await wire.http_request(
                "GET", f"http://{base}/api/gateways/service/t1/app/proxy/x")

    status, reason, _, _ = asyncio.run(unregistered())
    assert (status, reason.split(":")[0]) == (502, "agent 'my-service' service unreachable")
    assert seen == ["http://app-my-service.langstream-t1.svc:8790/x"]
"""The port's control plane (``langstream_tpu_torch/controlplane``, on its
stdlib HTTP server) against the JAX package's aiohttp control plane: both
started side by side, driven by one stdlib request script
(``gateway.wire.http_request``), and every answer's status and body equal
apart from timestamps.

Covered: tenants; deploy as JSON and as a multipart zip with instance and
secrets parts; 404, 409 and 400 refusals; list, get and agents; a PATCH
that merges files; a failed update that leaves the app running; delete;
``/code`` (zip members); the ``max-units`` quota; the admin JWT with
``?files=true``; archetypes from ``examples/archetypes``; ``/autoscaler``;
the engine-report routes with the mock provider and with the tiny engine;
and a ``FileSystemApplicationStore`` written by either package and read by
the other. A tenant or application name that would climb out of the
file-system store (``%2E%2E%2F`` in the path) is refused with 400 by the
port alone: the JAX package joins such names to its paths, so it is not
driven with them. The apps run the port's agents (``document-to-json``,
``ai-chat-completions``) where the JAX package's own tests use ``compute``.
"""

import asyncio
import contextlib
import io
import itertools
import json
import socket
import zipfile
from pathlib import Path

import pytest
import yaml

from langstream_tpu.auth.jwt import encode_hs256
from langstream_tpu.controlplane.server import ControlPlaneServer as JaxControlPlane
from langstream_tpu.controlplane.stores import (
    FileSystemApplicationStore as JaxFsStore,
    StoredApplication as JaxStored,
)
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.admin.client import multipart_body
from langstream_tpu_torch.controlplane.server import ControlPlaneServer
from langstream_tpu_torch.controlplane.stores import (
    FileSystemApplicationStore,
    InMemoryApplicationStore,
    StoredApplication,
    validate_filenames,
    validate_name,
)
from langstream_tpu_torch.gateway import wire
from langstream_tpu_torch.serving.engine import TorchServingEngine

REPO = Path(__file__).resolve().parents[1]
ARCHETYPES = str(REPO / "examples" / "archetypes")
_CLUSTERS = itertools.count()

PIPELINE = """
topics:
  - name: "input-topic"
    creation-mode: create-if-not-exists
  - name: "output-topic"
    creation-mode: create-if-not-exists
pipeline:
  - name: "to-json"
    type: "document-to-json"
    input: "input-topic"
    output: "output-topic"
    resources:
      parallelism: {par}
    configuration:
      text-field: "q"
"""

GATEWAYS = """
gateways:
  - id: "produce-input"
    type: produce
    topic: "input-topic"
    parameters: [sessionId]
"""

#: a pipeline whose agent reads a topic nobody declared: refused at planning
BAD_PIPELINE = """
pipeline:
  - name: "x"
    type: "document-to-json"
    input: "missing"
"""

CHAT_PIPELINE = """
topics:
  - name: "questions"
    creation-mode: create-if-not-exists
  - name: "answers"
    creation-mode: create-if-not-exists
pipeline:
  - name: "to-json"
    type: "document-to-json"
    input: "questions"
    configuration:
      text-field: "question"
  - name: "chat"
    type: "ai-chat-completions"
    output: "answers"
    configuration:
      model: "{model}"
      completion-field: "value.answer"
      max-tokens: 4
      messages:
        - role: user
          content: "{{{{ value.question }}}}"
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def instance() -> str:
    return yaml.safe_dump({"instance": {"streamingCluster": {
        "type": "memory", "configuration": {"cluster": f"cp-{next(_CLUSTERS)}"}}}})


def app_payload(par: int = 1, extra: dict | None = None) -> dict:
    files = {"pipeline.yaml": PIPELINE.format(par=par), "gateways.yaml": GATEWAYS,
             **(extra or {})}
    return {"files": files, "instance": instance()}


def _scrub(value):
    """A body without its timestamps (``created-at``)."""
    if isinstance(value, dict):
        return {k: _scrub(v) for k, v in value.items() if k != "created-at"}
    if isinstance(value, list):
        return [_scrub(v) for v in value]
    return value


async def call(base: str, method: str, path: str, payload=None, body=None, headers=None):
    """``(status, body)``: JSON parsed and scrubbed, text as text, a zip as
    its sorted members and their contents."""
    status, _, resp_headers, raw = await wire.http_request(
        method, base + path, json_body=payload, body=body, headers=headers)
    ctype = resp_headers.get("content-type", "")
    if ctype.startswith("application/json"):
        return status, _scrub(json.loads(raw))
    if ctype.startswith("application/zip"):
        with zipfile.ZipFile(io.BytesIO(raw)) as zf:
            return status, {n: zf.read(n).decode() for n in sorted(zf.namelist())}
    return status, raw.decode()


@contextlib.asynccontextmanager
async def planes(**kwargs):
    """Both control planes, each on its in-memory store: yields
    ``{"jax": (server, base), "port": (server, base)}``."""
    jax = JaxControlPlane(port=free_port(), archetypes_path=ARCHETYPES, **kwargs)
    port = ControlPlaneServer(port=0, archetypes_path=ARCHETYPES, **kwargs)
    await jax.start()
    await port.start()
    try:
        yield {"jax": (jax, f"http://127.0.0.1:{jax.port}"),
               "port": (port, f"http://127.0.0.1:{port.port}")}
    finally:
        await port.stop()
        await jax.stop()
        for cls in (TorchServingEngine, TpuServingEngine):
            engines = list(cls._instances.values())
            cls.reset_instances()
            for engine in engines:
                await engine.close()


async def both(sides, steps):
    """Run ``steps`` (``(method, path, payload)`` or a callable of the base
    returning a coroutine) against each side in turn; the lists of answers."""
    out = {}
    for name, (_, base) in sides.items():
        answers = []
        for step in steps:
            if callable(step):
                answers.append(await step(base))
            else:
                answers.append(await call(base, *step))
        out[name] = answers
    return out


def assert_equal(out):
    for i, (j, p) in enumerate(zip(out["jax"], out["port"])):
        assert p == j, f"step {i}: port {p!r} != jax {j!r}"
    assert len(out["jax"]) == len(out["port"])


def multipart_deploy(path: str, files: dict, inst: str, secrets: str | None = None):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, content in files.items():
            zf.writestr(name, content)
        zf.writestr("nested/ignored.yaml", "x: 1\n")  # not top level: dropped
        zf.writestr("README.md", "dropped\n")
    fields = [("app", "app.zip", buf.getvalue(), "application/zip"),
              ("instance", None, inst.encode(), None)]
    if secrets is not None:
        fields.append(("secrets", None, secrets.encode(), None))
    body, ctype = multipart_body(fields)

    async def step(base):
        return await call(base, "POST", path, body=body, headers={"Content-Type": ctype})

    return step


def test_the_lifecycle_answers_equal():
    payload = app_payload()
    update = {"files": {"pipeline.yaml": PIPELINE.format(par=2)}}
    steps = [
        ("PUT", "/api/tenants/t1", None),
        ("GET", "/api/tenants", None),
        ("GET", "/api/tenants/t1", None),
        ("GET", "/api/tenants/nope", None),
        ("POST", "/api/applications/nope/app1", payload),  # unknown tenant
        ("POST", "/api/applications/t1/app1", payload),
        ("POST", "/api/applications/t1/app1", payload),  # 409
        ("POST", "/api/applications/t1/bad", {"files": {"p.yaml": BAD_PIPELINE},
                                              "instance": instance()}),
        ("POST", "/api/applications/t1/evil", {"files": {"../../evil.yaml": PIPELINE}}),
        ("POST", "/api/applications/t1/evil2", {"files": {"sub/dir.yaml": PIPELINE}}),
        ("POST", "/api/applications/t1/empty", {"files": {}}),
        multipart_deploy("/api/applications/t1/zipped",
                         {"pipeline.yaml": PIPELINE.format(par=1), "gateways.yaml": GATEWAYS},
                         instance(), "secrets: []\n"),
        ("GET", "/api/applications/t1", None),
        ("GET", "/api/applications/nope", None),
        ("GET", "/api/applications/t1/app1", None),
        ("GET", "/api/applications/t1/zipped", None),
        ("GET", "/api/applications/t1/app1/agents", None),
        ("PATCH", "/api/applications/t1/app1", update),  # merge: gateways.yaml stays
        ("GET", "/api/applications/t1/app1/agents", None),
        ("PATCH", "/api/applications/t1/app1", {"files": {"pipeline.yaml": BAD_PIPELINE}}),
        ("GET", "/api/applications/t1/app1", None),  # still DEPLOYED
        ("GET", "/api/applications/t1/app1/agents", None),  # still running
        ("PATCH", "/api/applications/t1/ghost", update),
        ("GET", "/api/applications/t1/app1/code", None),
        ("GET", "/api/applications/t1/zipped/code", None),
        ("GET", "/api/applications/t1/nope/code", None),
        ("GET", "/api/applications/t1/app1/autoscaler", None),
        ("GET", "/api/docs/agents/nope", None),
        ("DELETE", "/api/applications/t1/app1", None),
        ("GET", "/api/applications/t1/app1", None),
        ("GET", "/api/applications/t1", None),
        ("DELETE", "/api/tenants/t1", None),
        ("GET", "/api/tenants", None),
    ]

    async def main():
        async with planes() as sides:
            out = await both(sides, steps)
        assert_equal(out)
        statuses = [s for s, _ in out["port"]]
        assert statuses == [200, 200, 200, 404, 404, 200, 409, 400, 400, 400, 400, 200,
                            200, 404, 200, 200, 200, 200, 200, 400, 200, 200, 404, 200,
                            200, 404, 200, 404, 200, 404, 200, 200, 200]
        port = out["port"]
        assert port[5][1]["status"]["status"] == "DEPLOYED"
        assert port[11][1]["files"] == ["gateways.yaml", "pipeline.yaml"]
        assert port[17][1]["units"] == 2 and port[17][1]["files"] == [
            "gateways.yaml", "pipeline.yaml"]
        assert len(port[18][1]) == 2  # parallelism 2 after the merge
        assert port[19][1].startswith("400: invalid application:")
        assert port[23][1] == {"gateways.yaml": GATEWAYS,
                               "pipeline.yaml": PIPELINE.format(par=2)}

    asyncio.run(main())


def test_the_tenant_unit_quota_answers_equal():
    steps = [
        ("POST", "/api/applications/q/app1", app_payload(par=2)),
        ("POST", "/api/applications/q/app2", app_payload(par=2)),  # 2 + 2 > 3
        ("POST", "/api/applications/q/app3", app_payload(par=1)),
        ("PATCH", "/api/applications/q/app3", {"files": {"pipeline.yaml":
                                                         PIPELINE.format(par=2)}}),
        ("GET", "/api/applications/q", None),
    ]

    async def main():
        async with planes() as sides:
            for server, _ in sides.values():
                server.store.put_tenant("q", {"max-units": 3})
            out = await both(sides, steps)
        assert_equal(out)
        assert [s for s, _ in out["port"]] == [200, 409, 200, 409, 200]
        assert "tenant quota exceeded: 2 units in use, 2 requested, limit 3" in out["port"][1][1]

    asyncio.run(main())


def test_the_admin_jwt_and_the_full_view_answer_equal():
    good = {"Authorization": "Bearer " + encode_hs256({"sub": "admin"}, "admin-secret")}
    bad = {"Authorization": "Bearer " + encode_hs256({"sub": "admin"}, "other")}
    expired = {"Authorization": "Bearer " + encode_hs256({"exp": 1}, "admin-secret")}
    payload = {**app_payload(), "secrets": "secrets:\n  - id: s\n    data:\n      k: v\n"}

    def steps(headers_for_files):
        return [
            ("GET", "/api/tenants", None),
            ("GET", "/api/tenants", None, None, bad),
            ("GET", "/api/tenants", None, None, expired),
            ("GET", "/api/tenants", None, None, {"Authorization": "Bearer "}),
            ("PUT", "/api/tenants/t1", None, None, headers_for_files),
            ("POST", "/api/applications/t1/a", payload, None, headers_for_files),
            ("GET", "/api/applications/t1/a?files=true", None, None, headers_for_files),
            ("GET", "/api/applications/t1/a", None, None, headers_for_files),
        ]

    async def main():
        async with planes(admin_auth={"secret": "admin-secret"}) as sides:
            authed = await both(sides, steps(good))
        async with planes() as sides:
            open_ = await both(sides, steps(None))
        assert_equal(authed)
        assert_equal(open_)
        assert [s for s, _ in authed["port"]] == [401, 401, 401, 401, 200, 200, 200, 200]
        assert authed["port"][1][1] == "401: signature verification failed"
        assert authed["port"][2][1] == "401: token expired"
        assert authed["port"][0][1] == "401: missing bearer token"
        full = authed["port"][6][1]
        assert full["secrets"] == payload["secrets"] and full["instance"] == payload["instance"]
        assert "secrets" not in open_["port"][6][1]  # no admin auth: no secrets
        assert open_["port"][6][1]["files"]["gateways.yaml"] == GATEWAYS

    asyncio.run(main())


def test_archetypes_answer_equal(monkeypatch):
    from langstream_tpu_torch.agents import services

    monkeypatch.setattr(services, "SERVING_DEVICE", "cpu")
    inst = instance()
    steps = [
        ("GET", "/api/archetypes/t1", None),  # unknown tenant
        ("PUT", "/api/tenants/t1", None),
        ("GET", "/api/archetypes/t1", None),
        ("GET", "/api/archetypes/t1/chatbot", None),
        ("GET", "/api/archetypes/t1/nope", None),
        ("POST", "/api/archetypes/t1/chatbot/applications/c0", {"parameters": {}}),
        ("POST", "/api/archetypes/t1/chatbot/applications/c0",
         {"parameters": {"model": "tiny", "bogus": 1}}),
        ("POST", "/api/archetypes/t1/nope/applications/c0", {}),
        ("POST", "/api/archetypes/t1/chatbot/applications/c1",
         {"parameters": {"model": "tiny", "slots": 4}, "instance": inst}),
        ("POST", "/api/archetypes/t1/chatbot/applications/c1",
         {"parameters": {"model": "tiny"}, "instance": inst}),
        ("GET", "/api/applications/t1/c1?files=true", None),
        ("DELETE", "/api/applications/t1/c1", None),
    ]

    async def main():
        async with planes() as sides:
            out = await both(sides, steps)
        assert_equal(out)
        assert [s for s, _ in out["port"]] == [404, 200, 200, 200, 404, 400, 400, 404, 200,
                                              409, 200, 200]
        assert out["port"][2][1] == [{"id": "chatbot", "title": "TPU chatbot"}]
        assert "slots: 4" in out["port"][10][1]["files"]["configuration.yaml"]

    asyncio.run(main())


AUTOSCALE_CONFIGURATION = """
configuration:
  resources:
    - type: "tpu-serving-configuration"
      name: "tpu"
      configuration:
        model: "tiny"
        autoscale:
          {body}
"""


def test_the_autoscaler_route_and_its_validation_answer_equal():
    def with_autoscale(body: str) -> dict:
        return app_payload(extra={"configuration.yaml":
                                  AUTOSCALE_CONFIGURATION.format(body=body)})

    steps = [
        ("PUT", "/api/tenants/t1", None),
        ("POST", "/api/applications/t1/ok", with_autoscale("min-replicas: 1\n          "
                                                           "max-replicas: 3")),
        ("GET", "/api/applications/t1/ok/autoscaler", None),
        ("POST", "/api/applications/t1/bad", with_autoscale("min-replicas: 4\n          "
                                                            "max-replicas: 2")),
        ("POST", "/api/applications/t1/bad2", with_autoscale("bogus-key: 1")),
        ("GET", "/api/applications/t1/bad/autoscaler", None),
    ]

    async def main():
        async with planes() as sides:
            out = await both(sides, steps)
        assert_equal(out)
        assert [s for s, _ in out["port"]] == [200, 200, 200, 400, 400, 200]
        assert out["port"][2][1] == {"enabled": False}
        assert "autoscale" in out["port"][3][1]

    asyncio.run(main())


def _chat_app(model_resource: dict) -> dict:
    resource = {"configuration": {"resources": [model_resource]}}
    return {"files": {"pipeline.yaml": CHAT_PIPELINE.format(model=model_resource[
        "configuration"].get("model", "mock")), "configuration.yaml": yaml.safe_dump(resource)},
        "instance": instance()}


def _report_shape(value):
    """What both packages' engine reports share: for a list of engine
    dicts, each one's model and sorted keys; otherwise the value."""
    if isinstance(value, list):
        return [(e.get("model"), e.get("state"), sorted(e)) if isinstance(e, dict) else e
                for e in value]
    return value


@pytest.mark.parametrize("provider", ["mock", "tiny"])
def test_the_engine_report_routes_answer_alike(provider, monkeypatch):
    """With the mock provider every engine route answers empty in both
    packages. With the tiny engine (f32, the in-repo fixture's weights)
    each route carries the app's ``tiny`` engine in both, with the same
    top-level shape; ``/journey`` of an answered question stitches that
    engine's events, and ``/logs`` holds the deploy line."""
    from langstream_tpu_torch.agents import services

    monkeypatch.setattr(services, "SERVING_DEVICE", "cpu")
    if provider == "mock":
        resource = {"type": "mock-serving-configuration", "name": "mock", "configuration": {}}
    else:
        resource = {"type": "tpu-serving-configuration", "name": "tpu", "configuration": {
            "model": "tiny", "model-dtype": "float32", "slots": 2, "max-seq-len": 128,
            "checkpoint": str(REPO / "tests" / "fixtures" / "llama_tiny_golden"),
            "decode-chunk": 2,
            "slo": {"objectives": {"ttft": {"target": 0.9, "threshold-ms": 60000}}}}}
    payload = _chat_app(resource)
    routes = ["flight", "health", "qos", "slo", "attribution", "incidents", "traces"]

    async def main():
        async with planes() as sides:
            out, journeys, logs = {}, {}, {}
            for name, (server, base) in sides.items():
                await call(base, "PUT", "/api/tenants/t1")
                status, body = await call(base, "POST", "/api/applications/t1/chat", payload)
                assert status == 200 and body["status"]["status"] == "DEPLOYED", body
                runner = server.compute.runners[("t1", "chat")]
                trace = "ab" * 16
                await runner.produce("questions", json.dumps({"question": "hi"}), headers={
                    "langstream-trace": f"00-{trace}-{'cd' * 8}-01"})
                await runner.wait_for_messages("answers", 1, timeout=60)
                out[name] = {r: await call(base, "GET", f"/api/applications/t1/chat/{r}")
                             for r in routes}
                journeys[name] = await call(base, "GET", f"/api/applications/t1/chat/journey/{trace}")
                logs[name] = await call(base, "GET", "/api/applications/t1/chat/logs")
                out[name]["unknown-journey"] = await call(
                    base, "GET", "/api/applications/t1/chat/journey/nope")
                out[name]["other-app"] = await call(base, "GET", "/api/applications/t1/x/flight")
        for route in routes + ["unknown-journey", "other-app"]:
            js, jb = out["jax"][route]
            ps, pb = out["port"][route]
            assert ps == js == (404 if route == "unknown-journey" else 200), route
            if route in ("qos", "slo"):
                assert pb["configured"] == jb["configured"], route
                assert [e["model"] for e in pb["engines"]] == [e["model"] for e in jb["engines"]]
            elif route == "health":
                assert (pb["status"], len(pb["pods"])) == (jb["status"], len(jb["pods"]))
            elif route == "traces":
                assert len(pb) == len(jb), route
            elif route == "unknown-journey":
                assert pb == jb
            else:
                assert [e.get("model") for e in pb] == [e.get("model") for e in jb], route
        for name in ("jax", "port"):
            assert "application chat deployed" in logs[name][1]
        if provider == "mock":
            assert out["port"]["flight"][1] == [] and journeys["port"][0] == 404
            assert journeys["jax"][0] == 404
        else:
            assert [e["model"] for e in out["port"]["flight"][1]] == ["tiny"]
            assert out["port"]["health"][1]["pods"][0]["pod"] == "in-process"
            assert journeys["port"][0] == journeys["jax"][0] == 200
            kinds = {name: [e["kind"] for e in journeys[name][1]["events"]]
                     for name in journeys}
            assert kinds["port"][:2] == kinds["jax"][:2]
            assert {"submit", "finish"} <= set(kinds["port"])

    asyncio.run(main())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_file_system_store_written_by_either_package_loads_in_the_other(tmp_path, writer):
    stores = {"jax": (JaxFsStore, JaxStored), "port": (FileSystemApplicationStore,
                                                      StoredApplication)}
    reader = "port" if writer == "jax" else "jax"
    store_cls, stored_cls = stores[writer]
    store = store_cls(tmp_path)
    store.put_tenant("t1", {"max-units": 7})
    store.put_application(stored_cls(
        tenant="t1", name="a1", files={"pipeline.yaml": PIPELINE, "python/agent.py": "x = 1\n"},
        instance="instance: {}\n", secrets="secrets: []\n", status="DEPLOYED", units=3,
        created_at=12.5))
    loaded = stores[reader][0](tmp_path)
    assert loaded.list_tenants() == {"t1": {"max-units": 7}}
    assert loaded.list_applications("t1") == ["a1"]
    app = loaded.get_application("t1", "a1")
    assert app.public_view() == {
        "application-id": "a1", "tenant": "t1", "status": {"status": "DEPLOYED", "error": None},
        "created-at": 12.5, "units": 3, "files": ["pipeline.yaml", "python/agent.py"]}
    assert (app.files["python/agent.py"], app.instance, app.secrets) == (
        "x = 1\n", "instance: {}\n", "secrets: []\n")
    loaded.delete_application("t1", "a1")
    assert store.list_applications("t1") == [] and store.get_application("t1", "a1") is None
    loaded.delete_tenant("t1")
    assert store.list_tenants() == {}


@pytest.mark.parametrize("name", ["pipeline.yaml", "python/x.py", "python/lib/y.py",
                                  "../x.yaml", "a/b.yaml", "x.txt", "python/../x.py"])
def test_filenames_are_judged_as_the_jax_package_judges_them(name):
    from langstream_tpu.controlplane.stores import validate_filenames as jax_validate

    def verdict(fn):
        try:
            fn({name: ""})
            return None
        except ValueError as e:
            return str(e)

    assert verdict(validate_filenames) == verdict(jax_validate)


def test_the_in_memory_store_keeps_the_jax_semantics():
    store = InMemoryApplicationStore()
    store.put_tenant("t1")
    store.put_application(StoredApplication("t1", "b", {}))
    store.put_application(StoredApplication("t1", "a", {}))
    assert store.list_applications("t1") == ["a", "b"] and store.tenant_exists("t1")
    store.delete_tenant("t1")
    assert store.list_applications("t1") == [] and not store.tenant_exists("t1")


# each path's tenant or application name decodes to "../.." climbing from the
# store's tenants/ or tenants/t1/apps/ directory to its parent's "victim"
TRAVERSALS = [
    ("DELETE", "/api/tenants/..%2F..%2Fvictim"),
    ("PUT", "/api/tenants/%2E%2E%2F%2E%2E%2Fvictim"),
    ("GET", "/api/tenants/%2E%2E"),
    ("GET", "/api/applications/..%2F..%2Fvictim"),
    ("POST", "/api/applications/t1/..%2F..%2F..%2F..%2Fvictim"),
    ("PATCH", "/api/applications/t1/%2E%2E%2F%2E%2E%2F%2E%2E%2F%2E%2E%2Fvictim"),
    ("DELETE", "/api/applications/t1/%2E%2E%2F%2E%2E%2F%2E%2E%2F%2E%2E%2Fvictim"),
    ("DELETE", "/api/applications/..%2F..%2Fvictim/a1"),
    ("GET", "/api/applications/t1/%2E%2E/code"),
]


@pytest.mark.parametrize("admin", [False, True])
def test_a_name_that_climbs_out_of_the_store_is_refused_and_touches_nothing(tmp_path, admin):
    victim = tmp_path / "victim"
    victim.mkdir()
    (victim / "keep.txt").write_text("kept\n")
    headers = None
    admin_auth = None
    if admin:
        admin_auth = {"secret": "admin-secret"}
        headers = {"Authorization": "Bearer " + encode_hs256({"sub": "a"}, "admin-secret")}
    payload = app_payload()

    async def main():
        server = ControlPlaneServer(store=FileSystemApplicationStore(tmp_path / "store"),
                                    port=0, admin_auth=admin_auth)
        await server.start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            assert (await call(base, "PUT", "/api/tenants/t1", None, None, headers))[0] == 200
            answers = [await call(base, method, path, payload, None, headers)
                       for method, path in TRAVERSALS]
            # a plain name still deploys and deletes through the same wrapper
            deployed = await call(base, "POST", "/api/applications/t1/a1", payload, None,
                                  headers)
            deleted = await call(base, "DELETE", "/api/applications/t1/a1", None, None,
                                 headers)
        finally:
            await server.stop()
            engines = list(TorchServingEngine._instances.values())
            TorchServingEngine.reset_instances()
            for engine in engines:
                await engine.close()
        return answers, deployed, deleted

    answers, deployed, deleted = asyncio.run(main())
    for (method, path), (status, body) in zip(TRAVERSALS, answers):
        assert status == 400, (method, path, status, body)
        assert body.startswith("400: illegal "), body
    assert (deployed[0], deleted[0]) == (200, 200)
    assert (victim / "keep.txt").read_text() == "kept\n"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["store", "victim"]
    assert sorted(p.name for p in victim.iterdir()) == ["keep.txt"]
    assert sorted(p.name for p in (tmp_path / "store").iterdir()) == ["tenants"]
    assert sorted(p.name for p in (tmp_path / "store" / "tenants").iterdir()) == ["t1"]


@pytest.mark.parametrize("name,ok", [
    ("t1", True), ("my-app", True), ("App_2.v1", True), ("a" * 253, True),
    ("..", False), (".", False), ("../x", False), ("a/b", False), ("a\\b", False),
    ("a\x00b", False), ("", False), (".hidden", False), ("-x", False), ("x\n", False),
    ("a" * 254, False),
])
def test_names_the_stores_join_to_paths_are_one_plain_segment(tmp_path, name, ok):
    def verdict(fn):
        try:
            fn()
            return True
        except ValueError as e:
            assert "illegal" in str(e)
            return False

    assert verdict(lambda: validate_name("tenant", name)) is ok
    store = FileSystemApplicationStore(tmp_path)
    assert verdict(lambda: store.put_tenant(name)) is ok
    assert verdict(lambda: store.delete_application("t1", name)) is ok

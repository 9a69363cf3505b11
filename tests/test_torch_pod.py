"""The port's pod entrypoint (``langstream_tpu_torch/runtime/pod.py``)
against the JAX package's (``langstream_tpu/runtime/pod.py``):

- ``run_setup`` creates the app's topics on a tpustream broker, the same
  topics as the JAX pod's;
- ``run_code_download`` unpacks the same files from a code archive the
  control plane stored, and a config without an archive downloads nothing;
- the info server's routes (``/info``, ``/healthz``, ``/ready``,
  ``/metrics``, ``/flight``, ``/flight/summary``, ``/attribution``,
  ``/memory``, ``/traces``, ``/journey``, ``/incidents``, ``/kv/export/``,
  ``/profile/``, ``/drain``) answer with the JAX pod's status codes and keys,
  each package's pod over its own engine of the same tiny config on the CPU;
- ``main`` takes a leading ``--device``, refuses an unknown command (exit 2)
  and an agent on ``cuda`` without a card fails before the agent starts.
"""

import asyncio
import io
import json
import shutil
import types
import zipfile
from pathlib import Path

import pytest
import yaml

import langstream_tpu.core.codestorage as jax_codestorage
import langstream_tpu.native as jax_native
import langstream_tpu.runtime.pod as jax_pod
import langstream_tpu.runtime.tsb as jax_tsb
import langstream_tpu_torch.core.codestorage as port_codestorage
import langstream_tpu_torch.native as port_native
import langstream_tpu_torch.runtime.pod as port_pod
import langstream_tpu_torch.runtime.tsb as port_tsb
from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.gateway import wire
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

REPO = Path(__file__).resolve().parents[1]
APP = REPO / "examples" / "applications" / "mini-chat"

PACKAGES = {
    "jax": types.SimpleNamespace(pod=jax_pod, tsb=jax_tsb, native=jax_native,
                                 codestorage=jax_codestorage),
    "port": types.SimpleNamespace(pod=port_pod, tsb=port_tsb, native=port_native,
                                  codestorage=port_codestorage),
}


def _files() -> dict[str, str]:
    return {p.name: p.read_text() for p in sorted(APP.glob("*.yaml"))}


async def _topics(tsb, port: int) -> list[str]:
    conn = await tsb.TsbConnection("127.0.0.1", port).connect()
    try:
        cur = await conn.request(tsb.OP_LIST_TOPICS)
        names = []
        for _ in range(cur.u32()):
            names.append(cur.str())
            cur.u32()
        return sorted(names)
    finally:
        await conn.close()


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
@pytest.mark.parametrize("side", sorted(PACKAGES))
def test_run_setup_creates_the_apps_topics_on_a_tsbroker(side, tmp_path):
    pkg = PACKAGES[side]
    with pkg.native.BrokerProcess() as broker:
        config = tmp_path / "config"
        config.write_text(json.dumps({
            "applicationId": "mini", "tenant": "t1", "files": _files(), "secrets": None,
            "instance": yaml.safe_dump({"instance": {"streamingCluster": {
                "type": "tpustream",
                "configuration": {"bootstrap": f"127.0.0.1:{broker.port}"}}}})}))
        asyncio.run(pkg.pod.run_setup(str(config)))
        topics = asyncio.run(_topics(pkg.tsb, broker.port))
    assert topics == ["answers-topic", "questions-topic", "stream-topic"]


@pytest.mark.parametrize("side", sorted(PACKAGES))
def test_run_code_download_unpacks_the_stored_archive(side, tmp_path, caplog):
    pkg = PACKAGES[side]
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, text in _files().items():
            zf.writestr(f"app/{name}", text)
        zf.writestr("app/python/agent.py", "X = 1\n")
    storage = {"type": "local", "path": str(tmp_path / "store")}
    archive_id = pkg.codestorage.make_code_storage(storage).store("t1", "mini", buf.getvalue())
    assert archive_id == jax_codestorage.LocalDiskCodeStorage(tmp_path / "other").store(
        "t1", "mini", buf.getvalue())
    config = tmp_path / "config"
    config.write_text(json.dumps({"tenant": "t1", "codeStorage": {
        **storage, "codeArchiveId": archive_id}}))
    pkg.pod.run_code_download(str(config), str(tmp_path / "code"))
    got = sorted(str(p.relative_to(tmp_path / "code")) for p in (tmp_path / "code").rglob("*")
                 if p.is_file())
    assert got == ["app/app/" + n for n in ["configuration.yaml", "gateways.yaml",
                                            "pipeline.yaml", "python/agent.py"]]
    config.write_text(json.dumps({"tenant": "t1"}))
    caplog.set_level("INFO")
    pkg.pod.run_code_download(str(config), str(tmp_path / "none"))
    assert "no code archive configured" in caplog.text and not (tmp_path / "none").exists()


def test_the_ports_code_storage_refuses_azure_by_name():
    """``type: azure`` (and ``azure-blob-storage``) without credentials is
    refused, naming what is missing, in the JAX package's words; an
    unknown type is refused by name."""
    for kind in ("azure", "azure-blob-storage"):
        with pytest.raises(ValueError, match="azure code storage needs sas-token") as info:
            port_codestorage.make_code_storage({"type": kind, "configuration": {
                "endpoint": "http://127.0.0.1:1"}})
        with pytest.raises(ValueError) as jax_info:
            jax_codestorage.make_code_storage({"type": kind, "configuration": {
                "endpoint": "http://127.0.0.1:1"}})
        assert str(info.value) == str(jax_info.value)
    with pytest.raises(ValueError, match="unknown code storage type 'nope'"):
        port_codestorage.make_code_storage({"type": "nope"})


def test_the_ports_code_storage_builds_azure_blob_storage():
    """``type: azure`` (and ``azure-blob-storage``) with credentials builds
    the port's Azure code storage on the configured container (its round
    trip on the JAX tests' fake is in ``tests/test_torch_sources.py``)."""
    for kind in ("azure", "azure-blob-storage"):
        storage = port_codestorage.make_code_storage({"type": kind, "configuration": {
            "endpoint": "http://127.0.0.1:1", "container": "c", "sas-token": "sv=1&sig=x"}})
        assert isinstance(storage, port_codestorage.AzureBlobCodeStorage)
        assert storage.client.container == "c"


TINY = {"model": "tiny", "model-dtype": "float32", "slots": 2, "max-seq-len": 128,
        "decode-chunk": 4, "seed": 0}
ROUTES = ("/info", "/healthz", "/ready", "/metrics", "/flight", "/flight/summary",
          "/attribution", "/memory", "/traces", "/journey", "/incidents",
          "/incidents/nope", "/kv/export/nope", "/profile/bogus", "/drain?grace-s=1")


class _Runner:
    def info(self):
        return {"agent-id": "chat", "replica": 0}


def _shape(body):
    """What a route's body is made of: a dict's keys, the distinct key sets
    of a list's entries (the journey and span ledgers are the process's,
    so other tests' entries may be in them too)."""
    if isinstance(body, dict):
        return sorted(body)
    if isinstance(body, list):
        return sorted({tuple(sorted(e)) if isinstance(e, dict) else type(e).__name__
                       for e in body}, key=str)
    return type(body).__name__


async def _routes(pkg, engine, monkeypatch):
    monkeypatch.setenv("LS_HTTP_PORT", "0")
    await engine.generate("hello pod", {"max-tokens": 3, "temperature": 0})
    health = pkg.pod.PodHealth()
    health.agent_ready = True
    server = await pkg.pod._serve_info(_Runner(), health=health)
    port = server.sockets[0].getsockname()[1]
    out = {}
    try:
        for route in ROUTES:
            status, _, headers, body = await wire.http_request(
                "GET", f"http://127.0.0.1:{port}{route}", body=None)
            ctype = headers.get("content-type", "")
            if ctype == "application/json":
                out[route] = (status, _shape(json.loads(body)))
            else:
                out[route] = (status, ctype.split(";")[0], b"# TYPE" in body or body == b"")
    finally:
        server.close()
    return out


def test_the_info_servers_routes_answer_as_the_jax_pods(monkeypatch):
    import langstream_tpu.core.tracing as jax_tracing
    import langstream_tpu_torch.core.tracing as port_tracing

    monkeypatch.setattr(TpuServingEngine, "_instances", {})
    monkeypatch.setattr(TorchServingEngine, "_instances", {})
    # each package's span ring is the process's: start both empty, so spans
    # that other tests' runners left in one of them are not compared
    for tracing in (jax_tracing, port_tracing):
        monkeypatch.setattr(tracing, "SPANS", tracing.SpanBuffer(maxlen=1024))

    async def jax_side():
        engine = TpuServingEngine.get_or_create(JaxServingConfig.from_dict(TINY))
        try:
            return await _routes(PACKAGES["jax"], engine, monkeypatch)
        finally:
            await engine.close()

    async def port_side():
        engine = TorchServingEngine.get_or_create(ServingConfig.from_dict(TINY), device="cpu")
        try:
            return await _routes(PACKAGES["port"], engine, monkeypatch)
        finally:
            await engine.close()

    want = asyncio.run(jax_side())
    got = asyncio.run(port_side())
    TorchServingEngine.reset_instances()
    TpuServingEngine.reset_instances()
    assert {r: v[0] for r, v in got.items()} == {r: v[0] for r, v in want.items()}
    assert got["/healthz"][0] == got["/ready"][0] == 200
    for route in ("/info", "/healthz", "/ready", "/memory", "/journey", "/incidents",
                  "/kv/export/nope", "/profile/bogus", "/drain?grace-s=1", "/traces"):
        assert got[route] == want[route], route
    for route in ("/flight", "/flight/summary", "/attribution"):
        # one engine each; the JAX engine's sections are the port's
        (port_keys,), (jax_keys,) = got[route][1], want[route][1]
        assert set(jax_keys) <= set(port_keys), (route, set(jax_keys) - set(port_keys))
    assert got["/journey"][1], "the generate left no journey"
    assert got["/metrics"] == (200, "text/plain", True)


def test_main_takes_the_device_first_and_refuses_by_name(monkeypatch, capsys):
    assert port_pod.main(["--device", "cpu", "no-such-command"]) == 2
    assert "unknown command 'no-such-command'" in capsys.readouterr().err
    assert port_pod.main(["--device", "tpu", "agent-runtime", "x"]) == 2
    assert port_pod.main([]) == 2
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="the agent pod .--device cuda. runs on the card"):
        port_pod.main(["agent-runtime", "/nonexistent/config"])


def test_a_pod_of_an_app_with_an_unported_agent_refuses_it_at_planning(tmp_path, monkeypatch):
    """An app with a ``grpc-python-processor`` step (refused at planning
    until the sidecar lane was ported, whence the name): its setup
    and deployer Jobs' pods succeed, and the deployer writes the step's
    Agent CR into the kube API."""
    from langstream_tpu_torch.k8s.apiserver import FakeKubeApiServer
    from langstream_tpu_torch.k8s.client import HttpKubeApi
    from langstream_tpu_torch.k8s.cluster_runtime import tenant_namespace

    pipeline = {"topics": [{"name": "in", "creation-mode": "create-if-not-exists"}],
                "pipeline": [{"name": "c", "type": "grpc-python-processor", "input": "in",
                              "configuration": {}}]}
    config = tmp_path / "config"
    config.write_text(json.dumps({
        "applicationId": "a", "tenant": "t1", "files": {"pipeline.yaml": json.dumps(pipeline)},
        "instance": None, "secrets": None}))
    kube = FakeKubeApiServer().start()
    try:
        monkeypatch.setenv("LS_KUBE_API_URL", kube.url)
        HttpKubeApi(kube.url).apply({"apiVersion": "v1", "kind": "Namespace",
                                     "metadata": {"name": tenant_namespace("t1")}})
        asyncio.run(port_pod.run_setup(str(config)))
        asyncio.run(port_pod.run_deployer("deploy", str(config)))
        agents = HttpKubeApi(kube.url).list("Agent", tenant_namespace("t1"))
    finally:
        kube.stop()
    (agent,) = agents
    assert (agent["spec"]["applicationId"], agent["spec"]["agentId"]) == ("a", "c")

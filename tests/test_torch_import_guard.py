"""The port runs without JAX, the JAX package, PyYAML, aiohttp, click and
cryptography: in a subprocess whose import system refuses them, every
module of ``langstream_tpu_torch`` imports, and none of the client and
codec libraries the transports load only when used (``LAZY``) is loaded;
the chat app served over Kafka (``chip_smoke.py``'s path W at the tiny
model on the CPU) loads none of them either, nor ``confluent_kafka``,
``pulsar`` or ``pravega_client`` when they are refused; the retrieval
path (path X at the tiny model) and every vector store's datasource run
without them or ``psycopg``; the document path (path Y at the tiny
model) runs without them or ``pypdf``; ``python -m
langstream_tpu_torch.cli run`` serves a copy of the chat-completions
example at the tiny model on the CPU, answers a question through the port's
WebSocket client, and exits 0 on SIGINT; and ``python -m
langstream_tpu_torch.controlplane`` serves its REST API in ``LS_MODE=k8s``
and ``local``, refuses an unknown mode by name, and exits 0 on SIGINT;
with grpcio and protobuf refused as well, in every process through a
``sitecustomize``, ``cli run`` (``LocalRun``) of the ``grpc-sidecar-agent``
example answers through its sidecar, and the sidecar server alone answers
grpcio's calls."""

import asyncio
import os
import signal
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import yaml

from langstream_tpu_torch.gateway.wire import WebSocketClient

REPO = Path(__file__).resolve().parents[1]
REFUSED = ("jax", "jaxlib", "langstream_tpu", "yaml", "aiohttp", "click", "cryptography")
#: imported by the transports only when a client is built or a batch in
#: their codec arrives; ``psycopg`` (the postgres JDBC driver) never;
#: ``pypdf`` by ``text-extractor`` only when a PDF arrives
LAZY = ("confluent_kafka", "pulsar", "pravega_client", "zstandard", "snappy", "lz4",
        "psycopg", "pypdf")

def guard(refused=REFUSED) -> str:
    return GUARD.replace(repr(REFUSED), repr(tuple(refused)), 1)


GUARD = textwrap.dedent(f"""
    import importlib.abc
    import sys

    REFUSED = {REFUSED!r}


    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"import of {{name}} refused")
            return None


    sys.meta_path.insert(0, Refuse())
""")


def _guarded(tmp_path: Path, body: str, refused=REFUSED) -> Path:
    script = tmp_path / "guarded.py"
    script.write_text(guard(refused) + textwrap.dedent(body))
    return script


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1")
    env.pop("JAX_PLATFORMS", None)
    return env


def test_every_module_of_the_port_imports_without_them(tmp_path):
    script = _guarded(tmp_path, f"""
        import importlib
        from pathlib import Path

        root = Path({str(REPO / "langstream_tpu_torch")!r})
        names = sorted(
            ".".join(("langstream_tpu_torch",) + p.relative_to(root).with_suffix("").parts)
            .removesuffix(".__init__")
            for p in root.rglob("*.py")
        )
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
        assert not leaked, leaked
        lazy = sorted(m for m in sys.modules if m.split(".")[0] in {LAZY!r})
        assert not lazy, lazy
        print("imported", len(names))
    """)
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert int(out.stdout.split()[-1]) > 80


def test_the_chat_app_over_kafka_loads_none_of_them(tmp_path):
    """``chip_smoke.py``'s path W in a guarded process, the model table
    serving llama3-8b at the tiny model: the broker, SASL, W1's wave
    through the gateway, W2's broker state and W3's resume, with the
    client libraries refused too (``client: wire`` must never reach for
    them)."""
    script = _guarded(tmp_path, f"""
        sys.path.insert(0, {str(REPO)!r})
        import torch

        import chip_smoke
        from langstream_tpu_torch.serving import engine

        engine._MODEL_CONFIGS["llama3-8b"] = engine._MODEL_CONFIGS["tiny"]
        counts = chip_smoke.phase_kafka_path(torch, device="cpu")
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in REFUSED + {LAZY!r})
        assert not leaked, leaked
        print("served", len(counts), "kernels counted")
    """, refused=REFUSED + ("confluent_kafka", "pulsar", "pravega_client"))
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-4000:])
    assert "path W [W3" in out.stdout and "served 4 kernels counted" in out.stdout


def test_the_retrieval_path_loads_none_of_them(tmp_path):
    """``chip_smoke.py``'s path X in a guarded process, the model table
    serving llama3-8b at the tiny model and the corpus cut to 4 documents:
    the ingestion app, rag-pipeline through the gateway with X1's checks,
    and chatbot-rag-memory over /v1/chat with X2's, with ``psycopg``
    refused too."""
    script = _guarded(tmp_path, f"""
        sys.path.insert(0, {str(REPO)!r})
        import torch

        import chip_smoke
        from langstream_tpu_torch.serving import engine

        engine._MODEL_CONFIGS["llama3-8b"] = engine._MODEL_CONFIGS["tiny"]
        chip_smoke.X_DOCS = 4
        counts = chip_smoke.phase_retrieval_path(torch, device="cpu")
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED + {LAZY!r})
        assert not leaked, leaked
        print("served", len(counts), "kernels counted")
    """, refused=REFUSED + ("psycopg",))
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-4000:])
    assert '"history_rows": 8' in out.stdout and "served 4 kernels counted" in out.stdout


def test_the_document_path_loads_none_of_them(tmp_path):
    """``chip_smoke.py``'s path Y in a guarded process, the model table
    serving llama3-8b at the tiny model and Y1 cut to 4 short documents:
    the summarizer over a PDF (raw and compressed), a docx and HTML with
    ``pypdf`` refused too (``text-extractor`` falls back to ``pdftext``),
    and the crawl of Y2's site into the store through the port's client."""
    script = _guarded(tmp_path, f"""
        sys.path.insert(0, {str(REPO)!r})
        import torch

        import chip_smoke
        from langstream_tpu_torch.serving import engine

        engine._MODEL_CONFIGS["llama3-8b"] = engine._MODEL_CONFIGS["tiny"]
        chip_smoke.Y_KINDS = ("pdf", "docx", "html", "pdf-flate")
        chip_smoke.Y_DOC_CHARS = (300, 500, 700, 900)
        counts = chip_smoke.phase_document_path(torch, device="cpu")
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED + {LAZY!r})
        assert not leaked, leaked
        print("served", len(counts), "kernels counted")
    """, refused=REFUSED + ("pypdf",))
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-4000:])
    assert '"visited_equal_walk": true' in out.stdout
    assert "served 4 kernels counted" in out.stdout


def test_the_vector_stores_load_no_client_library(tmp_path):
    """Every datasource service resolves, the in-memory and SQLite stores
    write and query, and the postgres driver is refused by name, in a
    guarded process: none of the refused modules, the transports' libraries
    or ``psycopg`` is loaded, and the CQL module only once a ``cassandra``
    service is named."""
    script = _guarded(tmp_path, f"""
        import asyncio

        from langstream_tpu_torch.agents import vector

        assert "langstream_tpu_torch.agents.cassandra_cql" not in sys.modules
        services = {{"mem": {{"service": "in-memory"}},
                     "sql": {{"service": "jdbc", "url": {str(tmp_path / "v.db")!r}}},
                     "os": {{"service": "opensearch"}}, "pc": {{"service": "pinecone"}},
                     "mv": {{"service": "milvus"}}, "sl": {{"service": "solr"}},
                     "as": {{"service": "astra"}}, "cql": {{"service": "cassandra"}}}}
        resources = {{k: {{"type": "datasource", "name": k, "configuration": c}}
                      for k, c in services.items()}}
        stores = {{k: vector.resolve_datasource(k, resources) for k in services}}
        assert "langstream_tpu_torch.agents.cassandra_cql" in sys.modules

        async def main():
            mem, sql = stores["mem"], stores["sql"]
            await mem.upsert("docs", "a", [1.0, 0.0], {{"text": "alpha"}})
            await sql.execute_write("CREATE TABLE docs (id TEXT PRIMARY KEY, embeddings TEXT, "
                                    "text TEXT)", [])
            await sql.upsert("docs", "a", [1.0, 0.0], {{"text": "alpha"}})
            return (await mem.fetch_data('{{"collection": "docs", "vector": ?}}', [[1.0, 0.0]]),
                    await sql.fetch_data("SELECT id, text FROM docs", []))

        (hit,), (row,) = asyncio.run(main())
        assert hit["id"] == row["id"] == "a"
        try:
            vector.resolve_datasource("pg", {{"pg": {{"type": "datasource", "configuration": {{
                "service": "postgres"}}}}}})
            raise AssertionError("postgres resolved")
        except RuntimeError as e:
            assert "psycopg" in str(e), e
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED + {LAZY!r})
        assert not leaked, leaked
        print("resolved", len(stores))
    """)
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.split()[-1] == "8"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_cli_run_serves_the_chat_example_and_stops_on_sigint(tmp_path):
    app = tmp_path / "chat"
    app.mkdir()
    example = REPO / "examples" / "applications" / "chat-completions"
    for name in ("pipeline.yaml", "gateways.yaml"):
        (app / name).write_text((example / name).read_text())
    (app / "configuration.yaml").write_text(yaml.safe_dump({"configuration": {"resources": [{
        "type": "tpu-serving-configuration", "name": "tpu", "configuration": {
            "model": "tiny", "model-dtype": "float32", "slots": 4, "max-seq-len": 256,
            "checkpoint": str(REPO / "tests" / "fixtures" / "llama_tiny_golden"),
            "decode-chunk": 4, "decode-chunk-light": 2, "max-tokens": 16,
            "warmup-on-start": True}}]}}))
    port = _free_port()
    script = _guarded(tmp_path, f"""
        import runpy

        sys.argv = ["langstream_tpu_torch.cli", "run", "chat", "-app", {str(app)!r},
                    "-i", {str(REPO / "examples" / "instances" / "memory.yaml")!r},
                    "--device", "cpu", "--gateway-port", "{port}", "--api-port", "0"]
        runpy.run_module("langstream_tpu_torch.cli", run_name="__main__")
    """)
    proc = subprocess.Popen([sys.executable, str(script)], cwd=tmp_path, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "deployed" in line, (line, proc.stderr.read() if proc.poll() is not None else "")

        async def ask():
            base = f"ws://127.0.0.1:{port}/v1/%s/default/chat/%s?param:sessionId=g1"
            consumer = await WebSocketClient.connect(base % ("consume", "bot-output"))
            producer = await WebSocketClient.connect(base % ("produce", "user-input"))
            await producer.send_json({"value": "what is it?"})
            ack = await producer.receive_json(30)
            chunks = []
            while True:
                frame = await consumer.receive_json(60)
                chunks.append(frame["record"]["value"])
                if frame["record"]["headers"]["stream-last-message"] == "true":
                    break
            await producer.close()
            await consumer.close()
            return ack, "".join(chunks)

        ack, answer = asyncio.run(ask())
        assert ack["status"] == "OK" and answer
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    assert "stopped" in out


def test_the_control_plane_entrypoint_serves_and_refuses_k8s_by_name(tmp_path):
    """An unknown ``LS_MODE`` is refused by name (exit 2); ``LS_MODE=k8s``
    serves the REST API over the port's kube store (a tenant PUT writes the
    JAX store's Namespace and ConfigMap into the API server) and exits 0 on
    SIGINT; so does ``LS_MODE=local`` over the file-system store."""
    from langstream_tpu_torch.gateway.wire import http_request
    from langstream_tpu_torch.k8s.apiserver import FakeKubeApiServer
    from langstream_tpu_torch.k8s.client import HttpKubeApi

    script = _guarded(tmp_path, """
        import runpy

        sys.argv = ["langstream_tpu_torch.controlplane", "--device", "cpu"]
        runpy.run_module("langstream_tpu_torch.controlplane", run_name="__main__")
    """)
    env = dict(_env(), LS_MODE="bogus")
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "unknown LS_MODE 'bogus'" in out.stderr
    kube = FakeKubeApiServer().start()
    try:
        api = HttpKubeApi(kube.url)
        api.apply({"apiVersion": "v1", "kind": "Namespace",
                   "metadata": {"name": "langstream-system"}})
        for mode, extra in (("k8s", {"LS_KUBE_API_URL": kube.url}),
                            ("local", {"LS_STORE_PATH": str(tmp_path / "store")})):
            port = _free_port()
            env = dict(_env(), LS_MODE=mode, LS_PORT=str(port), LS_BIND="127.0.0.1", **extra)
            proc = subprocess.Popen([sys.executable, str(script)], cwd=tmp_path, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            try:
                line = proc.stdout.readline()
                assert f":{port}" in line, (line, proc.stderr.read()
                                            if proc.poll() is not None else "")
                status, _, _, body = asyncio.run(http_request(
                    "PUT", f"http://127.0.0.1:{port}/api/tenants/t1", body=None))
                assert status == 200 and b"OK" in body
                proc.send_signal(signal.SIGINT)
                out, err = proc.communicate(timeout=60)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
            assert proc.returncode == 0, err[-4000:]
            assert "stopped" in out
        assert api.get("Namespace", None, "langstream-t1") is not None
        assert api.get("ConfigMap", "langstream-system", "langstream-tenant-t1") is not None
    finally:
        kube.stop()
    assert (tmp_path / "store" / "tenants" / "t1" / "tenant.json").exists()


#: the sidecar lane's runs refuse grpcio and protobuf as well (``google``
#: itself is a namespace package that ``.pth`` files may load at start-up)
GRPC_REFUSED = REFUSED + ("grpc",)
PROTOBUF = "google.protobuf"


def _guarded_site(tmp_path: Path) -> dict:
    """An environment whose every Python process (the sidecars the port
    spawns too) installs the guard first, through a ``sitecustomize`` on
    ``PYTHONPATH``, and records its pid."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(guard(GRPC_REFUSED) + textwrap.dedent(f"""
        import os


        class RefuseProtobuf(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.startswith({PROTOBUF!r}):
                    raise ImportError(f"import of {{name}} refused")
                return None


        sys.meta_path.insert(0, RefuseProtobuf())

        with open({str(tmp_path / "guarded-pids")!r}, "a") as f:
            f.write(f"{{os.getpid()}}\\n")
    """))
    return dict(_env(), PYTHONPATH=os.pathsep.join([str(REPO), str(site)]))


def test_cli_run_of_the_grpc_sidecar_example_loads_none_of_them(tmp_path):
    """``cli run`` (``LocalRun``, its in-process form) of the unchanged
    ``grpc-sidecar-agent`` example in a process refusing JAX, grpcio and
    protobuf among the rest; the sidecar interpreter it spawns refuses them
    too, and answers every record."""
    script = tmp_path / "run_sidecar_app.py"
    script.write_text(textwrap.dedent(f"""
        import asyncio
        import sys

        from langstream_tpu_torch.cli.main import LocalRun

        async def main():
            run = await LocalRun("g", {str(REPO / "examples" / "applications" /
                                           "grpc-sidecar-agent")!r},
                                 {str(REPO / "examples" / "instances" / "memory.yaml")!r},
                                 device="cpu", gateway_port=0).start()
            try:
                for n in range(8):
                    await run.runner.produce("in-topic", f"r{{n}}")
                out = await run.runner.wait_for_messages("out-topic", 8, timeout=60)
                (node,) = run.runner.agent_info()
            finally:
                await run.stop()
            return sorted(m.value for m in out)

        values = asyncio.run(main())
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in {GRPC_REFUSED!r}
                        or m.startswith({PROTOBUF!r}))
        assert not leaked, leaked
        print("answered", values)
    """))
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=_guarded_site(tmp_path), capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-4000:])
    assert f"answered {sorted(f'r{n}!' for n in range(8))!r}" in out.stdout
    pids = (tmp_path / "guarded-pids").read_text().split()
    assert len(set(pids)) >= 2  # the run and its sidecar both guarded


def test_the_sidecar_server_process_loads_none_of_them(tmp_path):
    """``python -m langstream_tpu_torch.grpc.server config.json`` refusing
    JAX, grpcio and protobuf: it prints ``PORT=``, answers grpcio's
    ``agent_info`` and ``process``, and exits 0 on SIGTERM."""
    import json

    import grpc

    from langstream_tpu.grpc.proto import SERVICE_NAME, load_messages

    (tmp_path / "python").mkdir()
    (tmp_path / "python" / "guarded_agent.py").write_text(textwrap.dedent("""
        class Upper:
            def process(self, record):
                return [(record.value.upper(), None, None)]

            def agent_info(self):
                import sys
                return {"modules": sorted(m for m in sys.modules
                                          if m.split(".")[0] in ("grpc", "jax", "jaxlib")
                                          or m.startswith("google.protobuf"))}
    """))
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"className": "guarded_agent.Upper",
                                  "__application_directory__": str(tmp_path)}))
    proc = subprocess.Popen([sys.executable, "-m", "langstream_tpu_torch.grpc.server",
                             str(config)], cwd=tmp_path, env=_guarded_site(tmp_path),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("PORT="), (line, proc.stderr.read()
                                          if proc.poll() is not None else "")
        pb2 = load_messages()

        async def ask():
            async with grpc.aio.insecure_channel(f"127.0.0.1:{line.split('=')[1].strip()}") \
                    as channel:
                info = await channel.unary_unary(
                    f"/{SERVICE_NAME}/agent_info",
                    request_serializer=pb2.InfoRequest.SerializeToString,
                    response_deserializer=pb2.InfoResponse.FromString)(pb2.InfoRequest())
                call = channel.stream_stream(
                    f"/{SERVICE_NAME}/process",
                    request_serializer=pb2.ProcessRequest.SerializeToString,
                    response_deserializer=pb2.ProcessResponse.FromString)()
                request = pb2.ProcessRequest()
                record = request.records.add(record_id=5)
                record.value.string_value = "quiet"
                await call.write(request)
                response = await call.read()
                call.cancel()
                return json.loads(info.info_json), response

        info, response = asyncio.run(ask())
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert info == {"className": "guarded_agent.Upper", "modules": []}
    (result,) = response.results
    assert result.record_id == 5 and result.records[0].value.string_value == "QUIET"
    assert proc.returncode == 0, err[-4000:]

"""The port's admin client and CLI (``langstream_tpu_torch/admin``,
``langstream_tpu_torch/cli``) against the JAX package's.

- ``AdminClient``'s retry policy against a local server that fails on cue:
  idempotent requests retry 5xx and connection losses, a POST retries only
  a connection that never opened; the JAX client makes the same attempts.
- The CLI as processes (``HOME`` in ``tmp_path``) against ``python -m
  langstream_tpu_torch.cli run --api-port`` serving the ``chatbot-gateway``
  example at the tiny model on the CPU: every command's output equals the
  JAX CLI's against the same server, and the port's admin and gateway
  commands end with no ``torch`` in ``sys.modules``.
- The slice as a whole: ``chatbot-gateway`` at the tiny f32 fixture deployed
  through each package's REST API and asked over ``authenticated-chat``
  with one token: the greedy answer texts are equal.
"""

import asyncio
import io
import json
import os
import queue
import shutil
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import zipfile
from pathlib import Path

import pytest
import yaml

from langstream_tpu_torch.admin import AdminApiError, AdminClient
from langstream_tpu_torch.auth.jwt import encode_hs256
from langstream_tpu_torch.gateway import wire

REPO = Path(__file__).resolve().parents[1]
EXAMPLE = REPO / "examples" / "applications" / "chatbot-gateway"
SECRETS = REPO / "examples" / "secrets" / "secrets.yaml"
FIXTURE = str(REPO / "tests" / "fixtures" / "llama_tiny_golden")
#: what the repository's secrets file resolves for ``gateway.jwt-secret``
JWT_SECRET = "${GATEWAY_JWT_SECRET:-change-me}"
TOKEN = encode_hs256({"sub": "u-0"}, JWT_SECRET)
TINY = {"model": "tiny", "model-dtype": "float32", "slots": 2, "max-seq-len": 256,
        "checkpoint": FIXTURE, "decode-chunk": 4, "max-tokens": 12}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the retry policy
# ---------------------------------------------------------------------------


async def flaky_server(script: dict):
    """A raw server: per path, a list of answers taken one per request —
    an HTTP status, or ``"drop"`` (read the request, close without an
    answer). Past the list the last answer repeats. Returns (port, the
    requests seen, the server)."""
    seen = []

    async def serve(reader, writer):
        head = await reader.readuntil(b"\r\n\r\n")
        method, target = head.decode("latin-1").split(" ")[:2]
        length = 0
        for line in head.decode("latin-1").split("\r\n"):
            if line.lower().startswith("content-length:"):
                length = int(line.split(":")[1])
        if length:
            await reader.readexactly(length)
        seen.append((method, target))
        answers = script[target]
        answer = answers.pop(0) if len(answers) > 1 else answers[0]
        if answer != "drop":
            body = json.dumps({"answer": answer}).encode()
            writer.write(f"HTTP/1.1 {answer} X\r\nContent-Type: application/json\r\n"
                         f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
                         .encode() + body)
            await writer.drain()
        writer.close()

    server = await asyncio.start_server(serve, "127.0.0.1", 0)
    return server.sockets[0].getsockname()[1], seen, server


RETRY_CASES = {
    # (method, retry_safe, answers): what the client should end with
    "get-recovers-from-503s": ("GET", None, [503, 503, 200]),
    "get-gives-up-after-retries": ("GET", None, [500]),
    "post-never-retries-a-5xx": ("POST", None, [503, 200]),
    "patch-retry-safe-retries": ("PATCH", True, [502, 200]),
    "4xx-is-final": ("DELETE", None, [404, 200]),
    "get-retries-a-lost-answer": ("GET", None, ["drop", 200]),
    "post-does-not-retry-a-lost-answer": ("POST", None, ["drop", 200]),
}


@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_the_retry_policy_matches_the_jax_client(case):
    from langstream_tpu.admin import AdminApiError as JaxApiError
    from langstream_tpu.admin import AdminClient as JaxClient

    method, retry_safe, answers = RETRY_CASES[case]

    async def attempt(cls, api_error):
        port, seen, server = await flaky_server({"/x": list(answers)})
        client = cls(f"http://127.0.0.1:{port}", retries=3, backoff_s=0.001)
        try:
            result = ("ok", await client.request(method, "/x", retry_safe=retry_safe))
        except api_error as e:
            result = ("api-error", e.status)
        except Exception as e:  # noqa: BLE001 — a connection-level failure
            result = ("connection-error", type(e).__name__ != "")
        finally:
            await client.close()
            server.close()
            await server.wait_closed()
        return result, len(seen)

    port = asyncio.run(attempt(AdminClient, AdminApiError))
    jax = asyncio.run(attempt(JaxClient, JaxApiError))
    assert port == jax
    want = {"get-recovers-from-503s": (("ok", {"answer": 200}), 3),
            "get-gives-up-after-retries": (("api-error", 500), 4),
            "post-never-retries-a-5xx": (("api-error", 503), 1),
            "patch-retry-safe-retries": (("ok", {"answer": 200}), 2),
            "4xx-is-final": (("api-error", 404), 1),
            "get-retries-a-lost-answer": (("ok", {"answer": 200}), 2),
            "post-does-not-retry-a-lost-answer": (("connection-error", True), 1)}[case]
    assert port == want


def test_a_post_retries_a_connection_that_never_opened():
    """Nothing listens at first: the POST's connection fails before anything
    is sent (``wire.ConnectError``), so it is retried, and lands once the
    server is up."""
    async def main():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        seen = []

        async def handler(request):
            seen.append(request.method)
            return wire.json_response({"deployed": True})

        server = wire.HttpServer([("POST", "/x", handler)], port=port)
        client = AdminClient(f"http://127.0.0.1:{port}", retries=5, backoff_s=0.05)

        async def start_late():
            await asyncio.sleep(0.08)
            await server.start()

        starter = asyncio.ensure_future(start_late())
        try:
            result = await client.request("POST", "/x", json={"a": 1})
        finally:
            await starter
            await server.stop()
        return result, seen

    result, seen = asyncio.run(main())
    assert result == {"deployed": True} and seen == ["POST"]
    with pytest.raises(wire.ConnectError):
        asyncio.run(AdminClient(f"http://127.0.0.1:{free_port()}", retries=1,
                                backoff_s=0.001).request("POST", "/x"))


# ---------------------------------------------------------------------------
# the CLI as processes
# ---------------------------------------------------------------------------

#: runs the port's CLI and reports on stderr whether ``torch`` was loaded
PORT_CLI = textwrap.dedent("""
    import runpy
    import sys

    sys.argv = ["langstream_tpu_torch.cli"] + sys.argv[1:]
    code = 0
    try:
        runpy.run_module("langstream_tpu_torch.cli", run_name="__main__")
    except SystemExit as e:
        code = e.code or 0
    print("TORCH-LOADED", "torch" in sys.modules, file=sys.stderr)
    sys.exit(code)
""")


def tiny_app(root: Path) -> tuple[Path, Path]:
    """The ``chatbot-gateway`` example at the tiny model (the in-repo HF
    fixture) and an instance whose ``chat-model`` is ``tiny``."""
    app = root / "chatbot"
    app.mkdir()
    for name in ("pipeline.yaml", "gateways.yaml"):
        shutil.copy(EXAMPLE / name, app / name)
    (app / "configuration.yaml").write_text(yaml.safe_dump({"configuration": {"resources": [{
        "type": "tpu-serving-configuration", "name": "tpu", "configuration": TINY}]}}))
    instance = root / "instance.yaml"
    instance.write_text(yaml.safe_dump({"instance": {
        "streamingCluster": {"type": "memory"}, "computeCluster": {"type": "local"},
        "globals": {"chat-model": "tiny"}}}))
    return app, instance


class Cli:
    def __init__(self, home: Path):
        self.env = dict(os.environ, HOME=str(home), PYTHONPATH=str(REPO),
                        PYTHONUNBUFFERED="1")
        self.env.pop("LS_ADMIN_TOKEN", None)
        self.port_script = home / "port_cli.py"
        self.port_script.write_text(PORT_CLI)

    def argv(self, side: str, args: list[str]) -> list[str]:
        if side == "port":
            return [sys.executable, str(self.port_script), *args]
        return [sys.executable, "-m", "langstream_tpu.cli", *args]

    def run(self, side: str, args: list[str], stdin: str | None = None):
        out = subprocess.run(self.argv(side, args), env=self.env, cwd=self.env["HOME"],
                             input=stdin, capture_output=True, text=True, timeout=120)
        if side == "port":
            assert "TORCH-LOADED False" in out.stderr, (args, out.stderr[-2000:])
        err = "\n".join(line for line in out.stderr.splitlines()
                        if not line.startswith("TORCH-LOADED"))
        return out.returncode, out.stdout, err

    def chat(self, side: str, args: list[str], question: str) -> tuple[int, str]:
        """``gateway chat``: the question on stdin, kept open until the
        answer record's line has printed, then closed (the JAX CLI closes
        the socket at the end of its input)."""
        proc = subprocess.Popen(self.argv(side, args), env=self.env, cwd=self.env["HOME"],
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        lines: "queue.Queue[str]" = queue.Queue()
        threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                         daemon=True).start()
        out = []
        try:
            proc.stdin.write(question + "\n")
            proc.stdin.flush()
            while True:
                line = lines.get(timeout=120)
                out.append(line)
                if line.startswith("{"):  # the final answer record
                    break
            proc.stdin.close()
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        if side == "port":
            assert "TORCH-LOADED False" in proc.stderr.read()
        return rc, "".join(out)


def _scrub(text: str):
    try:
        value = json.loads(text)
    except json.JSONDecodeError:
        return text
    if isinstance(value, dict):
        value.pop("created-at", None)
    return value


def test_the_cli_commands_print_what_the_jax_cli_prints(tmp_path):
    app, instance = tiny_app(tmp_path)
    mock = tmp_path / "mock"
    mock.mkdir()
    (mock / "pipeline.yaml").write_text(
        "topics:\n  - name: a\n    creation-mode: create-if-not-exists\n"
        "pipeline:\n  - name: j\n    type: document-to-json\n    input: a\n")
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "pipeline.yaml").write_text(  # an agent reading a topic nobody declared
        "pipeline:\n  - name: j\n    type: document-to-json\n    input: missing\n")
    api, gw = free_port(), free_port()
    cli = Cli(tmp_path)
    server = subprocess.Popen(
        [sys.executable, "-m", "langstream_tpu_torch.cli", "run", "chatbot", "-app", str(app),
         "-i", str(instance), "-s", str(SECRETS), "--api-port", str(api), "--gateway-port",
         str(gw), "--archetypes", str(REPO / "examples" / "archetypes"), "--device", "cpu"],
        env=cli.env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=(tmp_path / "run.log").open("w"), text=True)
    try:
        head = [server.stdout.readline() for _ in range(3)]
        assert "deployed" in head[0] and f":{api}" in head[1] and f":{gw}" in head[2], (
            head, (tmp_path / "run.log").read_text()[-3000:])
        out = {}
        for side in ("port", "jax"):
            o = {}
            o["configure"] = cli.run(side, ["configure", "--api-url", f"http://127.0.0.1:{api}",
                                            "--gateway-url", f"http://127.0.0.1:{gw}"])
            for args in (["tenants", "list"], ["tenants", "put", "t2"],
                         ["tenants", "delete", "t2"], ["apps", "list"],
                         ["apps", "get", "chatbot"], ["apps", "get", "nope"],
                         ["archetypes", "list"], ["archetypes", "get", "chatbot"],
                         ["gateway", "produce", "chatbot", "chat", "-v", "x"],
                         ["gateway", "chat", "chatbot", "authenticated-chat",
                          "--credentials", "bad"]):
                o[" ".join(args)] = cli.run(side, args)
            rc, stdout, err = cli.run(side, ["apps", "deploy", "extra", "-app", str(mock),
                                             "-i", str(instance)])
            o["deploy"] = (rc, _scrub(stdout), err)
            rc, stdout, err = cli.run(side, ["apps", "update", "chatbot", "-app", str(bad)])
            o["bad update"] = (rc, stdout, err)
            o["delete"] = cli.run(side, ["apps", "delete", "extra"])
            zip_path = tmp_path / f"{side}.zip"
            rc, stdout, _ = cli.run(side, ["apps", "download", "chatbot", "-o", str(zip_path)])
            with zipfile.ZipFile(io.BytesIO(zip_path.read_bytes())) as zf:
                o["download"] = (rc, {n: zf.read(n) for n in zf.namelist()})
            o["chat"] = cli.chat(side, ["gateway", "chat", "chatbot", "authenticated-chat",
                                        "--credentials", TOKEN], "what is it?")
            rc, stdout, _ = cli.run(side, ["apps", "logs", "chatbot"])
            o["logs"] = (rc, "application chatbot deployed" in stdout)
            out[side] = o
        server.send_signal(signal.SIGINT)
        rc = server.wait(timeout=60)
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    assert rc == 0
    for key in out["jax"]:
        assert out["port"][key] == out["jax"][key], key
    port = out["port"]
    assert json.loads(port["apps list"][1]) == ["chatbot"]
    assert json.loads(port["apps get chatbot"][1])["status"]["status"] == "DEPLOYED"
    assert port["apps get nope"] == (1, "", "Error: 404: 404: Not Found")
    assert port["gateway produce chatbot chat -v x"][2].startswith(
        "Error: gateway refused connection (400)")
    assert "(401)" in port["gateway chat chatbot authenticated-chat --credentials bad"][2]
    assert port["deploy"][1]["status"]["status"] == "DEPLOYED"
    assert port["bad update"][0] == 1 and "400: invalid application" in port["bad update"][2]
    assert port["chat"][0] == 0 and '"answer"' in port["chat"][1]
    assert port["logs"] == (0, True)


def test_the_unported_commands_are_refused_by_name(tmp_path):
    """``apps ui`` and ``python ...`` (refused by name until the sidecar
    lane was ported, whence the name) run in the port's CLI as in
    the JAX CLI, and load no ``torch``: the same lines, the page served."""
    cli = Cli(tmp_path)
    app = tmp_path / "app"
    (app / "python").mkdir(parents=True)
    outs = {side: cli.run(side, ["python", "install-requirements", "-app", str(app)])
            for side in ("port", "jax")}
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == 0 and outs["port"][1].split()[-1] == sys.executable
    rc, _, err = cli.run("port", ["python", "run-tests", "-app", str(tmp_path / "none")])
    assert rc == 2 and "does not exist" in err
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = ["apps", "ui", "x", "--port", str(port), "--no-open", "--once",
            "--gateway-url", "ws://127.0.0.1:1"]
    proc = subprocess.Popen(cli.argv("port", args), env=cli.env, cwd=cli.env["HOME"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        body = wire_get(line.split("chat UI: ", 1)[1].strip())
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0 and "TORCH-LOADED False" in err
    assert body == (REPO / "langstream_tpu" / "cli" / "app_ui.html").read_bytes()
    assert line.strip() == (f"chat UI: http://127.0.0.1:{port}/?tenant=default&app=x&gw=chat"
                            "&gateway=ws%3A%2F%2F127.0.0.1%3A1")


def wire_get(url: str) -> bytes:
    status, _, _, body = asyncio.run(wire.http_request("GET", url))
    assert status == 200
    return body


def test_docs_agents_documents_the_port_s_agents_as_the_jax_cli_does(tmp_path):
    from langstream_tpu.core.docsgen import agent_docs as jax_docs

    cli = Cli(tmp_path)
    rc, stdout, _ = cli.run("port", ["docs", "agents", "--format", "json"])
    port = json.loads(stdout)
    jax = jax_docs()
    # every agent type, the four ``grpc-*`` ones since the sidecar lane came
    assert rc == 0 and set(port) == set(jax) and len(port) == 46
    assert all(port[t] == jax[t] for t in port)
    rc, stdout, _ = cli.run("port", ["docs", "agents", "-o", str(tmp_path / "a.md")])
    assert rc == 0 and stdout.strip() == f"wrote {tmp_path / 'a.md'}"
    assert (tmp_path / "a.md").read_text().startswith("# Agent reference")


def test_apps_diagram_equals_the_jax_cli(tmp_path):
    app, instance = tiny_app(tmp_path)
    cli = Cli(tmp_path)
    args = ["apps", "diagram", "-app", str(app), "-i", str(instance), "-s", str(SECRETS)]
    port, jax = cli.run("port", args), cli.run("jax", args)
    assert port == jax and port[1].startswith("flowchart LR")


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def test_chatbot_gateway_through_each_rest_api_gives_the_same_greedy_answer(tmp_path, monkeypatch):
    """Each package's control plane and gateway in this process (the JAX
    ``run``'s layout), the example deployed at the tiny f32 fixture through
    the REST API, one question over ``authenticated-chat`` with one token:
    the streamed chunks join to the answer, every record carries the
    token's ``sub``, and the greedy texts are equal."""
    from langstream_tpu.controlplane.server import ControlPlaneServer as JaxControlPlane
    from langstream_tpu.controlplane.server import LocalComputeRuntime as JaxCompute
    from langstream_tpu.gateway.server import GatewayRegistry as JaxRegistry
    from langstream_tpu.gateway.server import GatewayServer as JaxGateway
    from langstream_tpu.serving.engine import TpuServingEngine
    from langstream_tpu_torch.agents import services
    from langstream_tpu_torch.controlplane.server import (
        ControlPlaneServer,
        LocalComputeRuntime,
    )
    from langstream_tpu_torch.gateway.server import GatewayRegistry, GatewayServer
    from langstream_tpu_torch.serving.engine import TorchServingEngine

    monkeypatch.setattr(services, "SERVING_DEVICE", "cpu")
    app, instance = tiny_app(tmp_path)
    files = {p.name: p.read_text() for p in sorted(app.glob("*.yaml"))}
    payload = {"files": files, "instance": instance.read_text(), "secrets": SECRETS.read_text()}

    async def side(name):
        if name == "jax":
            registry = JaxRegistry()
            control = JaxControlPlane(compute=JaxCompute(gateway_registry=registry),
                                      port=free_port())
            gateway = JaxGateway(registry=registry, port=free_port())
        else:
            registry = GatewayRegistry()
            control = ControlPlaneServer(compute=LocalComputeRuntime(gateway_registry=registry),
                                         port=0)
            gateway = GatewayServer(registry=registry, port=0)
        await control.start()
        await gateway.start()
        try:
            client = AdminClient(f"http://127.0.0.1:{control.port}")
            await client.put_tenant("default")
            deployed = await client.deploy_application("default", "chatbot", payload)
            assert deployed["status"]["status"] == "DEPLOYED", deployed
            ws = await wire.WebSocketClient.connect(
                f"ws://127.0.0.1:{gateway.port}/v1/chat/default/chatbot/authenticated-chat"
                f"?credentials={TOKEN}")
            await ws.send_json({"value": "what is it?"})
            ack = await ws.receive_json(120)
            chunks, users = [], set()
            while True:
                frame = await ws.receive_json(120)
                users.add(frame["record"]["headers"].get("langstream-client-user"))
                value = frame["record"]["value"]
                if isinstance(value, dict):
                    await ws.close()
                    return ack["status"], "".join(chunks), value["answer"], users
                chunks.append(value)
        finally:
            await gateway.stop()
            await control.stop()
            for cls in (TorchServingEngine, TpuServingEngine):
                engines = list(cls._instances.values())
                cls.reset_instances()
                for engine in engines:
                    await engine.close()

    port = asyncio.run(side("port"))
    jax = asyncio.run(side("jax"))
    assert port == jax
    status, streamed, answer, users = port
    assert status == "OK" and answer and streamed == answer and users == {"u-0"}


@pytest.mark.parametrize("case", [
    ("http://h:1", "produce", ["sessionId=a&b=c"], "tok=en%", None),
    ("https://gw.example:8443", "consume", [], None, {"position": "earliest"}),
    ("http://127.0.0.1:8091", "chat", ["k=v w", "empty="], "a.b.c", None),
])
def test_gateway_urls_are_encoded_as_the_jax_cli_encodes_them(case):
    from langstream_tpu.cli.main import _gw_ws_url as jax_url
    from langstream_tpu_torch.cli.main import _gw_ws_url

    base, kind, params, credentials, options = case
    port = _gw_ws_url(base, kind, "t", "app", "gw", list(params), credentials, options)
    assert port == jax_url(base, kind, "t", "app", "gw", tuple(params), credentials, options)

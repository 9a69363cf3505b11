"""The port's command line (a copy of ``langstream_tpu/cli/main.py`` on
argparse instead of click, and on the port's stdlib client instead of
aiohttp):

    python -m langstream_tpu_torch.cli configure [--api-url U] [--gateway-url U] [--tenant T]
    python -m langstream_tpu_torch.cli tenants put|list|delete ...
    python -m langstream_tpu_torch.cli apps deploy|update|get|list|delete|download|logs|diagram ...
    python -m langstream_tpu_torch.cli apps ui NAME [--gateway G] [--gateway-url U] [--port P]
        [--open/--no-open]
    python -m langstream_tpu_torch.cli archetypes list|get|deploy ...
    python -m langstream_tpu_torch.cli gateway produce|consume|chat APP GATEWAY
        [-p name=value ...] [--credentials TOKEN] ...
    python -m langstream_tpu_torch.cli docs agents [--format markdown|json] [-o FILE]
    python -m langstream_tpu_torch.cli run NAME -app DIR [-i INSTANCE] [-s SECRETS]
        [--api-port P] [--gateway-port G] [--archetypes DIR] [--device cuda|cpu]
    python -m langstream_tpu_torch.cli mini up [-app DIR] [--device cuda|cpu] [--once] ...
    python -m langstream_tpu_torch.cli python install-requirements -app DIR
    python -m langstream_tpu_torch.cli python run-tests -app DIR [PYTEST ARGS ...]

Every command prints what the JAX CLI prints (JSON bodies, the same lines)
and fails as it does (``Error: <message>`` on stderr, exit 1). The profile
is the JAX CLI's file, ``~/.langstream-tpu/config.json``; the bearer token
comes from its ``token`` or ``LS_ADMIN_TOKEN``. The admin, gateway and
docs commands import no ``torch``: they run on the admin client
(:mod:`langstream_tpu_torch.admin`) and the stdlib client
(:mod:`langstream_tpu_torch.gateway.wire`).

``run`` is the single-process dev mode: it starts the control plane's REST
API (``--api-port``) and the gateway (``--gateway-port``), deploys the
application into the in-process compute runtime, and serves until SIGINT
or SIGTERM, then undeploys, closes the engines and exits 0.
``tpu-serving-configuration`` resources serve on ``--device``: the card
unless ``--device cpu`` is given; with no card and no ``--device cpu`` the
command fails (``require_device``), it never falls back to the CPU.

``mini up`` is the one-command local cluster (:mod:`langstream_tpu_torch.cli.mini`).

``apps ui`` serves the bundled chat page (``app_ui.html``, the JAX CLI's)
against an app's chat gateway; ``python install-requirements`` provisions
an app's own interpreter for its sidecar agents and ``python run-tests``
runs its ``python/`` tests on it
(:mod:`langstream_tpu_torch.runtime.isolation`).

:class:`LocalRun` is ``run`` in-process, for callers that drive an
application themselves (the smoke, the tests).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
from pathlib import Path
from typing import Any

TENANT = "default"
DEFAULT_API = "http://127.0.0.1:8090"
DEFAULT_GATEWAY = "http://127.0.0.1:8091"


def profile_path() -> Path:
    return Path.home() / ".langstream-tpu" / "config.json"


class CliError(Exception):
    """A command's failure: printed as ``Error: <message>``, exit 1 (the
    JAX CLI's ``click.ClickException``)."""


def _profile() -> dict:
    path = profile_path()
    if path.exists():
        return json.loads(path.read_text())
    return {}


def _api_url(value: str | None) -> str:
    return value or _profile().get("api-url", DEFAULT_API)


def _gateway_url(value: str | None) -> str:
    return value or _profile().get("gateway-url", DEFAULT_GATEWAY)


def _tenant(value: str | None) -> str:
    return value or _profile().get("tenant", "default")


def _request(method: str, url: str, **kwargs) -> Any:
    """All CLI HTTP goes through the AdminClient facade (retry policies,
    auth header); ``apps update``'s PATCH is revalidated server-side, so it
    rides the retry-safe lane the facade marks for it."""
    from urllib.parse import urlsplit

    from langstream_tpu_torch.admin import AdminApiError, AdminClient

    parts = urlsplit(url)
    base = f"{parts.scheme}://{parts.netloc}"
    path = parts.path + (f"?{parts.query}" if parts.query else "")
    token = (
        kwargs.pop("token", None)
        or _profile().get("token")
        or os.environ.get("LS_ADMIN_TOKEN")
    )
    client = AdminClient(base, token=token)

    async def call():
        return await client.request(
            method, path,
            retry_safe=True if method.upper() == "PATCH" else None,
            **kwargs,
        )

    try:
        return asyncio.run(call())
    except AdminApiError as e:
        raise CliError(str(e))
    except (OSError, asyncio.IncompleteReadError, ValueError) as e:
        raise CliError(f"control plane unreachable: {e}")


def _echo(value: Any, indent: int | None = None) -> None:
    print(json.dumps(value, indent=indent), flush=True)


# ---------------------------------------------------------------------------
# configure, tenants
# ---------------------------------------------------------------------------


def cmd_configure(args) -> None:
    profile = _profile()
    if args.api_url:
        profile["api-url"] = args.api_url
    if args.gateway_url:
        profile["gateway-url"] = args.gateway_url
    if args.tenant:
        profile["tenant"] = args.tenant
    path = profile_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(profile, indent=2))
    print(f"profile saved: {path}", flush=True)


def cmd_tenants(args) -> None:
    base = _api_url(args.api_url)
    if args.action == "put":
        _echo(_request("PUT", f"{base}/api/tenants/{args.name}"))
    elif args.action == "list":
        _echo(_request("GET", f"{base}/api/tenants"), indent=2)
    else:
        _echo(_request("DELETE", f"{base}/api/tenants/{args.name}"))


# ---------------------------------------------------------------------------
# apps
# ---------------------------------------------------------------------------


def collect_files(app_dir: Path) -> dict[str, str]:
    """An application directory as the control plane stores it: its
    top-level YAML files, and custom agent code under ``python/`` and
    ``python/lib/``."""
    app_dir = Path(app_dir)
    files = {}
    for path in sorted(app_dir.glob("*.yaml")) + sorted(app_dir.glob("*.yml")):
        files[path.name] = path.read_text()
    if not files:
        raise CliError(f"no YAML files in {app_dir}")
    for pattern in ("python/*.py", "python/lib/*.py"):
        for path in sorted(app_dir.glob(pattern)):
            files[path.relative_to(app_dir).as_posix()] = path.read_text()
    return files


def _app_payload(app: str, instance: str | None, secrets: str | None) -> dict:
    payload: dict = {"files": collect_files(Path(app))}
    if instance:
        payload["instance"] = Path(instance).read_text()
    if secrets:
        payload["secrets"] = Path(secrets).read_text()
    return payload


def cmd_apps(args) -> None:
    if args.action == "diagram":
        from langstream_tpu_torch.core.deployer import ApplicationDeployer
        from langstream_tpu_torch.core.diagram import mermaid_diagram
        from langstream_tpu_torch.core.parser import build_application_from_directory

        application = build_application_from_directory(args.app, args.instance, args.secrets)
        plan = ApplicationDeployer().create_implementation("app", application)
        print(mermaid_diagram(plan), flush=True)
        return
    if args.action == "ui":
        return apps_ui(args)
    base = f"{_api_url(args.api_url)}/api/applications/{_tenant(args.tenant)}"
    if args.action == "list":
        _echo(_request("GET", base), indent=2)
        return
    url = f"{base}/{args.name}"
    if args.action in ("deploy", "update"):
        method = "POST" if args.action == "deploy" else "PATCH"
        _echo(_request(method, url, json=_app_payload(args.app, args.instance, args.secrets)),
              indent=2)
    elif args.action == "get":
        _echo(_request("GET", url), indent=2)
    elif args.action == "delete":
        _echo(_request("DELETE", url))
    elif args.action == "download":
        data = _request("GET", f"{url}/code", binary=True)
        target = Path(args.output or f"{args.name}.zip")
        target.write_bytes(data)
        print(f"wrote {target} ({len(data)} bytes)", flush=True)
    elif args.action == "logs":
        print(_request("GET", f"{url}/logs"), flush=True)


# ---------------------------------------------------------------------------
# archetypes + docs
# ---------------------------------------------------------------------------


def cmd_archetypes(args) -> None:
    base = f"{_api_url(args.api_url)}/api/archetypes/{_tenant(args.tenant)}"
    if args.action == "list":
        _echo(_request("GET", base), indent=2)
    elif args.action == "get":
        _echo(_request("GET", f"{base}/{args.archetype_id}"), indent=2)
    else:
        payload: dict = {"parameters": dict(p.split("=", 1) for p in args.parameters)}
        if args.instance:
            payload["instance"] = Path(args.instance).read_text()
        if args.secrets:
            payload["secrets"] = Path(args.secrets).read_text()
        _echo(_request("POST", f"{base}/{args.archetype_id}/applications/{args.name}",
                       json=payload), indent=2)


def cmd_docs(args) -> None:
    from langstream_tpu_torch.core.docsgen import render_json, render_markdown

    text = render_markdown() if args.format == "markdown" else render_json()
    if args.output:
        Path(args.output).write_text(text)
        print(f"wrote {args.output}", flush=True)
    else:
        print(text, flush=True)


# ---------------------------------------------------------------------------
# gateway clients
# ---------------------------------------------------------------------------


def _gw_ws_url(base: str, kind: str, tenant: str, app: str, gateway: str,
               params: list[str], credentials: str | None,
               options: dict | None = None) -> str:
    from urllib.parse import quote

    url = base.replace("http://", "ws://").replace("https://", "wss://")
    qs = []
    for p in params:
        k, _, v = p.partition("=")
        qs.append(f"param:{quote(k, safe='')}={quote(v, safe='')}")
    if credentials:
        qs.append(f"credentials={quote(credentials, safe='')}")
    for k, v in (options or {}).items():
        qs.append(f"option:{quote(str(k), safe='')}={quote(str(v), safe='')}")
    query = ("?" + "&".join(qs)) if qs else ""
    return f"{url}/v1/{kind}/{tenant}/{app}/{gateway}{query}"


async def _ws_connect(url: str):
    """The port's WebSocket client; a refused handshake is a CLI error, in
    the JAX CLI's words."""
    from langstream_tpu_torch.gateway import wire

    try:
        return await wire.WebSocketClient.connect(url)
    except wire.HandshakeError as e:
        raise CliError(
            f"gateway refused connection ({e.status}): Invalid response status [{url}]")


def cmd_gateway(args) -> None:
    from langstream_tpu_torch.gateway.wire import WSMsgType

    tenant = _tenant(args.tenant)
    base = _gateway_url(args.gateway_url)
    options = {"position": args.position} if args.action == "consume" else None
    url = _gw_ws_url(base, args.action, tenant, args.application, args.gateway_id,
                     args.param, args.credentials, options)

    async def produce():
        ws = await _ws_connect(url)
        try:
            await ws.send_json({"value": args.value, "key": args.key})
            _echo(await ws.receive_json())
        finally:
            await ws.close()

    async def consume():
        ws = await _ws_connect(url)
        count = 0
        try:
            async for msg in ws:
                if msg.type == WSMsgType.TEXT:
                    print(msg.data, flush=True)
                    count += 1
                    if args.num_messages and count >= args.num_messages:
                        return
        finally:
            await ws.close()

    async def chat():
        import threading

        ws = await _ws_connect(url)
        loop = asyncio.get_running_loop()
        # stdin is read on a daemon thread (not the default executor): when
        # the server closes the socket mid-readline, asyncio.run's shutdown
        # would otherwise join the blocked thread until the next keypress
        lines: asyncio.Queue[str | None] = asyncio.Queue()

        def read_stdin():
            while True:
                line = sys.stdin.readline()
                loop.call_soon_threadsafe(lines.put_nowait, line or None)
                if not line:
                    return

        threading.Thread(target=read_stdin, daemon=True).start()

        async def pump_stdin():
            while True:
                line = await lines.get()
                if line is None:
                    await ws.close()
                    return
                await ws.send_json({"value": line.strip()})

        stdin_task = asyncio.ensure_future(pump_stdin())
        try:
            async for msg in ws:
                if msg.type != WSMsgType.TEXT:
                    continue
                data = json.loads(msg.data)
                if "record" not in data:
                    continue
                value = data["record"].get("value")
                if isinstance(value, str):
                    print(value, end="", flush=True)
                    headers = data["record"].get("headers", {})
                    if headers.get("stream-last-message") == "true":
                        print(flush=True)
                else:
                    _echo(value)
        finally:
            stdin_task.cancel()
            await ws.close()

    asyncio.run({"produce": produce, "consume": consume, "chat": chat}[args.action]())


# ---------------------------------------------------------------------------
# dev mode: everything in one process
# ---------------------------------------------------------------------------


class LocalRun:
    """One application deployed in this process behind its gateway and,
    with ``api_port`` given, the control plane's REST API (as the JAX
    ``run`` serves them): ``await LocalRun(...).start()``, then :meth:`url`
    for a gateway's socket and :attr:`runner` for its topics; :meth:`stop`
    stops both servers, undeploys the application and closes the port's
    engines.

    One run serves in a process at a time: the serving device and the
    engines are the process's, so :meth:`start` refuses a second run until
    the first has stopped, and :meth:`stop` puts the serving device back."""

    _active: "LocalRun | None" = None

    def __init__(self, name: str, app: str | Path, instance: str | Path | None = None,
                 secrets: str | Path | None = None, gateway_port: int = 8091,
                 device: str = "cuda", host: str = "127.0.0.1",
                 api_port: int | None = None, archetypes: str | None = None):
        from langstream_tpu_torch._device import require_device
        from langstream_tpu_torch.controlplane.server import (
            ControlPlaneServer,
            LocalComputeRuntime,
        )
        from langstream_tpu_torch.controlplane.stores import InMemoryApplicationStore
        from langstream_tpu_torch.gateway.server import GatewayRegistry, GatewayServer

        require_device(device, "langstream_tpu_torch.cli run")
        self.name = name
        self.app = Path(app)
        self.instance = Path(instance).read_text() if instance else None
        self.secrets = Path(secrets).read_text() if secrets else None
        self.device = device
        self.registry = GatewayRegistry()
        self.compute = LocalComputeRuntime(gateway_registry=self.registry)
        self.gateway = GatewayServer(registry=self.registry, port=gateway_port, host=host)
        self.store = InMemoryApplicationStore()
        self.store.put_tenant(TENANT)
        self.control = None
        if api_port is not None:
            self.control = ControlPlaneServer(
                store=self.store, compute=self.compute, port=api_port, host=host,
                archetypes_path=archetypes,
            )

    async def start(self) -> "LocalRun":
        from langstream_tpu_torch.agents import services
        from langstream_tpu_torch.controlplane.stores import StoredApplication

        if LocalRun._active is not None:
            raise RuntimeError(
                f"application {LocalRun._active.name!r} is already served in this "
                "process; stop it before starting another")
        LocalRun._active = self
        self._previous_device = services.SERVING_DEVICE
        services.set_serving_device(self.device)
        stored = StoredApplication(
            tenant=TENANT, name=self.name, files=collect_files(self.app),
            instance=self.instance, secrets=self.secrets,
        )
        try:
            if self.control is not None:
                await self.control.start()
            await self.gateway.start()
            self.store.put_application(stored)
            await self.compute.deploy(stored)
            stored.status = "DEPLOYED"
        except BaseException:
            await self.stop()
            raise
        return self

    @property
    def runner(self):
        """The application's :class:`LocalApplicationRunner`."""
        return self.compute.runners[(TENANT, self.name)]

    def url(self, kind: str, gateway: str, **params: str) -> str:
        """``ws://host:port/v1/<kind>/default/<name>/<gateway>?param:k=v``."""
        from urllib.parse import urlencode

        query = urlencode({f"param:{k}": v for k, v in params.items()})
        base = f"ws://{self.gateway.host}:{self.gateway.port}/v1/{kind}/{TENANT}/{self.name}/{gateway}"
        return f"{base}?{query}" if query else base

    async def stop(self) -> None:
        from langstream_tpu_torch.agents import services

        try:
            await self.gateway.stop()
            if self.control is not None:
                await self.control.stop()  # undeploys through the compute runtime
            await self.compute.close()
        finally:
            try:
                await close_engines()
            finally:
                services.set_serving_device(self._previous_device)
                LocalRun._active = None

    async def __aenter__(self) -> "LocalRun":
        return await self.start()

    async def __aexit__(self, *exc: Any) -> None:
        await self.stop()


async def close_engines() -> None:
    """Close and forget every serving engine the port started in this
    process (their dispatch threads end with them)."""
    from langstream_tpu_torch.serving.engine import TorchServingEngine

    engines = list(TorchServingEngine._instances.values())
    TorchServingEngine.reset_instances()
    for engine in engines:
        await engine.close()


async def run(name: str, app: str, instance: str | None = None, secrets: str | None = None,
              gateway_port: int = 8091, device: str = "cuda", api_port: int | None = 8090,
              archetypes: str | None = None) -> int:
    """Serve ``app`` until SIGINT or SIGTERM, then stop cleanly (exit 0)."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    local = LocalRun(name, app, instance, secrets, gateway_port=gateway_port, device=device,
                     api_port=api_port, archetypes=archetypes)
    await local.start()
    print(f"application {name!r} deployed", flush=True)
    if local.control is not None:
        print(f"control plane: http://127.0.0.1:{local.control.port}", flush=True)
    print(f"gateway:       ws://127.0.0.1:{local.gateway.port}", flush=True)
    try:
        await stop.wait()
    finally:
        await local.stop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.remove_signal_handler(sig)
    print("stopped", flush=True)
    return 0


def cmd_run(args) -> int:
    return asyncio.run(run(args.name, args.app, args.instance, args.secrets,
                           gateway_port=args.gateway_port, device=args.device,
                           api_port=args.api_port, archetypes=args.archetypes))


# ---------------------------------------------------------------------------
# apps ui, python
# ---------------------------------------------------------------------------


def apps_ui(args) -> None:
    """Serve the bundled chat UI against an app's chat gateway (parity:
    `langstream apps ui` serving langstream-cli's app-ui/index.html)."""
    import http.server
    import threading
    import urllib.parse
    import webbrowser

    tenant = _tenant(args.tenant)
    ws_base = _gateway_url(args.gateway_url)
    page = (Path(__file__).parent / "app_ui.html").read_bytes()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib naming)
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(page)))
            self.end_headers()
            self.wfile.write(page)

        def log_message(self, *a):  # quiet
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    # the close waits for the handler's thread, so a ``--once`` process
    # answers before it exits (the JAX CLI's daemon threads may not)
    server.daemon_threads = False
    actual_port = server.server_address[1]
    query = urllib.parse.urlencode(
        {"tenant": tenant, "app": args.name, "gw": args.gateway_id, "gateway": ws_base})
    url = f"http://127.0.0.1:{actual_port}/?{query}"
    print(f"chat UI: {url}", flush=True)
    if args.open_browser:
        threading.Thread(target=webbrowser.open, args=(url,), daemon=True).start()
    try:
        if args.once:
            server.handle_request()
        else:
            server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


def cmd_python(args) -> int:
    """``install-requirements``: provision the app's isolated venv from
    python/requirements.txt and print the interpreter its sidecar agents
    will run on (parity: load-pip-requirements; here deps install into a
    venv-per-app instead of the shared lib dir, the NAR-isolation answer).
    ``run-tests``: run the application's python/ test suite on the app's
    interpreter (the venv when requirements are pinned), with pytest's exit
    code."""
    import subprocess

    from langstream_tpu_torch.runtime.isolation import (
        ensure_app_interpreter,
        requirements_file,
    )

    if args.action == "install-requirements":
        if requirements_file(args.app) is None:
            print("no python/requirements.txt: sidecars use the base interpreter", flush=True)
        try:
            interpreter = ensure_app_interpreter(args.app)
        except (RuntimeError, subprocess.CalledProcessError) as e:
            raise CliError(str(e))
        print(interpreter, flush=True)
        return 0
    code_dir = Path(args.app) / "python"
    if not code_dir.is_dir():
        raise CliError(f"{args.app} has no python/ directory")
    interpreter = ensure_app_interpreter(args.app)
    result = subprocess.run([interpreter, "-m", "pytest", *(args.pytest_args or ("-q",))],
                            cwd=code_dir)
    return result.returncode


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m langstream_tpu_torch.cli",
        description="LangStream applications through the PyTorch port.")
    commands = parser.add_subparsers(dest="command", required=True)

    def app_files(cmd, required=True):
        cmd.add_argument("-app", "--application", dest="app", required=required)
        cmd.add_argument("-i", "--instance", default=None)
        cmd.add_argument("-s", "--secrets", default=None)

    def remote(cmd):
        cmd.add_argument("--tenant", default=None)
        cmd.add_argument("--api-url", default=None)

    cmd = commands.add_parser("configure", help="save the connection profile")
    cmd.add_argument("--api-url", default=None)
    cmd.add_argument("--gateway-url", default=None)
    cmd.add_argument("--tenant", default=None)
    cmd.set_defaults(func=cmd_configure)

    tenants = commands.add_parser("tenants", help="manage tenants")
    actions = tenants.add_subparsers(dest="action", required=True)
    for action in ("put", "list", "delete"):
        cmd = actions.add_parser(action)
        if action != "list":
            cmd.add_argument("name")
        cmd.add_argument("--api-url", default=None)
        cmd.set_defaults(func=cmd_tenants)

    apps = commands.add_parser("apps", help="manage applications")
    actions = apps.add_subparsers(dest="action", required=True)
    for action in ("deploy", "update"):
        cmd = actions.add_parser(action)
        cmd.add_argument("name")
        app_files(cmd)
        remote(cmd)
        cmd.set_defaults(func=cmd_apps)
    for action in ("get", "delete", "logs", "download"):
        cmd = actions.add_parser(action)
        cmd.add_argument("name")
        if action == "download":
            cmd.add_argument("-o", "--output", default=None)
        remote(cmd)
        cmd.set_defaults(func=cmd_apps)
    cmd = actions.add_parser("ui", help="serve the bundled chat UI against an app's chat gateway")
    cmd.add_argument("name")
    cmd.add_argument("--tenant", default=None)
    cmd.add_argument("--gateway", dest="gateway_id", default="chat",
                     help="chat gateway id in the app's gateways.yaml")
    cmd.add_argument("--gateway-url", default=None,
                     help="websocket gateway base (default: profile / ws://localhost:8091)")
    cmd.add_argument("--port", type=int, default=8092,
                     help="local port to serve the UI on (0 = ephemeral)")
    cmd.add_argument("--open", dest="open_browser", action="store_true", default=True,
                     help="open the page in a browser")
    cmd.add_argument("--no-open", dest="open_browser", action="store_false")
    cmd.add_argument("--once", action="store_true", help=argparse.SUPPRESS)
    cmd.set_defaults(func=cmd_apps)
    cmd = actions.add_parser("list")
    remote(cmd)
    cmd.set_defaults(func=cmd_apps)
    cmd = actions.add_parser("diagram")
    app_files(cmd)
    cmd.set_defaults(func=cmd_apps)

    archetypes = commands.add_parser("archetypes", help="parameterized application templates")
    actions = archetypes.add_subparsers(dest="action", required=True)
    cmd = actions.add_parser("list")
    remote(cmd)
    cmd.set_defaults(func=cmd_archetypes)
    cmd = actions.add_parser("get")
    cmd.add_argument("archetype_id")
    remote(cmd)
    cmd.set_defaults(func=cmd_archetypes)
    cmd = actions.add_parser("deploy")
    cmd.add_argument("archetype_id")
    cmd.add_argument("name")
    cmd.add_argument("-p", "--parameter", dest="parameters", action="append", default=[])
    cmd.add_argument("-i", "--instance", default=None)
    cmd.add_argument("-s", "--secrets", default=None)
    remote(cmd)
    cmd.set_defaults(func=cmd_archetypes)

    docs = commands.add_parser("docs", help="generated documentation")
    actions = docs.add_subparsers(dest="action", required=True)
    cmd = actions.add_parser("agents")
    cmd.add_argument("--format", choices=("markdown", "json"), default="markdown")
    cmd.add_argument("-o", "--output", default=None)
    cmd.set_defaults(func=cmd_docs)

    gateway = commands.add_parser("gateway", help="interact with application gateways")
    actions = gateway.add_subparsers(dest="action", required=True)
    for action in ("produce", "consume", "chat"):
        cmd = actions.add_parser(action)
        cmd.add_argument("application")
        cmd.add_argument("gateway_id")
        if action == "produce":
            cmd.add_argument("-v", "--value", required=True)
            cmd.add_argument("-k", "--key", default=None)
        if action == "consume":
            cmd.add_argument("--position", default="latest")
            cmd.add_argument("-n", "--num-messages", type=int, default=0)
        cmd.add_argument("-p", "--param", action="append", default=[])
        cmd.add_argument("--credentials", default=None)
        cmd.add_argument("--tenant", default=None)
        cmd.add_argument("--gateway-url", default=None)
        cmd.set_defaults(func=cmd_gateway)

    cmd = commands.add_parser(
        "run", help="single-process dev mode: the control plane and the gateway in "
                    "this process, the application deployed, served until interrupted")
    cmd.add_argument("name")
    app_files(cmd)
    cmd.add_argument("--api-port", type=int, default=8090)
    cmd.add_argument("--gateway-port", type=int, default=8091)
    cmd.add_argument("--archetypes", default=None)
    cmd.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    cmd.set_defaults(func=cmd_run)

    from langstream_tpu_torch.cli import mini

    mini.add_parser(commands)

    python = commands.add_parser("python", help="per-application Python tooling")
    actions = python.add_subparsers(dest="action", required=True)
    for action in ("install-requirements", "run-tests"):
        cmd = actions.add_parser(action)
        cmd.add_argument("-app", "--application", dest="app", required=True)
        cmd.set_defaults(func=cmd_python)
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if args.command == "python" and args.action == "run-tests":
        args.pytest_args = extra  # everything else goes to pytest
    elif extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    for attr in ("app", "instance", "secrets", "archetypes"):
        path = getattr(args, attr, None)
        if path is not None and not Path(path).exists():
            print(f"error: {path} does not exist", file=sys.stderr)
            return 2
    try:
        return args.func(args) or 0
    except CliError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

"""The port's standalone gateway (``python -m langstream_tpu_torch.gateway``)
against the JAX package's: ``_sync_registry`` polling the port's control
plane fills the gateway registry as the JAX one does polling the JAX
control plane (the same applications, gateways and streaming clusters), and
a deleted application leaves both; the registry's ``service_uri`` names an
unregistered agent's in-cluster service as the JAX registry does; and the
entrypoint serves, syncs and stops on SIGINT with JAX and the JAX package
refused."""

import asyncio
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import yaml

import langstream_tpu.gateway.__main__ as jax_gateway_main
import langstream_tpu_torch.gateway.__main__ as port_gateway_main
from langstream_tpu.controlplane.server import ControlPlaneServer as JaxControlPlane
from langstream_tpu.controlplane.stores import InMemoryApplicationStore as JaxMemoryStore
from langstream_tpu.controlplane.stores import StoredApplication as JaxStored
from langstream_tpu.gateway.server import GatewayRegistry as JaxRegistry
from langstream_tpu_torch.controlplane.server import ControlPlaneServer
from langstream_tpu_torch.controlplane.stores import InMemoryApplicationStore, StoredApplication
from langstream_tpu_torch.gateway.server import GatewayRegistry

REPO = Path(__file__).resolve().parents[1]
APP = REPO / "examples" / "applications" / "mini-chat"

SIDES = {
    "jax": (JaxControlPlane, JaxMemoryStore, JaxStored, JaxRegistry, jax_gateway_main),
    "port": (ControlPlaneServer, InMemoryApplicationStore, StoredApplication, GatewayRegistry,
             port_gateway_main),
}


def _files() -> dict[str, str]:
    files = {p.name: p.read_text() for p in sorted(APP.glob("*.yaml"))}
    pipeline = yaml.safe_load(files["pipeline.yaml"])
    pipeline["pipeline"][0]["configuration"]["service-port"] = 8123
    files["pipeline.yaml"] = yaml.safe_dump(pipeline)
    return files


INSTANCE = yaml.safe_dump({"instance": {"streamingCluster": {
    "type": "tpustream", "configuration": {"bootstrap": "127.0.0.1:9077"}}}})


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


async def _synced(side: str) -> dict:
    server_cls, store_cls, stored_cls, registry_cls, module = SIDES[side]
    store = store_cls()
    store.put_tenant("t1")
    store.put_application(stored_cls(tenant="t1", name="mini", files=_files(),
                                     instance=INSTANCE, status="DEPLOYED"))
    control = server_cls(store=store, port=_free_port())
    await control.start()
    registry = registry_cls()
    task = asyncio.ensure_future(module._sync_registry(
        registry, f"http://127.0.0.1:{control.port}"))
    try:
        for _ in range(200):
            if registry.application("t1", "mini") is not None:
                break
            await asyncio.sleep(0.05)
        app = registry.application("t1", "mini")
        gateway, streaming = registry.resolve("t1", "mini", "user-input")
        out = {
            "gateways": sorted((g.id, g.type, g.topic) for g in app.gateways),
            "resolved": (gateway.id, gateway.topic, streaming),
            "agents": sorted(a.id for a in app.all_agents()),
            "uris": [registry.service_uri("t1", "mini", a.id) for a in
                     sorted(app.all_agents(), key=lambda a: a.id)]
                    + [registry.service_uri("t1", "mini", "missing_agent")],
        }
        store.delete_application("t1", "mini")
        for _ in range(200):  # the next poll (5 s apart) unregisters it
            if registry.application("t1", "mini") is None:
                break
            await asyncio.sleep(0.05)
        out["after_delete"] = registry.application("t1", "mini")
        return out
    finally:
        task.cancel()
        await control.stop()


def test_the_registry_sync_fills_the_registry_as_the_jax_one(monkeypatch):
    monkeypatch.setattr(port_gateway_main, "SYNC_INTERVAL_S", 0.2)
    want = asyncio.run(_synced("jax"))
    got = asyncio.run(_synced("port"))
    assert got == want
    assert got["after_delete"] is None and got["gateways"]
    assert got["uris"][-1] == "http://mini-missing-agent.langstream-t1.svc:8790"
    assert "http://mini-convert-to-structure.langstream-t1.svc:8123" in got["uris"]


@pytest.mark.parametrize("explicit", [False, True])
def test_service_uri_falls_back_to_the_in_cluster_name_as_the_jax_registry(explicit):
    from langstream_tpu.core.parser import build_application_from_files as jax_build
    from langstream_tpu_torch.core.parser import build_application_from_files

    registries = {"jax": JaxRegistry(), "port": GatewayRegistry()}
    registries["jax"].register("T_1", "My_App", jax_build(_files(), INSTANCE, None))
    registries["port"].register("T_1", "My_App", build_application_from_files(
        _files(), INSTANCE, None))
    uris = {}
    for side, registry in registries.items():
        if explicit:
            registry.register_service_uri("T_1", "My_App", "chat", "http://10.0.0.1:9000/")
        uris[side] = [registry.service_uri("T_1", "My_App", a)
                      for a in ("chat", "convert-to-structure", "unknown")]
    assert uris["port"] == uris["jax"]
    assert uris["port"][1] == "http://my-app-convert-to-structure.langstream-t_1.svc:8123"


GUARD = textwrap.dedent("""
    import importlib.abc
    import runpy
    import sys

    REFUSED = ("jax", "jaxlib", "langstream_tpu", "yaml", "aiohttp", "click", "cryptography")


    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"import of {name} refused")
            return None


    sys.meta_path.insert(0, Refuse())
    sys.argv = ["langstream_tpu_torch.gateway"]
    runpy.run_module("langstream_tpu_torch.gateway", run_name="__main__")
""")


def test_the_entrypoint_serves_syncs_and_stops_without_jax(tmp_path):
    async def control_plane():
        store = InMemoryApplicationStore()
        store.put_tenant("t1")
        memory = yaml.safe_dump({"instance": {"streamingCluster": {"type": "memory"}}})
        store.put_application(StoredApplication(tenant="t1", name="mini", files=_files(),
                                                instance=memory, status="DEPLOYED"))
        control = ControlPlaneServer(store=store, port=0)
        await control.start()
        return control

    loop = asyncio.new_event_loop()
    control = loop.run_until_complete(control_plane())
    script = tmp_path / "gateway.py"
    script.write_text(GUARD)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "LS_PORT": str(port), "LS_BIND": "127.0.0.1",
           "LS_CONTROL_PLANE_URL": f"http://127.0.0.1:{control.port}/"}
    proc = subprocess.Popen([sys.executable, str(script)], cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert f"ws://127.0.0.1:{port}" in line, (line, proc.stderr.read()
                                                  if proc.poll() is not None else "")
        from langstream_tpu_torch.gateway.wire import HandshakeError, WebSocketClient

        async def consume():
            deadline = time.monotonic() + 30
            while True:  # the sync registers the app on its first pass
                try:
                    return await WebSocketClient.connect(
                        f"ws://127.0.0.1:{port}/v1/consume/t1/mini/bot-output"
                        "?param:sessionId=s1")
                except HandshakeError:
                    if time.monotonic() > deadline:
                        raise
                    await asyncio.sleep(0.2)

        ws = loop.run_until_complete(consume())
        loop.run_until_complete(ws.close())
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        loop.run_until_complete(control.stop())
        loop.close()
    assert proc.returncode == 0, err[-3000:]
    assert "stopped" in out and "refused" not in err

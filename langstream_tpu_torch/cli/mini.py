"""``cli mini`` — the one-command local cluster (mini-langstream parity; the
port's copy of ``langstream_tpu/cli/mini.py`` on argparse).

    python -m langstream_tpu_torch.cli mini up [-app DIR] [--name N] [--tenant T]
        [--api-port P] [--gateway-port G] [--data-dir D] [--device cuda|cpu] [--once]

The reference's ``mini-langstream`` stands up minikube + helm + its whole
control plane and deploys apps into real pods. This image has no container
runtime, so ``mini up`` assembles the same production topology from the
port's components, with PROCESSES as pods:

  embedded kube API server (k8s/apiserver.py — real HTTP, real 409s/watches)
    ← control plane in k8s mode (Application CRs + Agent CRs + Secrets)
    ← operator (CRs → setup/deployer Jobs → StatefulSets)
    ← process-kubelet (k8s/kubelet.py — Jobs + STS pods as subprocesses
       running the port's pod entrypoint, ``python -m serve_torch --device
       <device> pod``)
  native tsbroker (C++ epoll broker) as the streaming cluster
  api-gateway with registry sync off the control plane

Nothing is mocked in the data path: the deployed app's agents run in their
own OS processes, consume/produce over the broker's TCP protocol, and the
chat gateway serves real websockets. No process imports JAX.

``--device`` (default ``cuda``) is the device the operator writes into
every pod's command: an agent pod on ``cuda`` serves its
``tpu-serving-configuration`` resources on the card, and fails without one.
Each StatefulSet pod gets an info-server port of its own (``LS_HTTP_PORT``,
written to ``<data dir>/kubelet/pods/<namespace>/<pod>/http-port``), which
the control plane's pod fan-in (``/api/applications/{t}/{n}/health`` and
the like) reaches. A broker that fails to build fails ``mini up`` with the
compiler's error. SIGINT or SIGTERM tears the cluster down (every pod
process reaped) and exits 0; ``--once`` drives one chat message through the
cluster first and then tears down.
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_APP = REPO_ROOT / "examples" / "applications" / "mini-chat"


def _echo(text: str) -> None:
    print(text, flush=True)


def _instance_yaml(broker_port: int) -> str:
    return (
        "instance:\n"
        "  streamingCluster:\n"
        '    type: "tpustream"\n'
        "    configuration:\n"
        f'      bootstrap: "127.0.0.1:{broker_port}"\n'
    )


async def _mini_up(
    app_dir: Path,
    name: str,
    tenant: str,
    api_port: int,
    gateway_port: int,
    data_dir: Path,
    device: str,
    once: bool,
) -> None:
    from langstream_tpu_torch.controlplane.server import ControlPlaneServer
    from langstream_tpu_torch.controlplane.stores import StoredApplication
    from langstream_tpu_torch.gateway.__main__ import _sync_registry
    from langstream_tpu_torch.gateway.server import GatewayRegistry, GatewayServer
    from langstream_tpu_torch.k8s.apiserver import FakeKubeApiServer
    from langstream_tpu_torch.k8s.client import HttpKubeApi
    from langstream_tpu_torch.k8s.compute import KubernetesComputeRuntime
    from langstream_tpu_torch.k8s.crds import crd_manifests
    from langstream_tpu_torch.k8s.kubelet import ProcessKubelet
    from langstream_tpu_torch.k8s.operator import Operator
    from langstream_tpu_torch.k8s.resources import accelerator_from_env
    from langstream_tpu_torch.k8s.stores import (
        GLOBAL_NAMESPACE,
        KubernetesApplicationStore,
    )
    from langstream_tpu_torch.native import BrokerProcess

    accelerator = accelerator_from_env()  # a TPU name fails before anything starts
    data_dir.mkdir(parents=True, exist_ok=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)

    kube = broker = control = operator = operator_task = kubelet = gw = sync_task = None
    try:
        # 1. embedded API server + cluster bootstrap (the helm install's job)
        kube = FakeKubeApiServer().start()
        api = HttpKubeApi(kube.url)
        for manifest in crd_manifests():
            api.apply(manifest)
        for ns in ("langstream-tpu", GLOBAL_NAMESPACE):
            api.apply({
                "apiVersion": "v1", "kind": "Namespace",
                "metadata": {"name": ns},
            })
        _echo(f"✔ kube API server      {kube.url}")

        # 2. the native broker (streaming cluster)
        broker = BrokerProcess().start()
        _echo(f"✔ tsbroker             127.0.0.1:{broker.port}")

        # 3. control plane in k8s mode + operator + process-kubelet
        pod_env = {
            "LS_KUBE_API_URL": kube.url,
            "PYTHONPATH": str(REPO_ROOT)
            + os.pathsep
            + os.environ.get("PYTHONPATH", ""),
        }
        kubelet = ProcessKubelet(
            HttpKubeApi(kube.url), root=data_dir / "kubelet", env_extra=pod_env
        )
        code_storage = {
            "type": "local",
            "configuration": {"path": str(data_dir / "code-storage")},
        }
        store = KubernetesApplicationStore(api, code_storage_config=code_storage)
        compute = KubernetesComputeRuntime(
            api, code_storage_config=code_storage,
            pods_root=data_dir / "kubelet", pod_address=kubelet.pod_address,
        )
        control = ControlPlaneServer(
            store=store, compute=compute, port=api_port
        )
        await control.start()
        _echo(f"✔ control plane        http://127.0.0.1:{control.port}")

        operator = Operator(api, interval=1.0, accelerator=accelerator, watch=True,
                            device=device)
        operator_task = asyncio.ensure_future(operator.run())
        kubelet.start()
        _echo(f"✔ operator + kubelet   pods under {data_dir / 'kubelet'} "
              f"(--device {device}, {accelerator})")

        # 4. api gateway with registry sync off the control plane
        registry = GatewayRegistry()
        gw = GatewayServer(registry=registry, port=gateway_port)
        await gw.start()
        sync_task = asyncio.ensure_future(
            _sync_registry(registry, f"http://127.0.0.1:{control.port}")
        )
        _echo(f"✔ api gateway          ws://127.0.0.1:{gw.port}")

        # 5. deploy the app through the control plane's own deploy path
        store.put_tenant(tenant)
        files = {
            p.name: p.read_text()
            for p in sorted(app_dir.iterdir())
            if p.is_file() and p.suffix in (".yaml", ".yml")
        }
        python_dir = app_dir / "python"
        if python_dir.is_dir():
            files.update({
                f"python/{p.name}": p.read_text()
                for p in sorted(python_dir.iterdir()) if p.suffix == ".py"
            })
        stored = StoredApplication(
            tenant=tenant, name=name, files=files,
            instance=_instance_yaml(broker.port),
        )
        stored.status = "DEPLOYING"
        store.put_application(stored)
        await compute.deploy(stored)  # stamps stored.code_archive_id
        stored.status = "DEPLOYED"
        store.put_application(stored)
        _echo(f"✔ application {name!r} deployed (tenant {tenant!r})")

        # 6. wait for the agent pods to come up (Agent CR statuses → DEPLOYED)
        deadline = loop.time() + 120
        while True:
            agents = compute.agent_info(tenant, name)
            statuses = [a["status"].get("status") for a in agents]
            if agents and all(s == "DEPLOYED" for s in statuses):
                break
            if loop.time() > deadline:
                raise RuntimeError(
                    f"agents not ready after 120s: {statuses} "
                    f"(pod logs under {data_dir / 'kubelet' / 'pods'})"
                )
            if stop.is_set():
                return
            await asyncio.sleep(1.0)
        _echo(f"✔ {len(agents)} agent pod(s) running")
        _echo("")
        _echo("chat (new terminals):")
        cli = "python -m langstream_tpu_torch.cli gateway"
        where = f"--tenant {tenant} --gateway-url ws://127.0.0.1:{gw.port}"
        _echo(f"  {cli} consume {name} bot-output -p sessionId=s1 {where}")
        _echo(f"  {cli} produce {name} user-input -p sessionId=s1 -v 'hello' {where}")

        if once:
            # smoke mode: drive one message through the full path and exit
            await _smoke_chat(gw.port, tenant, name)
        else:
            await stop.wait()
    finally:
        _echo("tearing down ...")
        if sync_task is not None:
            sync_task.cancel()
        if kubelet is not None:
            kubelet.stop()
        if operator is not None:
            operator.stop()
            operator_task.cancel()
        if gw is not None:
            await gw.stop()
        if control is not None:
            await control.stop()
        if broker is not None:
            broker.stop()
        if kube is not None:
            kube.stop()


async def _smoke_chat(gateway_port: int, tenant: str, name: str) -> None:
    """--once: one produce → one streamed answer over the real websocket."""
    from langstream_tpu_torch.gateway.wire import WebSocketClient

    session_id = "mini-smoke"
    base = f"ws://127.0.0.1:{gateway_port}"
    consumer = await WebSocketClient.connect(
        f"{base}/v1/consume/{tenant}/{name}/bot-output?param:sessionId={session_id}")
    try:
        producer = await WebSocketClient.connect(
            f"{base}/v1/produce/{tenant}/{name}/user-input?param:sessionId={session_id}")
        try:
            await producer.send_json({"value": "hello mini cluster"})
            ack = await producer.receive_json(30)
            if ack.get("status", "OK") != "OK":
                raise RuntimeError(f"produce failed: {ack}")
        finally:
            await producer.close()
        chunks = []
        while True:
            msg = await consumer.receive_json(60)
            record = msg.get("record") or {}
            chunks.append(str(record.get("value") or ""))
            headers = record.get("headers") or {}
            if str(headers.get("stream-last-message")).lower() == "true":
                break
    finally:
        await consumer.close()
    _echo(f"✔ smoke chat answered ({len(chunks)} stream chunks): {''.join(chunks)!r}")


def add_parser(commands) -> None:
    """``mini up`` under the port's CLI."""
    mini = commands.add_parser("mini", help="one-command local cluster (mini-langstream)")
    actions = mini.add_subparsers(dest="action", required=True)
    cmd = actions.add_parser("up", help="boot the full local cluster and deploy an application")
    cmd.add_argument("-app", "--application", dest="app", default=str(DEFAULT_APP),
                     help="application directory (default: the mini-chat demo)")
    cmd.add_argument("--name", default="mini-chat")
    cmd.add_argument("--tenant", default="default")
    cmd.add_argument("--api-port", type=int, default=8090)
    cmd.add_argument("--gateway-port", type=int, default=8091)
    cmd.add_argument("--data-dir", default=None,
                     help="cluster state root (default ~/.langstream-tpu/mini)")
    cmd.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="the device the agent pods serve on (default: the card)")
    cmd.add_argument("--once", action="store_true",
                     help="smoke mode: drive one chat message through the cluster, "
                          "then tear down (CI-able)")
    cmd.set_defaults(func=cmd_mini)


def cmd_mini(args) -> int:
    """Boot the full local cluster and deploy an application."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    data = Path(args.data_dir) if args.data_dir else Path.home() / ".langstream-tpu" / "mini"
    try:
        asyncio.run(_mini_up(
            Path(args.app), args.name, args.tenant, args.api_port, args.gateway_port,
            data, args.device, args.once,
        ))
    except (RuntimeError, ValueError, OSError) as e:
        print(f"mini cluster failed: {e}", file=sys.stderr)
        return 1
    _echo("stopped")
    return 0


"""The port in the cluster: its manifests (``langstream_tpu_torch/k8s``)
and the operator and pods that reach it through ``serve_torch.register``.

- ``gpu_placement`` on every :data:`GPU_TOPOLOGIES` entry: one host at or
  below its cards per host, hosts of ``per_host`` cards above it, and the
  refusals (a count that is not a multiple, an unknown name, a TPU name);
  ``LS_ACCELERATOR`` names a port entry or is refused in the port's words.
- The port's manifests against ``langstream_tpu.k8s.resources``'s for the
  CRs ``tests/test_k8s.py`` builds (a CPU agent, one host, a slice, a disk,
  pool roles, pool roles on a slice refused): equal outside the placement
  keys (``nvidia.com/gpu`` for ``google.com/tpu``, the node selector, the
  GPU toleration, ``/dev/shm``, ``LOCAL_WORLD_SIZE``, the command), and
  those keys as the port sets them. A slice is compared at the mesh that
  gives both factories the same hosts.
- The platform's ``Operator`` writes the port's StatefulSets and PDBs after
  ``register``, the JAX factory's without it; ``python -m serve_torch pod``
  runs the platform's pod entrypoint; the port's factory imports neither
  JAX nor the JAX package (a fresh interpreter).
- The process kubelet runs the port's 2 x 2 slice from its manifests (the
  ``h100-2g`` entry, ``{dp: 2, tp: 2}``, tiny f32 on the CPU): the pods
  join one world, the leader answers a record from the broker, the
  follower's ``/info`` says ``slice-follower``, and at SIGTERM every pod
  and every rank it started exits 0.
"""

import asyncio
import copy
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

import serve_torch
from langstream_tpu.k8s import operator as k8s_operator
from langstream_tpu.k8s import resources as jax_resources
from langstream_tpu.k8s.client import InMemoryKubeApi
from langstream_tpu.k8s.crds import (
    AgentCustomResource,
    AgentResourcesCR,
    AgentSpec,
    DiskSpecCR,
)
from langstream_tpu.k8s.operator import Operator
from langstream_tpu_torch.k8s.resources import (
    DEFAULT_ACCELERATOR,
    GPU_TOPOLOGIES,
    AgentResourcesFactory,
    accelerator_from_env,
    gpu_placement,
)

REPO = Path(__file__).resolve().parents[1]


def agent_cr(parallelism=1, device_mesh=None, disk=False, options=None) -> AgentCustomResource:
    """``tests/test_k8s.py``'s Agent CR (typed, the JAX model)."""
    return AgentCustomResource(
        name="myapp-step1",
        namespace="langstream-t1",
        spec=AgentSpec(
            tenant="t1",
            application_id="myapp",
            agent_id="step1",
            image="langstream-tpu/runtime:latest",
            agent_config_secret_ref="myapp-step1-config",
            agent_config_secret_ref_checksum="abc123",
            resources=AgentResourcesCR(parallelism=parallelism, device_mesh=device_mesh),
            disk=DiskSpecCR(enabled=True, size="1G") if disk else None,
            options=options or {},
        ),
    )


@pytest.fixture
def registered(monkeypatch):
    """``serve_torch.register(device="cpu")`` with every process-global it
    touches restored afterwards (the operator's factory among them, or a
    later JAX k8s test would see the port's manifests)."""
    from langstream_tpu.agents import services
    from langstream_tpu.runtime import pod
    from langstream_tpu.serving import engine as jax_engine
    from langstream_tpu_torch.core import metrics as port_metrics
    from langstream_tpu_torch.core.tracing import SPANS
    from langstream_tpu_torch.serving.journey import JOURNEYS

    for module, names in ((jax_engine, serve_torch.POD_SEAM), (pod, serve_torch.SLICE_SEAM),
                          (k8s_operator, serve_torch.OPERATOR_SEAM)):
        for name in names:
            monkeypatch.setattr(module, name, getattr(module, name))
    monkeypatch.setattr(services, "_provider_factories", dict(services._provider_factories))
    monkeypatch.setattr(JOURNEYS, "mirror", JOURNEYS.mirror)
    monkeypatch.setattr(SPANS, "mirror", SPANS.mirror)
    monkeypatch.setattr(port_metrics, "REPORTER", port_metrics.REPORTER)
    monkeypatch.delenv("LS_ACCELERATOR", raising=False)
    serve_torch.register(device="cpu")


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accelerator,cards", [
    (name, cards) for name, topology in GPU_TOPOLOGIES.items()
    for cards in (1, 2, 4, 8) if cards <= topology.cards_per_host])
def test_gpu_placement_on_one_host(accelerator, cards):
    placement = gpu_placement(accelerator, cards)
    assert placement == {"hosts": 1, "cards_per_pod": cards,
                         "node_selector": GPU_TOPOLOGIES[accelerator].node_selector}


@pytest.mark.parametrize("accelerator,cards,hosts,per_pod", [
    ("h100", 16, 2, 8), ("h100-mega", 16, 2, 8), ("h100-gpu-operator", 16, 2, 8),
    ("h100-2g", 4, 2, 2), ("h100-2g", 8, 4, 2)])
def test_gpu_placement_of_a_slice(accelerator, cards, hosts, per_pod):
    placement = gpu_placement(accelerator, cards)
    assert (placement["hosts"], placement["cards_per_pod"]) == (hosts, per_pod)


@pytest.mark.parametrize("accelerator,cards,words", [
    ("h100", 12, r"no h100 placement for 12 cards; available: 1 to 8 on one host, "
                 r"or a multiple of 8 \(16, 24, \.\.\.\)"),
    ("h100-2g", 3, r"no h100-2g placement for 3 cards; available: 1 to 2 on one host"),
    ("a100", 4, r"unknown GPU accelerator 'a100'; known: \['h100', 'h100-2g', "
                r"'h100-gpu-operator', 'h100-mega'\]"),
    ("v5e", 4, r"unknown GPU accelerator 'v5e'; known: \['h100'"),
])
def test_gpu_placement_refusals_name_what_is_allowed(accelerator, cards, words):
    with pytest.raises(ValueError, match=words):
        gpu_placement(accelerator, cards)


def test_the_cards_each_entry_names_are_h100s():
    assert DEFAULT_ACCELERATOR == "h100"
    assert {t.card for t in GPU_TOPOLOGIES.values()} == {"NVIDIA H100 80GB HBM3"}
    assert GPU_TOPOLOGIES["h100-2g"].node_selector[
        "node.kubernetes.io/instance-type"] == "a3-highgpu-2g"


@pytest.mark.parametrize("name,want", [
    (None, "h100"), ("", "h100"), ("h100-mega", "h100-mega"), ("v5e", None),
    ("h100-mgea", None)])
def test_ls_accelerator_names_a_port_entry_or_is_refused(monkeypatch, name, want):
    monkeypatch.delenv("LS_ACCELERATOR", raising=False)
    if name is not None:
        monkeypatch.setenv("LS_ACCELERATOR", name)
    if want is not None:
        assert accelerator_from_env() == want
        return
    with pytest.raises(ValueError, match=rf"LS_ACCELERATOR='{name}' names no GPU the port "
                                         r"places on; set one of \['h100'"):
        accelerator_from_env()


# ---------------------------------------------------------------------------
# the manifests against the JAX factory's
# ---------------------------------------------------------------------------


PLACEMENT_KEYS = ("google.com/tpu", "nvidia.com/gpu")


def outside_placement(sts: dict) -> dict:
    """``sts`` without the keys the port places differently: the device
    resources, node selector, tolerations, ``/dev/shm``,
    ``LOCAL_WORLD_SIZE`` and the containers' commands."""
    sts = copy.deepcopy(sts)
    pod = sts["spec"]["template"]["spec"]
    pod.pop("nodeSelector", None)
    pod.pop("tolerations", None)
    pod["volumes"] = [v for v in pod["volumes"] if v["name"] != "dshm"]
    for container in pod["initContainers"] + pod["containers"]:
        container.pop("command")
        container["volumeMounts"] = [m for m in container["volumeMounts"]
                                     if m["name"] != "dshm"]
        container["env"] = [e for e in container.get("env", [])
                            if e["name"] != "LOCAL_WORLD_SIZE"]
        for part in ("requests", "limits"):
            values = container.get("resources", {}).get(part)
            if values is not None:
                for key in PLACEMENT_KEYS:
                    values.pop(key, None)
                if not values:
                    del container["resources"][part]
    return sts


# (name, CR kwargs, the JAX factory's accelerator, the mesh it gets, the
# port's accelerator): a slice is compared at meshes of as many hosts
CASES = {
    "cpu-agent": (dict(parallelism=3), "v5e", None, "h100"),
    "single-host": (dict(parallelism=2, device_mesh={"tp": 4}), "v5e", None, "h100"),
    "slice": (dict(parallelism=2, device_mesh={"tp": 16}), "v5e", {"tp": 8}, "h100"),
    "slice-2g": (dict(parallelism=1, device_mesh={"dp": 2, "tp": 2}), "v5e", {"tp": 8},
                 "h100-2g"),
    "disk-pvc": (dict(disk=True, device_mesh={"tp": 2}), "v5p", {"tp": 4}, "h100-mega"),
    "pool-roles": (dict(parallelism=2, device_mesh={"tp": 4},
                        options={"poolRoles": ["prefill", "decode"]}), "v5e", None, "h100"),
    "pool-roles-map": (dict(options={"poolRoles": {"prefill": 1, "decode": 3}}), "v5e", None,
                       "h100-gpu-operator"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_manifests_equal_the_jax_factorys_outside_the_placement(case):
    kwargs, jax_accel, jax_mesh, port_accel = CASES[case]
    cr = agent_cr(**kwargs)
    jax_cr = agent_cr(**{**kwargs, "device_mesh": jax_mesh or kwargs.get("device_mesh")})
    J, P = jax_resources.AgentResourcesFactory, AgentResourcesFactory
    want = J.generate_statefulsets(jax_cr, accelerator=jax_accel)
    got = P.generate_statefulsets(cr.to_dict(), accelerator=port_accel, device="cpu")
    assert [outside_placement(s) for s in got] == [outside_placement(s) for s in want]
    assert (P.generate_headless_service(cr.to_dict())
            == J.generate_headless_service(jax_cr))
    assert P.pool_roles(cr.to_dict()) == J.pool_roles(jax_cr)
    assert (P.generate_pod_disruption_budgets(cr.to_dict(), got)
            == J.generate_pod_disruption_budgets(jax_cr, want))
    mesh = kwargs.get("device_mesh")
    placement = gpu_placement(port_accel, _cards(mesh)) if mesh else None
    for sts in got:
        pod = sts["spec"]["template"]["spec"]
        runtime = pod["containers"][0]
        assert pod["initContainers"][0]["command"] == [
            "python", "-m", "serve_torch", "--device", "cpu", "pod",
            "agent-code-download", "/app-config/config", "/app-code-download"]
        assert runtime["command"] == [
            "python", "-m", "serve_torch", "--device", "cpu", "pod",
            "agent-runtime", "/app-config/config", "/app-code-download"]
        env = {e["name"]: e.get("value") for e in runtime["env"]}
        if placement is None:
            assert "nodeSelector" not in pod and "tolerations" not in pod
            assert "limits" not in runtime["resources"] and "LOCAL_WORLD_SIZE" not in env
            assert [v["name"] for v in pod["volumes"]] == [
                v["name"] for v in want[0]["spec"]["template"]["spec"]["volumes"]]
            continue
        cards = str(placement["cards_per_pod"])
        assert runtime["resources"]["limits"] == {"nvidia.com/gpu": cards}
        assert runtime["resources"]["requests"]["nvidia.com/gpu"] == cards
        assert pod["nodeSelector"] == GPU_TOPOLOGIES[port_accel].node_selector
        assert pod["tolerations"] == [
            {"key": "nvidia.com/gpu", "operator": "Exists", "effect": "NoSchedule"}]
        assert {"name": "dshm", "emptyDir": {"medium": "Memory"}} in pod["volumes"]
        assert {"name": "dshm", "mountPath": "/dev/shm"} in runtime["volumeMounts"]
        assert env["LOCAL_WORLD_SIZE"] == cards
        assert env["LS_SLICE_HOSTS"] == str(placement["hosts"])


def _cards(mesh) -> int:
    cards = 1
    for size in mesh.values():
        cards *= size
    return cards


def test_pool_roles_on_a_slice_are_refused_in_the_jax_words():
    cr = agent_cr(device_mesh={"tp": 16}, options={"poolRoles": ["prefill", "decode"]})
    with pytest.raises(ValueError) as jax_error:
        jax_resources.AgentResourcesFactory.generate_statefulsets(
            agent_cr(device_mesh={"tp": 8}, options={"poolRoles": ["prefill", "decode"]}))
    with pytest.raises(ValueError) as port_error:
        AgentResourcesFactory.generate_statefulsets(cr.to_dict())
    assert str(port_error.value) == str(jax_error.value)
    assert str(port_error.value).startswith("poolRoles is not supported on multi-host slices")


def test_the_port_factory_imports_neither_jax_nor_the_jax_package():
    code = ("import json, sys\n"
            "import langstream_tpu_torch.k8s, langstream_tpu_torch.k8s.resources\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "                        if m.split('.')[0] in ('jax', 'jaxlib', 'langstream_tpu'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=60, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == []


# ---------------------------------------------------------------------------
# the operator and the pod through serve_torch
# ---------------------------------------------------------------------------


def _reconciled(cr: AgentCustomResource) -> tuple[InMemoryKubeApi, dict]:
    api = InMemoryKubeApi()
    api.apply(cr.to_dict())
    return api, Operator(api, interval=0.01).reconcile_once()


def test_the_operator_writes_the_ports_statefulsets_after_register(registered):
    api, statuses = _reconciled(agent_cr(parallelism=2, device_mesh={"tp": 4}))
    assert statuses == {"agent/myapp-step1": "DEPLOYING"}
    sts = api.get("StatefulSet", "langstream-t1", "myapp-step1")
    pod = sts["spec"]["template"]["spec"]
    assert pod["containers"][0]["resources"]["limits"] == {"nvidia.com/gpu": "4"}
    assert pod["containers"][0]["command"][:6] == [
        "python", "-m", "serve_torch", "--device", "cpu", "pod"]
    assert pod["nodeSelector"] == GPU_TOPOLOGIES["h100"].node_selector
    assert api.get("PodDisruptionBudget", "langstream-t1", "myapp-step1")["spec"][
        "selector"] == sts["spec"]["selector"]
    assert api.get("Service", "langstream-t1", "myapp-step1")["spec"]["clusterIP"] == "None"
    assert k8s_operator.AgentResourcesFactory.with_port
    serve_torch.register(device="cuda")  # wraps once: the device stays the first's
    assert k8s_operator.AgentResourcesFactory.__wrapped__ is jax_resources.AgentResourcesFactory


def test_the_operator_places_a_2g_slice_from_ls_accelerator(registered, monkeypatch):
    monkeypatch.setenv("LS_ACCELERATOR", "h100-2g")
    api, _ = _reconciled(agent_cr(parallelism=2, device_mesh={"dp": 2, "tp": 2}))
    for i in range(2):
        sts = api.get("StatefulSet", "langstream-t1", f"myapp-step1-r{i}")
        env = {e["name"]: e.get("value")
               for e in sts["spec"]["template"]["spec"]["containers"][0]["env"]}
        assert sts["spec"]["replicas"] == 2
        assert (env["LS_SLICE_HOSTS"], env["LOCAL_WORLD_SIZE"]) == ("2", "2")
        assert env["LS_COORDINATOR_ADDRESS"] == f"myapp-step1-r{i}-0.myapp-step1:8476"
        assert env["LS_LOGICAL_REPLICA"] == str(i)
    assert len(api.list("PodDisruptionBudget", "langstream-t1")) == 2


def test_a_tpu_ls_accelerator_fails_the_reconcile_in_the_ports_words(registered, monkeypatch):
    monkeypatch.setenv("LS_ACCELERATOR", "v5e")
    api, statuses = _reconciled(agent_cr(device_mesh={"tp": 4}))
    assert statuses["agent/myapp-step1"].startswith(
        "RETRY: LS_ACCELERATOR='v5e' names no GPU the port places on; set one of ['h100'")
    assert api.get("StatefulSet", "langstream-t1", "myapp-step1") is None
    with pytest.raises(ValueError, match="LS_ACCELERATOR='v5e' names no GPU"):
        serve_torch.main(["--device", "cpu", "operator"])  # before the loop starts


def test_without_register_the_operator_keeps_the_jax_factory():
    assert k8s_operator.AgentResourcesFactory is jax_resources.AgentResourcesFactory
    api, _ = _reconciled(agent_cr(device_mesh={"tp": 4}))
    pod = api.get("StatefulSet", "langstream-t1", "myapp-step1")["spec"]["template"]["spec"]
    assert pod["containers"][0]["resources"]["limits"] == {"google.com/tpu": "4"}
    assert pod["containers"][0]["command"][:3] == ["python", "-m", "langstream_tpu.runtime.pod"]


def test_the_pod_subcommand_runs_the_platforms_pod_entrypoint(registered, tmp_path, caplog):
    caplog.set_level("INFO")
    config = tmp_path / "config"
    config.write_text(json.dumps({"tenant": "t1"}))
    with pytest.raises(SystemExit) as info:
        serve_torch.main(["--device", "cpu", "pod", "agent-code-download", str(config),
                          str(tmp_path / "code")])
    assert info.value.code == 0
    assert "no code archive configured" in caplog.text
    with pytest.raises(SystemExit) as info:
        serve_torch.main(["--device", "cpu", "pod", "no-such-command"])
    assert info.value.code == 2


# ---------------------------------------------------------------------------
# the process kubelet runs the port's 2 x 2 slice from its manifests
# ---------------------------------------------------------------------------

SLICE_PIPELINE = """
topics:
  - name: "questions"
    creation-mode: create-if-not-exists
  - name: "answers"
    creation-mode: create-if-not-exists
pipeline:
  - name: "chat"
    id: "chat"
    type: "ai-chat-completions"
    input: "questions"
    output: "answers"
    resources:
      device-mesh: {dp: 2, tp: 2}
    configuration:
      model: "tiny"
      completion-field: "value.answer"
      max-tokens: 8
      temperature: 0
      messages:
        - role: user
          content: "{{ value.question }}"
"""
SLICE_RESOURCE = {"model": "tiny", "model-dtype": "float32", "slots": 4, "max-seq-len": 128,
                  "decode-chunk": 4, "kv-layout": "paged", "kv-block-size": 16, "seed": 0,
                  "mesh": {"dp": 2, "tp": 2}}


@pytest.mark.parametrize("accelerator,cards,words", [
    ("h100", 2, r"mesh \{'dp': 2, 'tp': 2\} needs 4 devices, have 2"),
    ("h100-2g", 8, r"spans 4 ranks, but a slice of 4 hosts x 2 local ranks has 8")])
def test_a_manifest_whose_ranks_disagree_with_the_mesh_is_refused_at_the_pods_start(
        monkeypatch, accelerator, cards, words):
    """The agent's device mesh sizes the pods, the resource's mesh the
    engine: a pod whose manifest gives it other ranks than the resource's
    mesh spans is refused by the launcher before any rank starts."""
    from langstream_tpu_torch.parallel import launch
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    (sts,) = AgentResourcesFactory.generate_statefulsets(
        agent_cr(device_mesh={"tp": cards}).to_dict(), accelerator=accelerator, device="cpu")
    for var in sts["spec"]["template"]["spec"]["containers"][0]["env"]:
        monkeypatch.setenv(var["name"], var.get("value", f"{sts['metadata']['name']}-0"))
    with pytest.raises(ValueError, match=words):
        TorchServingEngine(ServingConfig.from_dict(SLICE_RESOURCE), device="cpu")
    assert launch._WORLD is None


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _slice_kubelet(api, root):
    """The process kubelet with the two things a cluster gives a pod that
    processes on one host lack: the headless service's names resolve (to
    127.0.0.1, where every pod listens) and each pod has an address of its
    own for its info server (here a port of its own, ``LS_HTTP_PORT``)."""
    from langstream_tpu.k8s.kubelet import ProcessKubelet

    class SliceKubelet(ProcessKubelet):
        http_ports: dict[str, int] = {}

        def _container_env(self, pod, container):
            env = super()._container_env(pod, container)
            coordinator = env.get("LS_COORDINATOR_ADDRESS")
            if coordinator:
                env["LS_COORDINATOR_ADDRESS"] = "127.0.0.1:" + coordinator.rsplit(":", 1)[1]
            env["LS_HTTP_PORT"] = str(self.http_ports.setdefault(pod.name, _free_port()))
            return env

    return SliceKubelet(api, root=root, env_extra={
        "PYTHONPATH": str(REPO), "LS_TORCH_COLLECTIVE_TIMEOUT_S": "60"})


def _get_json(url: str, timeout: float = 60.0) -> dict:
    deadline = time.monotonic() + timeout
    while True:
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                return json.loads(r.read())
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)


def test_the_process_kubelet_runs_the_ports_2x2_slice_from_its_manifests(
        registered, monkeypatch, tmp_path):
    import yaml

    from langstream_tpu.api.record import make_record
    from langstream_tpu.core.deployer import ApplicationDeployer
    from langstream_tpu.core.parser import build_application_from_files
    from langstream_tpu.k8s.cluster_runtime import KubernetesClusterRuntime
    from langstream_tpu.native import BrokerProcess
    from langstream_tpu.runtime.tsb import TsbTopicConnectionsRuntime

    monkeypatch.setenv("LS_ACCELERATOR", "h100-2g")
    broker = BrokerProcess().start()
    kubelet = None
    try:
        instance = yaml.safe_dump({"instance": {"streamingCluster": {
            "type": "tpustream", "configuration": {"bootstrap": f"127.0.0.1:{broker.port}"}}}})
        configuration = yaml.safe_dump({"configuration": {"resources": [{
            "type": "tpu-serving-configuration", "name": "tiny",
            "configuration": SLICE_RESOURCE}]}})
        app = build_application_from_files(
            {"pipeline.yaml": SLICE_PIPELINE, "configuration.yaml": configuration}, instance)
        plan = ApplicationDeployer().create_implementation("myapp", app)
        asyncio.run(ApplicationDeployer().setup(plan))  # the topics, as the setup Job
        api = InMemoryKubeApi()
        api.apply({"apiVersion": "v1", "kind": "Namespace",
                   "metadata": {"name": "langstream-t1"}})
        KubernetesClusterRuntime(api).deploy("t1", plan)
        Operator(api).reconcile_once()
        (sts,) = api.list("StatefulSet", "langstream-t1")
        assert sts["spec"]["replicas"] == 2
        env = {e["name"]: e.get("value")
               for e in sts["spec"]["template"]["spec"]["containers"][0]["env"]}
        assert (env["LS_SLICE_HOSTS"], env["LOCAL_WORLD_SIZE"]) == ("2", "2")

        kubelet = _slice_kubelet(api, tmp_path / "kubelet")
        kubelet.reconcile_once()  # both pods started; nothing restarts them
        pods = {p.name: p for p in kubelet.pods.values()}
        leader, follower = pods[f"{sts['metadata']['name']}-0"], pods[
            f"{sts['metadata']['name']}-1"]

        async def ask():
            rt = TsbTopicConnectionsRuntime()
            rt.init({"bootstrap": f"127.0.0.1:{broker.port}"})
            producer = rt.create_producer("test", {"topic": "questions"})
            await producer.start()
            await producer.write(make_record(value={"question": "hello slice"}))
            reader = rt.create_reader({"topic": "answers"}, "earliest")
            await reader.start()
            deadline = time.monotonic() + 150
            while time.monotonic() < deadline:
                for pod in (leader, follower):
                    assert pod.proc.poll() is None, pod.log_path.read_text()[-3000:]
                got = await reader.read(timeout=0.5)
                if got:
                    return got[0]
            raise AssertionError("no answer; the leader's log ends: "
                                 + leader.log_path.read_text()[-3000:])

        answer = asyncio.run(ask())
        assert answer.value["question"] == "hello slice" and "answer" in answer.value
        info = _get_json(f"http://127.0.0.1:{kubelet.http_ports[follower.name]}/info")
        assert info["role"] == "slice-follower" and (info["ordinal"], info["hosts"]) == (1, 2)

        # as a kubelet stops a container: SIGTERM to the leader's main process
        leader.proc.send_signal(signal.SIGTERM)
        for pod in (leader, follower):
            try:
                pod.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                pytest.fail(f"pod {pod.name} did not end: "
                            + pod.log_path.read_text()[-3000:])
            assert pod.proc.returncode == 0, pod.log_path.read_text()[-3000:]
        leader_log = leader.log_path.read_text()
        assert "langstream_tpu_torch.parallel.launch" in leader_log  # the port's world
    finally:
        if kubelet is not None:
            kubelet.stop()
        broker.stop()

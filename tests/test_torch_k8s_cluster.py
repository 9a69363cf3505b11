"""The port's cluster modules against the JAX package's, on one application
(mini-chat with a device mesh on its chat agent, a code store, a tiny
resource):

- ``crds`` (the typed CRs round trip to the same dicts), ``podconfig``
  (each agent's pod configuration, and the (plan, node) it rebuilds) and
  ``cluster_runtime`` (the Agent CRs and their config Secrets, a redeploy's
  prune, a delete) write what the JAX modules write;
- the port's ``Operator`` makes the Jobs and StatefulSets the JAX operator
  makes with the port's factory (``serve_torch.OPERATOR_SEAM``), the Jobs'
  commands apart (the port's pod entrypoint on its device);
- an application stored by one package's ``KubernetesApplicationStore``
  reads back equal in the other's, tenants too, and the port's store
  refuses a name that is not one path segment;
- ``KubernetesComputeRuntime.deploy``/``undeploy`` of one stored app write
  the same objects in both packages; the port's ``pod_address`` reaches a
  pod where the cluster's DNS name would not (the process kubelet gives
  each StatefulSet pod a port of its own);
- the autoscaler's ``StatefulSetFleetBackend`` scales as the JAX one does.
"""

import asyncio
import json
from pathlib import Path

import pytest
import yaml

import serve_torch
from langstream_tpu.controlplane.stores import StoredApplication as JaxStored
from langstream_tpu.core.deployer import ApplicationDeployer as JaxDeployer
from langstream_tpu.core.parser import build_application_from_files as jax_build
from langstream_tpu.k8s import operator as k8s_operator
from langstream_tpu.k8s.client import InMemoryKubeApi as JaxApi
from langstream_tpu.k8s.cluster_runtime import KubernetesClusterRuntime as JaxRuntime
from langstream_tpu.k8s.compute import KubernetesComputeRuntime as JaxCompute
from langstream_tpu.k8s.crds import AgentCustomResource as JaxAgentCR
from langstream_tpu.k8s.crds import ApplicationCustomResource as JaxAppCR
from langstream_tpu.k8s.podconfig import plan_and_node as jax_plan_and_node
from langstream_tpu.k8s.podconfig import pod_configuration as jax_pod_configuration
from langstream_tpu.k8s.stores import KubernetesApplicationStore as JaxStore
from langstream_tpu_torch.controlplane.stores import StoredApplication
from langstream_tpu_torch.core.deployer import ApplicationDeployer
from langstream_tpu_torch.core.parser import build_application_from_files
from langstream_tpu_torch.k8s.client import InMemoryKubeApi
from langstream_tpu_torch.k8s.cluster_runtime import KubernetesClusterRuntime
from langstream_tpu_torch.k8s.compute import KubernetesComputeRuntime
from langstream_tpu_torch.k8s.crds import AgentCustomResource, ApplicationCustomResource
from langstream_tpu_torch.k8s.operator import Operator
from langstream_tpu_torch.k8s.podconfig import plan_and_node, pod_configuration
from langstream_tpu_torch.k8s.stores import KubernetesApplicationStore

REPO = Path(__file__).resolve().parents[1]
APP = REPO / "examples" / "applications" / "mini-chat"
IMAGE = "langstream-tpu/runtime-torch:latest"
NS = "langstream-t1"


def app_files() -> dict[str, str]:
    pipeline = yaml.safe_load((APP / "pipeline.yaml").read_text())
    (chat,) = [a for a in pipeline["pipeline"] if a["type"] == "ai-chat-completions"]
    chat["resources"] = {"device-mesh": {"tp": 1}}
    return {"pipeline.yaml": yaml.safe_dump(pipeline),
            "gateways.yaml": (APP / "gateways.yaml").read_text(),
            "configuration.yaml": (APP / "configuration.yaml").read_text()}


INSTANCE = yaml.safe_dump({"instance": {"streamingCluster": {
    "type": "memory", "configuration": {}}, "globals": {"g": 1}}})


def plans():
    files = app_files()
    jax_plan = JaxDeployer().create_implementation(
        "mini", jax_build(files, INSTANCE, None))
    port_plan = ApplicationDeployer().create_implementation(
        "mini", build_application_from_files(files, INSTANCE, None))
    return jax_plan, port_plan


def test_pod_configurations_and_rebuilt_nodes_equal_the_jax_ones():
    jax_plan, port_plan = plans()
    assert sorted(port_plan.agents) == sorted(jax_plan.agents) and len(port_plan.agents) == 2
    for agent_id in jax_plan.agents:
        want = jax_pod_configuration(jax_plan, jax_plan.agents[agent_id])
        got = pod_configuration(port_plan, port_plan.agents[agent_id])
        assert got == want
        _, jax_node = jax_plan_and_node(json.loads(json.dumps(want)))
        plan, node = plan_and_node(json.loads(json.dumps(got)))
        assert (node.id, node.agent_type, node.component_type, node.configuration) == (
            jax_node.id, jax_node.agent_type, jax_node.component_type, jax_node.configuration)
        assert node.resources.device_mesh == jax_node.resources.device_mesh
        assert plan.application.instance.globals_ == {"g": 1}


def _objects(api) -> dict:
    return {key: {k: v for k, v in obj.items() if k != "metadata"} | {
        "metadata": {k: v for k, v in obj["metadata"].items() if k != "uid"}}
            for key, obj in api.objects.items()}


def test_cluster_runtime_writes_the_jax_crs_and_secrets():
    jax_plan, port_plan = plans()
    jax_api, api = JaxApi(), InMemoryKubeApi()
    storage = {"type": "local", "path": "/code"}
    jax_crs = JaxRuntime(jax_api, image=IMAGE, code_storage=storage).deploy(
        "t1", jax_plan, "mini-abc")
    crs = KubernetesClusterRuntime(api, image=IMAGE, code_storage=storage).deploy(
        "t1", port_plan, "mini-abc")
    assert [cr.to_dict() for cr in crs] == [cr.to_dict() for cr in jax_crs]
    assert _objects(api) == _objects(jax_api) and api.events == jax_api.events
    for cr in crs:  # the typed CRs round trip in both packages
        assert AgentCustomResource.from_dict(cr.to_dict()).to_dict() == JaxAgentCR.from_dict(
            cr.to_dict()).to_dict()
    # a redeploy without the chat step prunes its CR and Secret in both
    files = app_files()
    pipeline = yaml.safe_load(files["pipeline.yaml"])
    pipeline["pipeline"] = pipeline["pipeline"][:1]
    pipeline["pipeline"][0]["output"] = "answers-topic"
    files["pipeline.yaml"] = yaml.safe_dump(pipeline)
    jax_small = JaxDeployer().create_implementation("mini", jax_build(files, INSTANCE, None))
    small = ApplicationDeployer().create_implementation(
        "mini", build_application_from_files(files, INSTANCE, None))
    JaxRuntime(jax_api, image=IMAGE).deploy("t1", jax_small)
    KubernetesClusterRuntime(api, image=IMAGE).deploy("t1", small)
    assert _objects(api) == _objects(jax_api) and len(api.list("Agent", NS)) == 1
    JaxRuntime(jax_api).delete("t1", jax_small)
    KubernetesClusterRuntime(api).delete("t1", small)
    assert api.objects == {} and api.events == jax_api.events


@pytest.fixture
def registered(monkeypatch):
    """``serve_torch.register(device="cpu")`` with every process-global it
    touches restored afterwards (as ``tests/test_torch_k8s.py``'s)."""
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


def _stored_app_cr(tenant="t1"):
    return ApplicationCustomResource.from_dict({
        "apiVersion": "langstream.tpu/v1alpha1", "kind": "Application",
        "metadata": {"name": "mini", "namespace": NS},
        "spec": {"tenant": tenant, "image": IMAGE, "codeArchiveId": None, "options": {},
                 "application": json.dumps({"files": app_files(), "instance": INSTANCE})}})


def _normalized_jobs(api) -> dict:
    jobs = {}
    for job in api.list("Job", NS):
        job = json.loads(json.dumps(job))
        job["metadata"].pop("uid", None)
        (container,) = job["spec"]["template"]["spec"]["containers"]
        command = container.pop("command")
        jobs[job["metadata"]["name"]] = (job, command)
    return jobs


def test_the_operator_makes_the_jax_operators_jobs_and_statefulsets(registered):
    jax_api, api = JaxApi(), InMemoryKubeApi()
    for kube in (jax_api, api):
        kube.apply({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}})
        kube.apply(_stored_app_cr().to_dict())
    jax_op = k8s_operator.Operator(jax_api)
    port_op = Operator(api, device="cpu")
    assert port_op.reconcile_once() == jax_op.reconcile_once() == {"app/mini": "DEPLOYING"}
    # the setup Job's pod succeeds, then the deployer's: the same statuses
    for step in ("setup", "deployer"):
        for kube in (jax_api, api):
            (job,) = [j for j in kube.list("Job", NS) if step in j["metadata"]["name"]]
            kube.update_status({**job, "status": {"succeeded": 1}})
        assert port_op.reconcile_once() == jax_op.reconcile_once()
    assert api.get("Application", NS, "mini")["status"] == {"status": "DEPLOYED",
                                                             "reason": "deployed"}
    jax_jobs, jobs = _normalized_jobs(jax_api), _normalized_jobs(api)
    assert sorted(jobs) == sorted(jax_jobs) and len(jobs) == 2
    for name, (job, command) in jobs.items():
        want, jax_command = jax_jobs[name]
        assert job == want
        assert jax_command[:3] == ["python", "-m", "langstream_tpu.runtime.pod"]
        assert command == ["python", "-m", "serve_torch", "--device", "cpu", "pod"] + (
            jax_command[3:])
    secrets = [kube.get("Secret", NS, "mini-app-config") for kube in (api, jax_api)]
    assert [(s["data"], s["metadata"]["labels"]) for s in secrets] == [
        (secrets[1]["data"], secrets[1]["metadata"]["labels"])] * 2
    # the deployer Job's work: Agent CRs, reconciled into the port's pods
    jax_plan, port_plan = plans()
    JaxRuntime(jax_api, image=IMAGE).deploy("t1", jax_plan)
    KubernetesClusterRuntime(api, image=IMAGE).deploy("t1", port_plan)
    statuses = port_op.reconcile_once()
    assert statuses == jax_op.reconcile_once()
    for kind in ("StatefulSet", "Service", "PodDisruptionBudget"):
        got = {o["metadata"]["name"]: o for o in api.list(kind, NS)}
        want = {o["metadata"]["name"]: o for o in jax_api.list(kind, NS)}
        assert sorted(got) == sorted(want) and got
        for name in got:
            for obj in (got[name], want[name]):
                obj["metadata"].pop("uid", None)
                for ref in obj["metadata"].get("ownerReferences", []):
                    ref.pop("uid")
            assert got[name] == want[name], (kind, name)
    limits = [s["spec"]["template"]["spec"]["containers"][0]["resources"].get("limits")
              for s in api.list("StatefulSet", NS)]
    assert sorted(limits, key=bool) == [None, {"nvidia.com/gpu": "1"}]
    # the delete path: the deployer Job with ``delete``, then the Jobs and
    # the config Secret go
    cr = api.get("Application", NS, "mini")
    assert port_op.apps.cleanup(cr) == "DELETING"
    (job,) = [j for j in api.list("Job", NS) if "deployer-delete" in j["metadata"]["name"]]
    assert job["spec"]["template"]["spec"]["containers"][0]["command"][-3:] == [
        "deployer-runtime", "delete", "/app-config/config"]
    api.update_status({**job, "status": {"succeeded": 1}})
    assert port_op.apps.cleanup(cr) == "DELETED"
    assert api.list("Job", NS) == [] and api.get("Secret", NS, "mini-app-config") is None


def test_the_operator_refuses_a_tpu_accelerator_before_its_loop(monkeypatch):
    monkeypatch.setenv("LS_ACCELERATOR", "v5e")
    with pytest.raises(ValueError, match="LS_ACCELERATOR='v5e' names no GPU"):
        Operator(InMemoryKubeApi())
    with pytest.raises(ValueError, match="unknown GPU accelerator 'v5p'"):
        Operator(InMemoryKubeApi(), accelerator="v5p")
    monkeypatch.delenv("LS_ACCELERATOR")
    assert Operator(InMemoryKubeApi()).agents.accelerator == "h100"


STORES = {"jax": (JaxStore, JaxApi, JaxStored), "port": (KubernetesApplicationStore,
                                                          InMemoryKubeApi, StoredApplication)}


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_stored_app_reads_back_equal_in_the_other_package(writer, reader):
    write_store, api_cls, stored_cls = STORES[writer]
    read_store = STORES[reader][0]
    api = api_cls()
    store = write_store(api, runtime_image=IMAGE, code_storage_config={"type": "local"})
    store.put_tenant("t1", {"max-units": 4})
    app = stored_cls(tenant="t1", name="mini", files=app_files(), instance=INSTANCE,
                     secrets="secrets: []\n", status="DEPLOYED", created_at=12.5, units=2)
    app.code_archive_id = "mini-abc"
    store.put_application(app)
    other = read_store(api)
    got = other.get_application("t1", "mini")
    assert (got.files, got.instance, got.secrets, got.status, got.created_at, got.units) == (
        app.files, app.instance, app.secrets, "DEPLOYED", 12.5, 2)
    assert other.list_tenants() == {"t1": {"max-units": 4}}
    assert other.list_applications("t1") == ["mini"]
    cr = api.get("Application", NS, "mini")
    assert (ApplicationCustomResource.from_dict(cr).to_dict()
            == JaxAppCR.from_dict(cr).to_dict())
    other.delete_application("t1", "mini")
    assert store.get_application("t1", "mini") is None


@pytest.mark.parametrize("tenant,name", [("t1", "../x"), ("..", "mini"), ("t/1", "mini"),
                                         ("t1", ".hidden")])
def test_the_ports_kube_store_refuses_names_that_are_not_one_segment(tenant, name):
    store = KubernetesApplicationStore(InMemoryKubeApi())
    with pytest.raises(ValueError, match="illegal (tenant|application) name"):
        store.put_tenant(tenant)
        store.put_application(StoredApplication(tenant=tenant, name=name, files={}))


COMPUTES = {"jax": (JaxCompute, JaxApi, JaxStored), "port": (KubernetesComputeRuntime,
                                                              InMemoryKubeApi, StoredApplication)}


def _deployed(side, tmp_path):
    compute_cls, api_cls, stored_cls = COMPUTES[side]
    api = api_cls()
    api.apply({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": NS}})
    storage = {"type": "local", "path": str(tmp_path / side / "code")}
    compute = compute_cls(api, image=IMAGE, code_storage_config=storage)
    stored = stored_cls(tenant="t1", name="mini", files=app_files(), instance=INSTANCE)
    asyncio.run(compute.deploy(stored))
    return api, compute, stored


def test_compute_deploy_and_undeploy_write_the_jax_objects(tmp_path):
    jax_api, jax_compute, jax_stored = _deployed("jax", tmp_path)
    api, compute, stored = _deployed("port", tmp_path)
    assert stored.code_archive_id == jax_stored.code_archive_id
    want = _objects(jax_api)
    got = _objects(api)
    # the Secrets carry the code store's path, one per package here
    for objs, side in ((want, "jax"), (got, "port")):
        for obj in objs.values():
            if obj["kind"] == "Secret":
                config = json.loads(__import__("base64").b64decode(obj["data"]["config"]))
                assert config["codeStorage"]["path"] == str(tmp_path / side / "code")
                config["codeStorage"]["path"] = "/code"
                obj["data"] = config
            if obj["kind"] == "Agent":
                obj["spec"].pop("agentConfigSecretRefChecksum")
    assert got == want
    assert compute.agent_info("t1", "mini") == jax_compute.agent_info("t1", "mini")
    asyncio.run(jax_compute.undeploy("t1", "mini"))
    asyncio.run(compute.undeploy("t1", "mini"))
    assert api.list("Agent", NS) == jax_api.list("Agent", NS) == []
    assert api.events == jax_api.events


def test_pod_address_reaches_a_pod_instead_of_the_cluster_name(tmp_path):
    api, compute, _ = _deployed("port", tmp_path)
    from langstream_tpu_torch.k8s.kubelet import ProcessKubelet

    Operator(api, device="cpu").reconcile_once()
    names = sorted(s["metadata"]["name"] for s in api.list("StatefulSet", NS))
    assert compute._pod_addresses("t1", "mini") == {
        f"{n}-0": f"http://{n}-0.{n}.{NS}.svc:8080" for n in names}
    from langstream_tpu_torch.k8s.kubelet import _Pod

    kubelet = ProcessKubelet(api, root=tmp_path / "kubelet")
    ports = {}
    for name, kind in ((f"{names[0]}-0", "StatefulSet"), ("setup-job", "Job")):
        pod = _Pod(name=name, namespace=NS, kind=kind, owner=name, template_hash="h")
        pod.root = tmp_path / "kubelet" / "pods" / NS / name
        pod.root.mkdir(parents=True)
        env = kubelet._container_env(pod, {"env": []})
        assert kubelet._container_env(pod, {"env": []}).get("LS_HTTP_PORT") == env.get(
            "LS_HTTP_PORT")  # kept across a restart
        ports[name] = env.get("LS_HTTP_PORT")
    chat = f"{names[0]}-0"
    assert ports["setup-job"] is None and ports[chat] != "8080"
    assert (tmp_path / "kubelet" / "pods" / NS / chat / "http-port").read_text() == ports[chat]
    compute.pod_address = kubelet.pod_address
    addresses = compute._pod_addresses("t1", "mini")
    assert addresses[chat] == f"http://127.0.0.1:{ports[chat]}"
    assert addresses[f"{names[1]}-0"] == f"http://{names[1]}-0.{names[1]}.{NS}.svc:8080"


def test_the_autoscalers_statefulset_backend_scales_as_the_jax_one(tmp_path, registered):
    """``StatefulSetFleetBackend`` (the k8s control plane's autoscaler
    backend) resolves the same StatefulSet and patches the same replica
    count and annotation in both packages, and the port's operator keeps
    the autoscaled count on its next reconcile; a pod that does not answer
    observes as an ``unreachable`` member and drains as gone."""
    import socket

    from langstream_tpu.k8s.compute import StatefulSetFleetBackend as JaxBackend
    from langstream_tpu_torch.k8s.compute import StatefulSetFleetBackend

    jax_api, jax_compute, _ = _deployed("jax", tmp_path)
    api, compute, _ = _deployed("port", tmp_path)
    k8s_operator.Operator(jax_api).reconcile_once()
    operator = Operator(api, device="cpu")
    operator.reconcile_once()
    spec = type("Spec", (), {"agent": "chat", "pool": None})()
    jax_backend, backend = JaxBackend(jax_compute, "t1", "mini", spec), StatefulSetFleetBackend(
        compute, "t1", "mini", spec)
    assert backend.resolve() == jax_backend.resolve() == "mini-chat"
    jax_backend.set_replicas(3)
    backend.set_replicas(3)
    for kube in (api, jax_api):
        sts = kube.get("StatefulSet", NS, "mini-chat")
        assert sts["spec"]["replicas"] == 3
        assert sts["metadata"]["annotations"] == {"langstream.tpu/autoscale": "true"}
    operator.reconcile_once()
    assert api.get("StatefulSet", NS, "mini-chat")["spec"]["replicas"] == 3
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        closed = sock.getsockname()[1]
    compute.pod_address = lambda ns, pod: f"http://127.0.0.1:{closed}"
    observed = backend.observe()
    assert [o["replica"] for o in observed] == [f"mini-chat-{i}" for i in range(3)]
    assert all(o["unreachable"] for o in observed)
    assert backend.drain("mini-chat-0", 1.0) is None

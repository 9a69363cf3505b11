"""The port's install (``deploy/torch/``): the manifests and the Helm chart
that ``tools/render_deploy_torch.py`` renders from the platform's documents,
the compose stack, and ``serve_torch.py``'s ``controlplane`` subcommand.

- The committed ``deploy/torch/k8s/`` and ``deploy/torch/helm/langstream-tpu-torch/``
  are byte-equal to a fresh render.
- In what is rendered, the operator runs ``python -m serve_torch --device
  cuda operator``, the control plane ``... controlplane`` and the gateway
  ``python -m langstream_tpu_torch.gateway``, with an ``LS_ACCELERATOR`` the port's
  ``accelerator_from_env`` accepts; every Deployment runs the port image,
  and the control plane stamps it into Agent CRs (``LS_RUNTIME_IMAGE``);
  the namespace, CRDs and RBAC are the platform's, byte for byte; the
  chart's templates stay valid YAML once values are substituted (as
  ``tests/test_k8s.py`` holds the platform's chart).
- The compose file's control plane runs ``serve_torch ... controlplane``
  in ``LS_MODE: local`` with one GPU reserved, beside the port's tsbroker
  and gateway.
- ``python -m serve_torch controlplane`` runs the port's own control plane
  on its ``--device``, registering nothing in the platform.
"""

import filecmp
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

import serve_torch
from langstream_tpu_torch.k8s.resources import accelerator_from_env

REPO = Path(__file__).resolve().parent.parent
DEPLOY = REPO / "deploy" / "torch"
IMAGE = "langstream-tpu/runtime-torch:latest"
OPERATOR = ["python", "-m", "serve_torch", "--device", "cuda", "operator"]


def _render(tmp_path: Path, *args: str) -> Path:
    out = tmp_path / ("chart" if "--helm" in args else "k8s")
    subprocess.run([sys.executable, str(REPO / "tools" / "render_deploy_torch.py"), *args,
                    "--out", str(out)], check=True, capture_output=True, cwd=tmp_path)
    return out


def _tree(root: Path) -> list[Path]:
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def _deployments(docs: dict[str, list[dict]]) -> dict[str, dict]:
    return {d["metadata"]["name"]: d["spec"]["template"]["spec"]["containers"][0]
            for ds in docs.values() for d in ds if d["kind"] == "Deployment"}


def _env(container: dict) -> dict:
    return {v["name"]: v.get("value") for v in container["env"]}


@pytest.mark.parametrize("kind", ["plain", "helm"])
def test_the_committed_tree_equals_a_fresh_render(kind, tmp_path):
    """Every file of ``deploy/torch/k8s/`` (plain) or of the chart (helm)
    byte for byte, and no file more or less."""
    rendered = _render(tmp_path, *(["--helm"] if kind == "helm" else []))
    committed = DEPLOY / ("k8s" if kind == "plain" else "helm/langstream-tpu-torch")
    assert _tree(rendered) == _tree(committed)
    for rel in _tree(rendered):
        assert filecmp.cmp(rendered / rel, committed / rel, shallow=False), str(rel)


def test_the_manifests_install_the_port(tmp_path, monkeypatch):
    """The operator's command and placement, the port image everywhere,
    the control plane's ``LS_RUNTIME_IMAGE``; the namespace, CRDs and RBAC
    the platform's."""
    out = _render(tmp_path)
    docs = {p.name: list(yaml.safe_load_all(p.read_text())) for p in sorted(out.glob("*.yaml"))}
    containers = _deployments(docs)
    assert set(containers) == {"langstream-control-plane", "langstream-api-gateway",
                               "langstream-operator"}
    assert {c["image"] for c in containers.values()} == {IMAGE}
    operator = containers["langstream-operator"]
    assert operator["command"] == OPERATOR
    assert containers["langstream-control-plane"]["command"] == OPERATOR[:-1] + [
        "controlplane"]
    assert containers["langstream-api-gateway"]["command"] == [
        "python", "-m", "langstream_tpu_torch.gateway"]
    monkeypatch.setenv("LS_ACCELERATOR", _env(operator)["LS_ACCELERATOR"])
    assert accelerator_from_env() == "h100"
    control = _env(containers["langstream-control-plane"])
    assert control["LS_RUNTIME_IMAGE"] == IMAGE and control["LS_MODE"] == "k8s"
    for name in ("00-namespace.yaml", "01-crds.yaml", "02-rbac.yaml"):
        assert filecmp.cmp(out / name, REPO / "deploy" / "k8s" / name, shallow=False), name


def test_the_charts_templates_substitute_to_valid_yaml(tmp_path, monkeypatch):
    """The chart's values default to the port image and ``h100``; with
    values substituted as a minimal ``helm template`` does, every template
    is valid YAML whose Deployments run the given image, the operator the
    port's command with the given accelerator, which the port accepts."""
    out = _render(tmp_path, "--helm")
    chart = yaml.safe_load((out / "Chart.yaml").read_text())
    assert chart["apiVersion"] == "v2" and chart["name"] == "langstream-tpu-torch"
    values = yaml.safe_load((out / "values.yaml").read_text())
    assert (values["image"], values["accelerator"]) == (IMAGE, "h100")
    crds = list(yaml.safe_load_all((out / "crds" / "01-crds.yaml").read_text()))
    assert {c["kind"] for c in crds} == {"CustomResourceDefinition"}
    subs = {"{{ .Release.Namespace }}": "test-ns", "{{ .Values.image | quote }}": '"img:1"',
            "{{ .Values.image }}": "img:1", "{{ .Values.accelerator | quote }}": '"h100-2g"'}
    kinds = set()
    for template in sorted((out / "templates").glob("*.yaml")):
        if template.name == "06-config.yaml":
            continue  # flow control: rendered only by helm itself
        body = template.read_text()
        for needle, value in subs.items():
            body = body.replace(needle, value)
        assert "{{" not in body, f"unsubstituted expression in {template.name}"
        for doc in yaml.safe_load_all(body):
            kinds.add(doc["kind"])
            assert doc["metadata"].get("namespace", "test-ns") == "test-ns"
            if doc["kind"] != "Deployment":
                continue
            container = doc["spec"]["template"]["spec"]["containers"][0]
            assert container["image"] == "img:1"
            env = _env(container)
            if "LS_RUNTIME_IMAGE" in env:
                assert env["LS_RUNTIME_IMAGE"] == "img:1"
            if doc["metadata"]["name"] == "langstream-operator":
                assert container["command"] == OPERATOR
                monkeypatch.setenv("LS_ACCELERATOR", env["LS_ACCELERATOR"])
                assert accelerator_from_env() == "h100-2g"
    assert {"Deployment", "Service", "ClusterRole"} <= kinds and "Namespace" not in kinds


def test_the_compose_stack_runs_the_control_plane_through_the_port():
    """The control plane is ``serve_torch ... controlplane`` in local mode on
    one reserved GPU; the broker is the port's tsbroker and the gateway the
    port's, every service on the port image."""
    compose = yaml.safe_load((DEPLOY / "docker-compose.yaml").read_text())
    services = compose["services"]
    assert set(services) == {"tsbroker", "control-plane", "api-gateway"}
    control = services["control-plane"]
    command = control["command"]
    assert command[:3] == ["python", "-m", "serve_torch"] and command[-1] == "controlplane"
    assert command[command.index("--device") + 1] == "cuda"
    assert control["environment"]["LS_MODE"] == "local"
    (device,) = control["deploy"]["resources"]["reservations"]["devices"]
    assert device["count"] == 1 and device["capabilities"] == ["gpu"]
    assert services["api-gateway"]["command"] == ["python", "-m", "langstream_tpu_torch.gateway"]
    assert "langstream_tpu_torch.native import" in services["tsbroker"]["command"]
    assert all(s["image"].endswith(IMAGE + "}") for s in services.values())


def test_the_controlplane_subcommand_registers_the_port_first(monkeypatch):
    """``serve_torch.main([... "controlplane"])`` runs the port's own control
    plane (``langstream_tpu_torch.controlplane``) on the given device, before
    anything registers: the platform's provider registry is left as it is."""
    from langstream_tpu.agents import services
    from langstream_tpu_torch.controlplane import __main__ as port_controlplane

    before = dict(services._provider_factories)
    seen = []

    async def control_plane(device):
        seen.append(device)
        return 0

    monkeypatch.setattr(port_controlplane, "main", control_plane)
    with pytest.raises(SystemExit) as info:
        serve_torch.main(["--device", "cpu", "controlplane"])
    assert info.value.code == 0 and seen == ["cpu"]
    assert services._provider_factories == before

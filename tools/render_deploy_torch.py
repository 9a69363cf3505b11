"""Render the install of the PyTorch port into ``deploy/torch/k8s/`` and,
with ``--helm``, its Helm chart into ``deploy/torch/helm/langstream-tpu-torch/``.

    python tools/render_deploy_torch.py            # plain manifests (kubectl apply)
    python tools/render_deploy_torch.py --helm     # Helm chart (helm install)
    python tools/render_deploy_torch.py [--helm] --out DIR

The documents are the platform's (``tools/render_deploy.py``'s
``render_documents``: the namespace, the CRDs, the RBAC, the control plane
and the API gateway, unchanged) with only what makes the install the
port's:

- the operator runs ``python -m serve_torch --device cuda operator``, so
  its Agent CRs become the port's StatefulSets on H100 node pools
  (``langstream_tpu_torch/k8s/resources.py``), each pod started as
  ``python -m serve_torch --device cuda pod ...``;
- ``LS_ACCELERATOR`` is the port's default placement, ``h100``
  (``DEFAULT_ACCELERATOR``; any entry of ``GPU_TOPOLOGIES`` is accepted);
- every Deployment runs the port's image, and the control plane stamps it
  into every Agent CR (``LS_RUNTIME_IMAGE``), so the agent pods run it too.

The chart is made from the same documents, templated as the platform's
chart is (namespace, image and accelerator from values; the CRDs under
``crds/``; the optional ``langstream-config`` ConfigMap). The output is
checked in; ``tests/test_torch_deploy.py`` keeps it equal to this renderer.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import yaml

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
_spec = importlib.util.spec_from_file_location("render_deploy", REPO / "tools" / "render_deploy.py")
platform = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(platform)

from langstream_tpu_torch.k8s.resources import DEFAULT_ACCELERATOR  # noqa: E402

OUT = REPO / "deploy" / "torch" / "k8s"
HELM_OUT = REPO / "deploy" / "torch" / "helm" / "langstream-tpu-torch"

IMAGE = "langstream-tpu/runtime-torch:latest"
OPERATOR_COMMAND = ["python", "-m", "serve_torch", "--device", "cuda", "operator"]
CHART_VERSION = platform.CHART_VERSION


def _ported(doc: dict) -> dict:
    """A platform document with the port's image, operator command and
    placement."""
    if doc.get("kind") != "Deployment":
        return doc
    container = doc["spec"]["template"]["spec"]["containers"][0]
    container["image"] = IMAGE
    if doc["metadata"]["name"] == "langstream-operator":
        container["command"] = list(OPERATOR_COMMAND)
    for var in container["env"]:
        if var["name"] == "LS_RUNTIME_IMAGE":
            var["value"] = IMAGE
        elif var["name"] == "LS_ACCELERATOR":
            var["value"] = DEFAULT_ACCELERATOR
    return doc


def render_documents() -> dict[str, list[dict]]:
    """filename -> manifest documents of the port's install."""
    return {name: [_ported(doc) for doc in docs]
            for name, docs in platform.render_documents().items()}


def write_plain(out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    for name, docs in render_documents().items():
        (out / name).write_text(yaml.safe_dump_all(docs, sort_keys=False))
        print(f"wrote {platform._rel(out)}/{name} ({len(docs)} documents)")


_NOTES = """\
langstream-tpu with the PyTorch port installed into namespace {{ .Release.Namespace }}.

Control plane:  http://langstream-control-plane.{{ .Release.Namespace }}:8090
API gateway:    ws://langstream-api-gateway.{{ .Release.Namespace }}:8091

The operator places agent pods on {{ .Values.accelerator }} GPU node pools; each
pod runs `python -m serve_torch --device cuda pod ...` in {{ .Values.image }}.

RBAC note: ClusterRole/ClusterRoleBinding names are fixed (tenant
namespaces are created dynamically, so grants are cluster-scoped): install
one release per cluster, this chart or the platform's, not both.
"""


def _helm_template(doc_yaml: str) -> str:
    """The platform chart's substitutions, for the port's image and
    placement."""
    out = doc_yaml.replace(f"namespace: {platform.NAMESPACE}",
                           "namespace: {{ .Release.Namespace }}")
    out = out.replace(f"image: {IMAGE}", "image: {{ .Values.image }}")
    out = out.replace(f"value: {IMAGE}", "value: {{ .Values.image | quote }}")
    return out.replace(f"value: {DEFAULT_ACCELERATOR}\n",
                       "value: {{ .Values.accelerator | quote }}\n")


def write_helm(out: Path) -> None:
    templates, crds = out / "templates", out / "crds"
    templates.mkdir(parents=True, exist_ok=True)
    crds.mkdir(parents=True, exist_ok=True)
    (out / "Chart.yaml").write_text(yaml.safe_dump({
        "apiVersion": "v2",
        "name": "langstream-tpu-torch",
        "description": "Event-driven LLM streaming platform served by the PyTorch/CUDA "
                       "port on H100 node pools (control plane, api-gateway, operator)",
        "type": "application",
        "version": CHART_VERSION,
        "appVersion": CHART_VERSION,
    }, sort_keys=False))
    (out / "values.yaml").write_text(
        "# Install-time configuration. accelerator: one of the port's GPU_TOPOLOGIES\n"
        "# entries (langstream_tpu_torch/k8s/resources.py). See\n"
        "# deploy/k8s/values-example.yaml for a worked codeStorage example.\n"
        + yaml.safe_dump({"image": IMAGE, "accelerator": DEFAULT_ACCELERATOR,
                          "codeStorage": None, "adminAuth": None}, sort_keys=False))
    for name, docs in render_documents().items():
        if name == "00-namespace.yaml":
            continue  # helm install --create-namespace owns it
        body = yaml.safe_dump_all(docs, sort_keys=False)
        if name == "01-crds.yaml":
            (crds / name).write_text(body)
        else:
            (templates / name).write_text(_helm_template(body))
    (templates / "06-config.yaml").write_text(platform._CONFIG_TEMPLATE)
    (templates / "NOTES.txt").write_text(_NOTES)
    print(f"wrote helm chart under {platform._rel(out)}/")


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--helm", action="store_true",
                    help="render the Helm chart instead of plain manifests")
    ap.add_argument("--out", default=None, help="override the output directory")
    args = ap.parse_args(argv)
    if args.helm:
        write_helm(Path(args.out) if args.out else HELM_OUT)
    else:
        write_plain(Path(args.out) if args.out else OUT)


if __name__ == "__main__":
    main()

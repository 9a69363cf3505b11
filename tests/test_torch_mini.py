"""``python -m serve_torch --device cpu mini up --once``: the one-command
local cluster deploys through the whole k8s path (Application CR -> setup
and deployer Jobs -> Agent CRs -> the port's StatefulSets, run by the
process kubelet) and its chat agent serves through the port.

The application is the mini-chat example with a device mesh on its chat
agent (``{tp: 1}``, one card), so its StatefulSet is placed as a GPU pod:
read from mini's API server while the cluster is up, it asks for one
``nvidia.com/gpu`` and starts ``python -m serve_torch --device cpu pod``.
The answer comes from the port's engine: the chat pod's log names its
modules, and none of the JAX engine's.
"""

import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import yaml

REPO = Path(__file__).resolve().parents[1]


def test_mini_up_once_serves_through_the_port(tmp_path):
    from langstream_tpu.k8s.client import HttpKubeApi

    app = tmp_path / "app"
    shutil.copytree(REPO / "examples" / "applications" / "mini-chat", app)
    pipeline = yaml.safe_load((app / "pipeline.yaml").read_text())
    (chat,) = [a for a in pipeline["pipeline"] if a["type"] == "ai-chat-completions"]
    chat["resources"] = {"device-mesh": {"tp": 1}}
    (app / "pipeline.yaml").write_text(yaml.safe_dump(pipeline))

    data = tmp_path / "mini"
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("LS_ACCELERATOR", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "serve_torch", "--device", "cpu", "mini", "up", "--once",
         "-app", str(app), "--data-dir", str(data), "--api-port", "0",
         "--gateway-port", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: list[str] = []
    statefulsets: dict[str, dict] = {}  # by name, as last read

    def watch_the_cluster():
        """Read mini's output; once its API server is up, keep the agents'
        StatefulSets as the operator wrote them."""
        api = None
        for line in proc.stdout:
            lines.append(line)
            if api is None and "kube API server" in line:
                api = HttpKubeApi(line.split()[-1])
                threading.Thread(target=poll, args=(api,), daemon=True).start()

    def poll(api):
        while proc.poll() is None:
            try:
                for sts in api.list("StatefulSet", "langstream-default"):
                    statefulsets[sts["metadata"]["name"]] = sts
            except Exception:  # the server is going away, or not a namespace yet
                pass
            time.sleep(0.2)

    reader = threading.Thread(target=watch_the_cluster, daemon=True)
    reader.start()
    try:
        proc.wait(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(10)
    out = "".join(lines)
    assert proc.returncode == 0, out[-4000:]
    assert "smoke chat answered" in out, out[-4000:]

    # the chat agent on one card; the agent before it without a mesh
    placed = {}
    for name, sts in statefulsets.items():
        runtime = sts["spec"]["template"]["spec"]["containers"][0]
        assert runtime["command"][:6] == ["python", "-m", "serve_torch", "--device", "cpu",
                                          "pod"]
        placed[name] = runtime["resources"].get("limits")
    (sts,) = [statefulsets[n] for n, limits in placed.items() if limits]
    assert sorted(placed.values(), key=bool) == [None, {"nvidia.com/gpu": "1"}]
    pods = data / "kubelet" / "pods" / "langstream-default"
    names = [p.name for p in pods.iterdir()]
    assert any("setup" in n for n in names) and any("deployer" in n for n in names), names
    log = (pods / f"{sts['metadata']['name']}-0" / "pod.log").read_text()
    assert "langstream_tpu_torch.serving.engine" in log, log[-3000:]
    assert "langstream_tpu.serving.engine" not in log, log[-3000:]

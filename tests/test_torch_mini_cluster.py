"""The cluster path without JAX, as a whole: ``python -m
langstream_tpu_torch.cli mini up --once --device cpu`` stands up the kube
API server, the control plane in k8s mode, the operator, the process
kubelet, the tpustream broker and the standalone gateway, deploys mini-chat
(its resource the tiny Llama of ``tests/fixtures/llama_tiny_golden`` in f32,
greedy) into pods and answers one chat message through the gateway; the
streamed answer equals the JAX ``LocalApplicationRunner``'s answer on the
same application and checkpoint, text for text. Every process of the
cluster (mini, the broker, the Jobs' and the agents' pods) runs with an
import system that refuses JAX, the JAX package, PyYAML, aiohttp, click and
cryptography (a ``sitecustomize`` on the ``PYTHONPATH`` mini hands its
pods), and none tried to load one. ``serve_torch.py``'s ``pod``,
``operator``, ``controlplane`` and ``mini`` subcommands run under the same
guard."""

import ast
import asyncio
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import yaml

REPO = Path(__file__).resolve().parents[1]
APP = REPO / "examples" / "applications" / "mini-chat"
FIXTURE = str(REPO / "tests" / "fixtures" / "llama_tiny_golden")
QUESTION = "hello mini cluster"  # what ``mini up --once`` asks
REFUSED = ("jax", "jaxlib", "langstream_tpu", "yaml", "aiohttp", "click", "cryptography")
SITE = textwrap.dedent(f"""
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

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


def _app(root: Path) -> Path:
    app = root / "app"
    app.mkdir()
    (app / "gateways.yaml").write_text((APP / "gateways.yaml").read_text())
    pipeline = yaml.safe_load((APP / "pipeline.yaml").read_text())
    (chat,) = [a for a in pipeline["pipeline"] if a["type"] == "ai-chat-completions"]
    chat["configuration"]["temperature"] = 0
    chat["resources"] = {"device-mesh": {"tp": 1}}
    (app / "pipeline.yaml").write_text(yaml.safe_dump(pipeline))
    (app / "configuration.yaml").write_text(yaml.safe_dump({"configuration": {"resources": [{
        "type": "tpu-serving-configuration", "name": "tpu", "configuration": {
            "model": "tiny", "model-dtype": "float32", "checkpoint": FIXTURE, "slots": 4,
            "max-seq-len": 256, "decode-chunk": 4, "decode-chunk-light": 2}}]}}))
    return app


def _guarded_env(root: Path) -> dict:
    site = root / "site"
    site.mkdir(exist_ok=True)
    (site / "sitecustomize.py").write_text(SITE)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join((str(site), str(REPO))),
           "PYTHONUNBUFFERED": "1", "HOME": str(root / "home")}
    env.pop("LS_ACCELERATOR", None)
    env.pop("JAX_PLATFORMS", None)
    return env


def _jax_answer(app: Path) -> str:
    from langstream_tpu.runtime.local_runner import LocalApplicationRunner
    from langstream_tpu.serving.engine import TpuServingEngine

    async def main():
        runner = LocalApplicationRunner.from_directory(app, instance=yaml.safe_dump(
            {"instance": {"streamingCluster": {"type": "memory"}}}))
        async with runner:
            await runner.produce("questions-topic", QUESTION,
                                 headers={"langstream-client-session-id": "s"})
            (answer,) = await runner.wait_for_messages("answers-topic", 1, timeout=120)
            chunks = await runner.wait_for_messages("stream-topic", 1, timeout=10)
        engines = list(TpuServingEngine._instances.values())
        TpuServingEngine.reset_instances()
        for engine in engines:
            await engine.close()
        return answer.value["answer"], chunks

    answer, chunks = asyncio.run(main())
    assert chunks
    return answer


def test_mini_up_once_answers_as_the_jax_runner_with_nothing_of_jax(tmp_path):
    app = _app(tmp_path)
    data = tmp_path / "data"
    out = subprocess.run(
        [sys.executable, "-m", "langstream_tpu_torch.cli", "mini", "up", "--once",
         "--device", "cpu", "-app", str(app), "--data-dir", str(data),
         "--api-port", "0", "--gateway-port", "0"],
        cwd=tmp_path, env=_guarded_env(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-5000:])
    (line,) = [ln for ln in out.stdout.splitlines() if "smoke chat answered" in ln]
    streamed = ast.literal_eval(line.split(": ", 1)[1])
    assert "stopped" in out.stdout.splitlines()[-1]
    pods = data / "kubelet" / "pods" / "langstream-default"
    names = sorted(p.name for p in pods.iterdir())
    assert any("setup" in n for n in names) and any("deployer" in n for n in names), names
    logs = {p.parent.name: p.read_text() for p in pods.glob("*/pod.log")}
    assert len(logs) == 4, sorted(logs)  # two Jobs, two agents
    for text in [out.stderr, *logs.values()]:
        assert "refused" not in text, text[-3000:]
    chat_log = next(t for n, t in logs.items() if n.startswith("mini-chat-chat-"))
    assert "langstream_tpu_torch.pod engine drain reports: {'tiny'" in chat_log
    assert streamed and streamed == _jax_answer(app)


def _run_guarded(tmp_path, argv, env_extra=None, timeout=120):
    script = tmp_path / "entry.py"
    script.write_text(textwrap.dedent(f"""
        import sys

        import serve_torch

        serve_torch.main({argv!r})
    """))
    env = {**_guarded_env(tmp_path), **(env_extra or {})}
    return subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_serve_torch_cluster_subcommands_run_without_jax(tmp_path):
    config = tmp_path / "config"
    config.write_text(json.dumps({"tenant": "t1"}))
    out = _run_guarded(tmp_path, ["--device", "cpu", "pod", "agent-code-download",
                                  str(config), str(tmp_path / "code")])
    assert out.returncode == 0 and "no code archive configured" in out.stderr, out.stderr
    out = _run_guarded(tmp_path, ["--device", "cpu", "pod", "nope"])
    assert out.returncode == 2 and "unknown command 'nope'" in out.stderr
    out = _run_guarded(tmp_path, ["--device", "cpu", "operator"], {"LS_ACCELERATOR": "v5e"})
    assert out.returncode == 1 and "LS_ACCELERATOR='v5e' names no GPU" in out.stderr
    out = _run_guarded(tmp_path, ["--device", "cpu", "controlplane"], {"LS_MODE": "bogus"})
    assert out.returncode == 2 and "unknown LS_MODE 'bogus'" in out.stderr
    out = _run_guarded(tmp_path, ["--device", "cpu", "mini", "up", "--once",
                                  "--data-dir", str(tmp_path / "m")],
                       {"LS_ACCELERATOR": "v5e"})
    assert out.returncode == 1 and "mini cluster failed: LS_ACCELERATOR='v5e'" in out.stderr
    for text in (out.stdout, out.stderr):
        assert "import of" not in text

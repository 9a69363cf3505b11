"""The port's per-application interpreter isolation
(``langstream_tpu_torch/runtime/isolation.py``) and the CLI commands on it
(``python install-requirements``, ``python run-tests``), and ``apps ui``,
against the JAX package's:

- the two isolation cases of ``tests/test_pravega_admin_isolation.py``: an
  app without requirements runs on the base interpreter; one with a
  ``python/requirements.txt`` gets its own venv, and a second call returns
  the same interpreter and leaves the marker as it was;
- a wheel made by hand (a zip with ``METADATA``, ``WHEEL`` and ``RECORD``)
  in ``python/wheels/`` installed with ``--no-index``: the venv imports its
  module, the base interpreter cannot; under ``LS_VENV_ROOT`` each app gets
  a venv of its own;
- ``python install-requirements`` and ``python run-tests`` through the
  port's CLI as processes: the interpreter printed as the JAX CLI prints
  it, pytest's exit codes 0 and 1 carried through, a missing ``python/``
  refused;
- ``apps ui --once --no-open`` serves bytes equal to the JAX
  ``app_ui.html`` and prints the JAX CLI's URL for the same arguments.
"""

import http.client
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

from langstream_tpu_torch.runtime import isolation

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import z_wheel  # noqa: E402  (path Z4's wheel, zipped by hand)

WHEEL_MODULE = "lsiso_marker"


def write_wheel(directory: Path, value: str = "from-the-wheel") -> Path:
    return z_wheel(directory, name=WHEEL_MODULE, value=value)


def _env(home: Path) -> dict:
    env = dict(os.environ, HOME=str(home), PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1")
    env.pop("LS_VENV_ROOT", None)
    return env


def test_app_without_requirements_uses_base_interpreter(tmp_path):
    assert isolation.ensure_app_interpreter(None) == sys.executable
    (tmp_path / "python").mkdir()
    assert isolation.ensure_app_interpreter(tmp_path) == sys.executable


def test_app_with_requirements_gets_own_venv(tmp_path):
    """An app pinning requirements gets its own interpreter; re-calls are
    idempotent until the requirements change."""
    (tmp_path / "python").mkdir()
    reqs = tmp_path / "python" / "requirements.txt"
    reqs.write_text("")  # no packages: provisions the venv without network
    interpreter = isolation.ensure_app_interpreter(tmp_path)
    assert interpreter != sys.executable
    assert Path(interpreter).exists()
    assert str(tmp_path) in interpreter
    marker = tmp_path / ".venv" / ".requirements.sha256"
    stamp = marker.read_text()
    # idempotent: same interpreter, marker untouched
    assert isolation.ensure_app_interpreter(tmp_path) == interpreter
    assert marker.read_text() == stamp


def test_a_hand_made_wheel_installs_offline_into_each_app_venv(tmp_path, monkeypatch):
    apps = []
    for n in (1, 2):
        app = tmp_path / f"app{n}"
        write_wheel(app / "python" / "wheels", value=f"v{n}")
        (app / "python" / "requirements.txt").write_text(f"{WHEEL_MODULE.replace('_', '-')}\n")
        apps.append(app)
    monkeypatch.setenv("LS_VENV_ROOT", str(tmp_path / "venvs"))
    interpreters = [isolation.ensure_app_interpreter(app) for app in apps]
    assert len(set(interpreters)) == 2  # one venv per application under the root
    assert all(str(tmp_path / "venvs") in i for i in interpreters)
    probe = (f"import {WHEEL_MODULE}, sys; "
             f"print({WHEEL_MODULE}.VALUE, sys.prefix != sys.base_prefix)")
    for n, interpreter in enumerate(interpreters, 1):
        out = subprocess.run([interpreter, "-c", probe], capture_output=True, text=True,
                             timeout=60)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.split() == [f"v{n}", "True"]
    base = subprocess.run([sys.executable, "-c", f"import {WHEEL_MODULE}"],
                          capture_output=True, text=True, timeout=60)
    assert base.returncode != 0 and "ModuleNotFoundError" in base.stderr
    # the parent environment's packages resolve in the venv (the .pth)
    numpy = subprocess.run([interpreters[0], "-c", "import numpy, pytest"],
                           capture_output=True, text=True, timeout=60)
    assert numpy.returncode == 0, numpy.stderr[-2000:]


def _cli(side: str, args: list[str], home: Path, timeout: float = 240):
    module = "langstream_tpu_torch.cli" if side == "port" else "langstream_tpu.cli"
    return subprocess.run([sys.executable, "-m", module, *args], env=_env(home), cwd=home,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_python_install_requirements_and_run_tests(tmp_path):
    app = tmp_path / "app"
    code = app / "python"
    write_wheel(code / "wheels")
    (code / "requirements.txt").write_text(f"{WHEEL_MODULE.replace('_', '-')}\n")
    (code / "test_app_agent.py").write_text(
        f"import {WHEEL_MODULE}\n\n\ndef test_ok():\n    assert {WHEEL_MODULE}.VALUE\n")
    out = _cli("port", ["python", "install-requirements", "-app", str(app)], tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    interpreter = out.stdout.split()[-1]
    assert interpreter == str(app / ".venv" / "bin" / "python")
    jax = _cli("jax", ["python", "install-requirements", "-app", str(app)], tmp_path)
    assert (jax.returncode, jax.stdout) == (0, out.stdout)  # the same venv, kept

    passed = _cli("port", ["python", "run-tests", "-app", str(app), "-q", "-p",
                           "no:cacheprovider"], tmp_path)
    assert passed.returncode == 0, passed.stdout[-2000:] + passed.stderr[-2000:]
    assert "1 passed" in passed.stdout
    (code / "test_app_agent.py").write_text("def test_fails():\n    assert False\n")
    failed = _cli("port", ["python", "run-tests", "-app", str(app), "-q", "-p",
                           "no:cacheprovider"], tmp_path)
    assert failed.returncode == 1 and "1 failed" in failed.stdout

    bare = tmp_path / "bare"
    bare.mkdir()
    out = _cli("port", ["python", "install-requirements", "-app", str(bare)], tmp_path)
    assert out.returncode == 0
    assert out.stdout.splitlines() == ["no python/requirements.txt: sidecars use the base "
                                       "interpreter", sys.executable]
    out = _cli("port", ["python", "run-tests", "-app", str(bare)], tmp_path)
    assert out.returncode == 1 and f"Error: {bare} has no python/ directory" in out.stderr
    out = _cli("port", ["python", "run-tests", "-app", str(tmp_path / "nope")], tmp_path)
    assert out.returncode == 2


def _serve_ui(side: str, args: list[str], home: Path) -> tuple[str, bytes | None, int]:
    module = "langstream_tpu_torch.cli" if side == "port" else "langstream_tpu.cli"
    proc = subprocess.Popen([sys.executable, "-m", module, "apps", "ui", *args],
                            env=_env(home), cwd=home, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("chat UI: "), (line, proc.stderr.read()
                                               if proc.poll() is not None else "")
        try:
            with urllib.request.urlopen(line.removeprefix("chat UI: "), timeout=30) as answer:
                body = answer.read()
        except (OSError, http.client.HTTPException):
            # the JAX CLI handles the request on a daemon thread, and a
            # ``--once`` process may exit before it answers, or mid-answer
            if side == "port":
                raise
            body = None
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
    return line, body, proc.returncode


@pytest.mark.parametrize("extra", [[], ["--tenant", "t1", "--gateway", "chat2",
                                        "--gateway-url", "ws://127.0.0.1:9999"]],
                         ids=["defaults", "every-option"])
def test_apps_ui_serves_the_jax_page_and_url(tmp_path, extra):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = ["myapp", "--port", str(port), "--no-open", "--once", *extra]
    port_line, port_body, port_rc = _serve_ui("port", args, tmp_path)
    jax_line, jax_body, jax_rc = _serve_ui("jax", args, tmp_path)
    page = (REPO / "langstream_tpu" / "cli" / "app_ui.html").read_bytes()
    assert port_body == page and jax_body in (None, page)
    assert port_line == jax_line and f"127.0.0.1:{port}/?tenant=" in port_line
    assert port_rc == jax_rc == 0

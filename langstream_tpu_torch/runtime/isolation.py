"""Per-application dependency isolation — the NAR-classloader answer (the
port's copy of ``langstream_tpu/runtime/isolation.py``).

The reference packages each agent family as a NAR with an isolated
classloader (``NarFileHandler.java:44,123``), so one agent's dependencies
cannot clash with another's. The Python-native equivalent here is a
**venv-per-application** policy for sidecar agents:

- An application that ships a ``python/requirements.txt`` gets its own venv
  (created with ``--system-site-packages`` so torch & friends resolve from the
  base image) under ``<app>/.venv`` (or ``LS_VENV_ROOT``). Its pinned deps
  install into that venv only.
- Sidecar agents (the gRPC lane) for that application run on the venv's
  interpreter, so conflicting pins between two applications never meet in
  one process. In-process agents always see only the base environment —
  declaring requirements forces the sidecar lane, which is the policy:
  isolation happens at the process boundary, exactly where the reference
  puts its classloader boundary.
- Offline installs: a shipped ``python/wheels/`` directory is used as the
  pip ``--find-links`` source with ``--no-index`` (this image has no
  network egress; in-cluster deployments may allow an index via
  ``LS_PIP_ARGS``).

``ensure_app_interpreter`` is idempotent and cheap when the venv already
matches the requirements file (content hash marker).
"""

from __future__ import annotations

import hashlib
import logging
import os
import subprocess
import sys
from pathlib import Path

log = logging.getLogger(__name__)


def requirements_file(app_dir: str | Path) -> Path | None:
    for candidate in ("python/requirements.txt", "requirements.txt"):
        path = Path(app_dir) / candidate
        if path.is_file():
            return path
    return None


def ensure_app_interpreter(app_dir: str | Path | None) -> str:
    """Return the interpreter path sidecars of this application must run on:
    the app venv's python when the app pins requirements, else the current
    interpreter. Creates/updates the venv as needed."""
    if not app_dir:
        return sys.executable
    reqs = requirements_file(app_dir)
    if reqs is None:
        return sys.executable
    venv_root = os.environ.get("LS_VENV_ROOT")
    if venv_root:
        # a shared root still gets one venv PER APPLICATION — keyed by the
        # app path — or two apps' conflicting pins would fight over one venv
        app_key = hashlib.sha256(
            str(Path(app_dir).resolve()).encode()
        ).hexdigest()[:16]
        venv_dir = Path(venv_root) / f"venv-{app_key}"
    else:
        venv_dir = Path(app_dir) / ".venv"
    python = venv_dir / "bin" / "python"
    marker = venv_dir / ".requirements.sha256"
    digest = hashlib.sha256(reqs.read_bytes()).hexdigest()
    if python.exists() and marker.exists() and marker.read_text() == digest:
        return str(python)
    log.info("provisioning app venv at %s (requirements changed)", venv_dir)
    if venv_dir.exists():
        # changed requirements rebuild from scratch: an in-place reinstall
        # would leave packages dropped from the pin list behind, making the
        # environment diverge from a fresh deploy of the same app
        import shutil

        shutil.rmtree(venv_dir)
    subprocess.run(
        [sys.executable, "-m", "venv", "--system-site-packages", str(venv_dir)],
        check=True,
    )
    # --system-site-packages exposes the BASE interpreter's site dirs, but
    # this runtime usually runs inside a venv itself (whose site dir the
    # child venv cannot see). A .pth makes the parent environment's packages
    # resolvable; path order keeps the app venv's own pins winning.
    import site

    parent_sites = [p for p in site.getsitepackages() if Path(p).is_dir()]
    for child_site in venv_dir.glob("lib/python*/site-packages"):
        (child_site / "_langstream_parent_env.pth").write_text(
            "\n".join(parent_sites) + "\n"
        )
    pip_args = [str(python), "-m", "pip", "install", "-r", str(reqs)]
    wheels = Path(app_dir) / "python" / "wheels"
    if wheels.is_dir():
        pip_args += ["--no-index", "--find-links", str(wheels)]
    extra = os.environ.get("LS_PIP_ARGS")
    if extra:
        pip_args += extra.split()
    result = subprocess.run(pip_args, capture_output=True, text=True)
    if result.returncode != 0:
        raise RuntimeError(
            f"app venv install failed for {reqs}:\n{result.stderr[-2000:]}"
        )
    marker.write_text(digest)
    return str(python)

"""Native components: build + process management for the tpustream broker
(the port's copy of ``langstream_tpu/native/__init__.py``).

The C++ broker (``tsbroker.cc``, the port's own copy of the JAX package's
source) is compiled on demand with ``g++ -std=c++17 -O2`` into the
git-ignored ``build/langstream_tpu_torch/tsbroker/`` at the repository root
(``LS_TORCH_BUILD_DIR`` moves the whole build tree, the kernels' too), at
first use; a content-hash keyed cache makes rebuilds automatic when the
source changes. A failed build raises :class:`NativeBuildError` with the
compiler's error.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
BROKER_SOURCE = _HERE / "tsbroker.cc"


def _bin_dir() -> Path:
    env = os.environ.get("LS_TORCH_BUILD_DIR")
    root = Path(env) if env else _HERE.parents[1] / "build" / "langstream_tpu_torch"
    return root / "tsbroker"


class NativeBuildError(RuntimeError):
    pass


def toolchain_available() -> bool:
    return shutil.which("g++") is not None


def ensure_broker_binary() -> Path:
    """Compile (or reuse a cached) tsbroker binary; returns its path."""
    source = BROKER_SOURCE.read_bytes()
    digest = hashlib.sha256(source).hexdigest()[:16]
    bin_dir = _bin_dir()
    binary = bin_dir / f"tsbroker-{digest}"
    if binary.exists():
        return binary
    if not toolchain_available():
        raise NativeBuildError("g++ not found; cannot build tsbroker")
    bin_dir.mkdir(parents=True, exist_ok=True)
    # Build to a temp name then rename: concurrent builds race benignly
    # (the temp name is not a cached build's, so the prune below leaves a
    # concurrent build's output alone).
    fd, tmp = tempfile.mkstemp(prefix=".build-tsbroker-", dir=bin_dir)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", "-std=c++17", "-O2", "-o", tmp, str(BROKER_SOURCE)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise NativeBuildError(f"tsbroker build failed:\n{proc.stderr}")
        os.chmod(tmp, 0o755)
        os.replace(tmp, binary)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    # Prune stale cached builds.
    for old in bin_dir.glob("tsbroker-*"):
        if old != binary:
            try:
                old.unlink()
            except OSError:
                pass
    return binary


class BrokerProcess:
    """Launches a tsbroker subprocess and reports its port.

    Used by the dev-mode runner (the reference's embedded Kafka/Kraft in the
    runtime-tester image, ``langstream-runtime-tester/src/main/docker/
    Dockerfile:23-40``) and by tests.
    """

    def __init__(self, port: int = 0, data_dir: str | None = None,
                 host: str = "127.0.0.1"):
        self.host = host
        self._requested_port = port
        self.data_dir = data_dir
        self.port: int | None = None
        self.proc: subprocess.Popen | None = None

    def start(self) -> "BrokerProcess":
        binary = ensure_broker_binary()
        cmd = [str(binary), "--host", self.host, "--port",
               str(self._requested_port)]
        if self.data_dir:
            cmd += ["--data-dir", self.data_dir]
        self.proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True
        )
        line = self.proc.stdout.readline().strip()
        if not line.startswith("LISTENING "):
            self.stop()
            raise NativeBuildError(f"tsbroker failed to start: {line!r}")
        self.port = int(line.split()[1])
        return self

    def stop(self) -> None:
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            self.proc = None

    def __enter__(self) -> "BrokerProcess":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

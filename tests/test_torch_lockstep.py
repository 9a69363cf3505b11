"""The port's lockstep plane (``langstream_tpu_torch/serving/lockstep.py``)
against the JAX package's.

- The frames: every op kind the port's engine broadcasts encodes to the
  bytes ``langstream_tpu.serving.lockstep.encode_descriptor`` gives the same
  descriptor, and the port decodes the JAX package's frames.
- The fail-loud promises of ``tests/test_lockstep.py``: a rejected token, a
  rejected late joiner, ``LockstepBroken`` once a follower died, the engine
  failing its in-flight requests and stopping, a follower leaving promptly
  when its leader dies, and (two processes) a follower killed mid-burst.
- The refusals under a multi-rank mesh, and ``serve_torch.register``
  pointing the pod's two slice functions at the port's once.

:func:`spawn_world` runs a ``torch.distributed`` world of the port's
``lockstep_demo`` on the CPU (gloo); ``tests/test_torch_tp.py`` uses it too.
Every subprocess has a timeout, so a hang fails one test.
"""

import asyncio
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from langstream_tpu.serving import lockstep as jax_lockstep
from langstream_tpu_torch.serving import lockstep as port_lockstep
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
from langstream_tpu_torch.serving.lockstep import (
    LockstepBroken,
    LockstepFollower,
    LockstepLeader,
    encode_descriptor,
    read_frame,
)

REPO = Path(__file__).resolve().parents[1]
TINY = {"model": "tiny", "model-dtype": "float32", "slots": 4, "max-seq-len": 64,
        "decode-chunk": 4}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(tmp_path, n: int, configs: list[dict], *, prompts=None,
                max_tokens: int = 6, env: dict | None = None,
                rank_env: dict | None = None):
    """Start ``n`` ranks of ``python -m langstream_tpu_torch.serving.lockstep_demo``
    on the CPU, serving ``configs`` one after the other in one world.
    Returns the processes and their ``--out`` paths; ``rank_env`` maps a
    rank to extra environment (fault injection)."""
    coordinator, lockstep = free_port(), free_port()
    base = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
            "LS_TORCH_COLLECTIVE_TIMEOUT_S": "60", **(env or {})}
    base.pop("JAX_PLATFORMS", None)
    procs, outs = [], []
    for i in range(n):
        out = tmp_path / f"rank{i}.json"
        cmd = [sys.executable, "-m", "langstream_tpu_torch.serving.lockstep_demo",
               "--index", str(i), "--num-processes", str(n),
               "--coordinator-port", str(coordinator), "--lockstep-port", str(lockstep),
               "--device", "cpu", "--config", json.dumps(configs),
               "--max-tokens", str(max_tokens), "--out", str(out)]
        if prompts is not None:
            cmd += ["--prompts", json.dumps(prompts)]
        # stderr to a file: a full pipe would stall a rank, and its peers
        # with it inside a collective
        with open(tmp_path / f"rank{i}.log", "wb") as log:
            proc = subprocess.Popen(
                cmd, cwd=REPO, env={**base, **(rank_env or {}).get(i, {})},
                stdout=subprocess.DEVNULL, stderr=log)
        proc.log_path = tmp_path / f"rank{i}.log"
        procs.append(proc)
        outs.append(out)
    return procs, outs


def join_world(procs, timeout: float = 180.0) -> list[tuple[int, str]]:
    """Wait for every rank (killing all of them past ``timeout``); each
    rank's exit code and the tail of its stderr."""
    deadline = time.monotonic() + timeout
    results = []
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
            results.append((p.returncode, p.log_path.read_text(errors="replace")[-4000:]))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"a rank of the world did not finish within {timeout} s")
    return results


def world_outputs(procs, outs, timeout: float = 180.0) -> list[list[dict]]:
    """Join a world that must succeed; every rank's outputs, and each
    follower's replayed dispatches checked equal to the leader's."""
    for rank, (rc, err) in enumerate(join_world(procs, timeout)):
        assert rc == 0, f"rank {rank} exited {rc}: {err}"
    ranks = [json.loads(p.read_text()) for p in outs]
    for case, lead in enumerate(ranks[0]):
        dispatches = [lead["dispatches"][str(i)] for i in range(len(lead["dispatches"]))]
        for rank in ranks[1:]:
            # every rank ends every dispatch with the leader's tokens
            assert rank[case]["dispatches"] == dispatches, f"case {case}"
    return ranks


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


class _Recorder:
    """A lockstep leader that keeps the descriptors it is given."""

    def __init__(self):
        self.frames: list[dict] = []

    def broadcast(self, desc):
        self.frames.append(desc)

    def close(self):
        pass


def _engine_descriptors() -> list[dict]:
    """The descriptors a leading port engine broadcasts: a paged engine with
    the prefix cache, chunked prefill and speculation (prefill,
    prefill_continue, spec_step), and one whose heavy burst runs the
    pipelined loop (decode, decode_cont)."""
    frames = []
    layouts = [
        {**TINY, "max-seq-len": 128, "kv-layout": "paged", "kv-block-size": 16,
         "prefill-chunk": 16, "speculative-drafts": 4},
        {**TINY, "kv-layout": "paged", "kv-block-size": 16, "decode-chunk-light": 0},
    ]
    for cfg in layouts:
        engine = TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu")
        engine._lockstep = recorder = _Recorder()

        async def serve(engine=engine):
            try:
                await asyncio.gather(*(engine.generate(p, {"max-tokens": 12})
                                       for p in ("hello " * 10, "again", "x", "yz")))
                await engine.generate("hello " * 10 + "more", {"max-tokens": 4})
            finally:
                await engine.close()

        asyncio.run(serve())
        frames += recorder.frames
    return frames


def test_frames_are_byte_equal_to_the_jax_packages_for_every_op_kind():
    frames = _engine_descriptors()
    frames += [
        {"op": "join", "token": "secret"},
        {"op": "handshake", "config_json": json.dumps(ServingConfig().to_dict())},
        {"op": "reject", "reason": "bad token"},
        {"op": "stop"},
    ]
    kinds = {f["op"] for f in frames}
    assert kinds == {"prefill", "prefill_continue", "decode", "decode_cont", "spec_step",
                     "join", "handshake", "reject", "stop"}
    for desc in frames:
        port = port_lockstep.encode_descriptor(desc)
        assert port == jax_lockstep.encode_descriptor(desc), desc["op"]
        # and each decodes the other's frame
        for back in (port_lockstep.decode_descriptor(jax_lockstep.encode_descriptor(desc)[4:]),
                     jax_lockstep.decode_descriptor(port[4:])):
            assert back.keys() == desc.keys()
            for key, value in desc.items():
                if isinstance(value, np.ndarray):
                    assert back[key].dtype == value.dtype
                    np.testing.assert_array_equal(back[key], value)
                else:
                    assert back[key] == value


def test_the_port_reads_a_jax_frame_from_a_socket():
    a, b = socket.socketpair()
    desc = {"op": "decode", "tokens": np.arange(4, dtype=np.int64),
            "active": np.array([True, False, True, True]), "window": None, "k": 4,
            "sampler_mode": [False, False, True]}
    a.sendall(jax_lockstep.encode_descriptor(desc))
    got = read_frame(b)
    a.close()
    b.close()
    np.testing.assert_array_equal(got["tokens"], desc["tokens"])
    np.testing.assert_array_equal(got["active"], desc["active"])
    assert got["window"] is None and got["k"] == 4 and got["sampler_mode"] == [False, False, True]


# ---------------------------------------------------------------------------
# membership and failure (tests/test_lockstep.py's promises)
# ---------------------------------------------------------------------------


def test_a_bad_token_is_rejected():
    leader = LockstepLeader({"config_json": "{}"}, expected_followers=1, port=0,
                            token="right")
    try:
        with pytest.raises(RuntimeError, match="rejected: bad token"):
            LockstepFollower("127.0.0.1", leader.port, token="wrong",
                             device="cpu").run()
        assert leader._followers == []
    finally:
        leader.close()


def test_a_late_joiner_is_rejected():
    leader = LockstepLeader({"config_json": "{}"}, expected_followers=1, port=0, token="t")
    try:
        first = socket.create_connection(("127.0.0.1", leader.port))
        first.sendall(encode_descriptor({"op": "join", "token": "t"}))
        assert read_frame(first)["op"] == "handshake"
        leader.wait_ready(timeout=10)
        with pytest.raises(RuntimeError, match="membership is full or broken"):
            LockstepFollower("127.0.0.1", leader.port, token="t", device="cpu").run()
        first.close()
    finally:
        leader.close()


def test_broadcast_raises_lockstep_broken_after_follower_death():
    leader = LockstepLeader({"config_json": "{}"}, expected_followers=1, port=0, token="t")
    try:
        sock = socket.create_connection(("127.0.0.1", leader.port))
        sock.sendall(encode_descriptor({"op": "join", "token": "t"}))
        assert read_frame(sock)["op"] == "handshake"
        leader.wait_ready(timeout=10)
        leader.broadcast({"op": "decode", "step": 0})
        assert read_frame(sock)["step"] == 0
        sock.close()  # death: no more reads ever
        with pytest.raises(LockstepBroken):
            for step in range(50):
                leader.broadcast({"op": "decode", "step": step})
                time.sleep(0.05)
        with pytest.raises(LockstepBroken):  # the group stays poisoned
            leader.broadcast({"op": "stop"})
    finally:
        leader.close()


def test_engine_fails_inflight_and_stops_on_lockstep_broken():
    """A broadcast that fails mid-serving: the in-flight request gets
    ``LockstepBroken``, the flight ring the ``lockstep-divergence`` event,
    the engine stops, and a later submission fails with the JAX engine's
    message."""

    class _Dying(_Recorder):
        def broadcast(self, desc):
            super().broadcast(desc)
            if len(self.frames) >= 2:  # the first frame lands, then the follower dies
                raise LockstepBroken("injected follower loss")

    async def main():
        engine = TorchServingEngine(ServingConfig.from_dict(TINY), device="cpu")
        engine._lockstep = _Dying()
        try:
            with pytest.raises(LockstepBroken):
                await engine.generate("hello", {"max-tokens": 8})
            assert engine._stop, "the engine must stop serving after a broken group"
            assert engine.flight.events_by_type.get("lockstep-divergence") == 1
            with pytest.raises(RuntimeError, match=r"stopped \(closed or lockstep group broken\)"):
                await engine.generate("again", {"max-tokens": 2})
        finally:
            await engine.close()

    asyncio.run(main())


def test_follower_exits_promptly_when_leader_dies():
    server = socket.socket()
    server.bind(("127.0.0.1", 0))
    server.listen(1)
    port = server.getsockname()[1]
    config_json = json.dumps({"model": "tiny", "slots": 2, "max-seq-len": 64})

    def fake_leader():
        conn, _ = server.accept()
        read_frame(conn)  # join
        conn.sendall(encode_descriptor({"op": "handshake", "config_json": config_json}))
        time.sleep(0.5)
        conn.close()  # the leader dies mid-serving, no stop frame

    threading.Thread(target=fake_leader, daemon=True).start()
    start = time.monotonic()
    with pytest.raises((ConnectionError, OSError)):
        LockstepFollower("127.0.0.1", port, device="cpu").run()
    assert time.monotonic() - start < 60
    server.close()


def test_leader_death_follower_exits_promptly(tmp_path):
    """Two processes: the leader dies after serving without the stop frame
    (its pipelined burst may still be in a chunk); the follower sees the
    closed channel, or the collective its dead peer left, and exits
    non-zero at once, not at a timeout."""
    start = time.monotonic()
    procs, _ = spawn_world(tmp_path, 2, [{**TINY, "mesh": {"tp": 2}}],
                           rank_env={0: {"LS_DEMO_LEADER_ABRUPT_EXIT": "1"}})
    (leader_rc, leader_err), (follower_rc, follower_err) = join_world(procs, timeout=120)
    assert leader_rc == 4, leader_err
    assert follower_rc != 0 and "Traceback" in follower_err, follower_err
    assert time.monotonic() - start < 50  # well inside the 60 s collective timeout


@pytest.mark.slow
def test_follower_death_mid_burst_leader_fails_loud(tmp_path):
    """Two processes: the follower dies after 4 replayed descriptors; the
    leader's in-flight work fails with ``LockstepBroken`` (a broadcast or a
    collective with the dead rank), its engine stops, and it exits 5."""
    procs, _ = spawn_world(tmp_path, 2, [{**TINY, "mesh": {"tp": 2}}], max_tokens=40,
                           env={"LS_TORCH_COLLECTIVE_TIMEOUT_S": "20"},
                           rank_env={1: {"LS_DEMO_FOLLOWER_DIE_AFTER": "4"}})
    (leader_rc, leader_err), (follower_rc, follower_err) = join_world(procs, timeout=180)
    assert follower_rc == 3, follower_err
    assert leader_rc == 5, leader_err
    assert "LockstepBroken" in leader_err
    assert "engine stopped serving: True" in leader_err


# ---------------------------------------------------------------------------
# refusals and the pod's slice seam
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overrides,error,match", [
    ({"kv-layout": "paged", "adapter-store": {"rank": 4}}, ValueError,
     "adapter-store is incompatible with multi-host lockstep"),
    ({"kv-layout": "paged", "prefix-store": {"t2": {"type": "local", "path": "x"}}},
     ValueError, "prefix-store is incompatible with a multi-rank mesh"),
    ({"kv-layout": "paged", "pool-role": "decode"}, ValueError,
     "pool-role prefill/decode is incompatible with a multi-rank mesh"),
    ({"mesh": {"sp": 2, "tp": 2}}, NotImplementedError, "item 13b"),
])
def test_refusals_under_a_mesh(overrides, error, match):
    cfg = ServingConfig.from_dict({**TINY, "mesh": {"tp": 2}, **overrides})
    with pytest.raises(error, match=match):
        TorchServingEngine(cfg, device="cpu")


def test_a_one_rank_mesh_serves_in_process_and_through_the_provider():
    """A mesh of one rank needs no group: the engine serves its tokens and
    reports the mesh; the provider passes the resource's mesh through."""
    from langstream_tpu_torch.agents.provider import TorchServiceProvider

    plain = TorchServingEngine(ServingConfig.from_dict(TINY), device="cpu")
    meshed = TorchServingEngine(ServingConfig.from_dict({**TINY, "mesh": {"tp": 1}}),
                                device="cpu")

    async def serve(engine):
        try:
            return (await engine.generate("hello", {"max-tokens": 5}))["tokens"]
        finally:
            await engine.close()

    assert asyncio.run(serve(meshed)) == asyncio.run(serve(plain))
    # every rank builds its weights from the configuration, none from a caller
    with pytest.raises(ValueError, match="every rank builds its own weights"):
        TorchServingEngine(ServingConfig.from_dict({**TINY, "mesh": {"tp": 1}}),
                           device="cpu", params=plain.params)
    section = meshed.stats()["mesh"]
    assert section["axes"] == {"tp": 1} and section["world-size"] == 1
    assert section["lockstep-role"] is None
    provider = TorchServiceProvider({"type": "tpu-serving-configuration", "name": "t",
                                     **TINY, "mesh": {"tp": 1}}, device="cpu")
    service = provider.get_completions_service({})
    assert service.engine.config.mesh == (("tp", 1),)
    TorchServingEngine.reset_instances()


@pytest.mark.parametrize("model,fixture", [("tiny", "llama_tiny_golden"),
                                           ("moe-tiny", "moe_tiny_golden")])
def test_a_mesh_engine_places_the_one_rank_engines_weights(model, fixture):
    """Under a mesh the engine places its weights leaf by leaf (a checkpoint
    read leaf by leaf, each stacked weight quantized one layer at a time on
    the device, then sharded): at one rank that is exactly the tree of an
    engine without a mesh, which quantizes the whole tree."""
    from langstream_tpu_torch.models.quant import QTensor

    cfg = {**TINY, "model": model, "quantize": "int8",
           "checkpoint": str(REPO / "tests" / "fixtures" / fixture)}
    plain = TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu")
    meshed = TorchServingEngine(ServingConfig.from_dict({**cfg, "mesh": {"tp": 1}}),
                                device="cpu")

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            elif isinstance(v, QTensor):
                yield f"{prefix}{k}.q", v.q
                yield f"{prefix}{k}.s", v.s
            else:
                yield prefix + k, v

    want, got = dict(leaves(plain.params)), dict(leaves(meshed.params))
    assert want.keys() == got.keys()
    for name, w in want.items():
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name
    assert meshed.stats()["mesh"]["weights-bytes"] == plain._weights_bytes
    for engine in (plain, meshed):
        asyncio.run(engine.close())
    TorchServingEngine.reset_instances()


def test_register_points_the_pods_slice_functions_at_the_port_once(monkeypatch):
    import serve_torch
    from langstream_tpu.agents import services
    from langstream_tpu.runtime import pod
    from langstream_tpu.serving import engine as jax_engine
    from langstream_tpu_torch.core import metrics as port_metrics
    from langstream_tpu_torch.core.tracing import SPANS
    from langstream_tpu_torch.runtime import pod as port_pod
    from langstream_tpu_torch.serving.journey import JOURNEYS

    for name in serve_torch.POD_SEAM:
        monkeypatch.setattr(jax_engine, name, getattr(jax_engine, name))
    originals = {name: getattr(pod, name) for name in serve_torch.SLICE_SEAM}
    for name, fn in originals.items():
        monkeypatch.setattr(pod, name, fn)
    monkeypatch.setattr(services, "_provider_factories", dict(services._provider_factories))
    monkeypatch.setattr(JOURNEYS, "mirror", JOURNEYS.mirror)
    monkeypatch.setattr(SPANS, "mirror", SPANS.mirror)
    monkeypatch.setattr(port_metrics, "REPORTER", port_metrics.REPORTER)
    serve_torch.register(device="cpu")
    wrapped = {name: getattr(pod, name) for name in serve_torch.SLICE_SEAM}
    serve_torch.register(device="cpu")
    for name, fn in wrapped.items():
        current = getattr(pod, name)
        assert current is fn and current.with_port
        # the pod module's own function, wrapped once (an earlier register
        # in this process may have wrapped it already)
        assert not getattr(current.__wrapped__, "with_port", False)
        assert current.__wrapped__.__module__ == "langstream_tpu.runtime.pod"
    # one host: joining is a no-op, as the JAX function's
    monkeypatch.delenv("LS_SLICE_HOSTS", raising=False)
    assert pod.maybe_join_slice() is None
    assert port_pod.pod_ordinal("agent-3") == pod.pod_ordinal("agent-3") == 3

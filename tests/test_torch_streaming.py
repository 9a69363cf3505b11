"""The delivery plane of the port against the JAX package's.

``TbtDigest`` gives the JAX digest's quantiles on the same intervals; the
port's stream registry cancels across threads, self-cleans and remembers
late cancels; a ``streaming: true`` engine delivers the JAX engine's chunks
byte for byte, and a default engine stays as it was (delivery works, no
streaming surface appears). A client disconnect — ``cancel(stream-key)``
from another thread — cancels the request and frees its slot and its
blocks exactly once whether it is queued, mid chunked prefill, in a
pending pipelined chunk or in a speculative step. Through the launcher
(``serve_torch.register(device="cpu")``), the platform's own registry
reaches the port's engine and the chat agent classifies the cancel as a
disconnect.
"""

import asyncio
import threading

import numpy as np
import pytest
import torch
import yaml

from langstream_tpu.agents import services as jax_services
from langstream_tpu.runtime.local_runner import LocalApplicationRunner
from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu.serving.streaming import STREAMS as PLATFORM_STREAMS
from langstream_tpu.serving.streaming import TbtDigest as JaxTbtDigest
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
from langstream_tpu_torch.serving.streaming import (
    STREAMS,
    StreamCancelRegistry,
    TbtDigest,
)
from test_torch_engine import flatten_jax_params

TINY = {"model": "tiny", "model-dtype": "float32", "slots": 2, "max-seq-len": 256,
        "decode-chunk": 4}
PAGED = {"kv-layout": "paged", "kv-block-size": 16, "prefix-cache": False}


# ---------------------------------------------------------------------------
# TbtDigest and the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_tbt_digest_matches_jax(seed):
    rng = np.random.default_rng(seed)
    intervals = np.concatenate([
        rng.lognormal(-4.0, 1.0, 200), rng.uniform(0, 0.002, 20),
        [-1.0, 0.0, 500.0] if seed % 2 else [3.0],
    ])
    port, jax = TbtDigest(), JaxTbtDigest()
    assert port.summary() == jax.summary()
    for x in intervals:
        port.add(float(x))
        jax.add(float(x))
    assert port.counts == jax.counts
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert port.quantile(q) == jax.quantile(q)
    assert port.summary() == jax.summary()
    assert TbtDigest.BOUNDS == JaxTbtDigest.BOUNDS


def test_registry_cancels_across_threads_and_self_cleans():
    reg = StreamCancelRegistry()

    async def main():
        loop = asyncio.get_running_loop()
        futures = [loop.create_future() for _ in range(2)]
        for f in futures:  # one client, two records on one socket
            reg.register("k1", f, loop)
        assert reg.active() == 2
        signalled = []
        t = threading.Thread(target=lambda: signalled.append(reg.cancel("k1")))
        t.start()
        t.join()
        assert signalled == [2]
        await asyncio.sleep(0)  # the cancel is marshalled onto this loop
        assert all(f.cancelled() for f in futures)
        await asyncio.sleep(0)  # ... and the done-callbacks one tick later
        assert reg.active() == 0
        done = loop.create_future()
        reg.register("k2", done, loop)
        done.set_result("ok")
        await asyncio.sleep(0)
        assert reg.active() == 0
        assert reg.cancel("never-registered") == 0

    asyncio.run(main())


def test_registry_late_cancel_consume_and_bound():
    reg = StreamCancelRegistry()

    async def main():
        loop = asyncio.get_running_loop()
        reg.cancel("late")  # the disconnect arrives first ...
        fut = loop.create_future()
        reg.register("late", fut, loop)  # ... the record after it
        await asyncio.sleep(0)
        assert fut.cancelled()
        assert reg.consume_cancelled("late") is True
        assert reg.consume_cancelled("late") is False

    asyncio.run(main())
    reg.CANCELLED_KEYS_MAX = 8
    for i in range(50):
        reg.cancel(f"k{i}")
    assert len(reg._cancelled) == 8
    assert reg.consume_cancelled("k0") is False and reg.consume_cancelled("k49") is True


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


def _both(cfg: dict, scenario):
    async def jax():
        engine = TpuServingEngine(JaxServingConfig.from_dict(cfg))
        try:
            return flatten_jax_params(engine.params), await scenario(engine)
        finally:
            await engine.close()

    flat, want = asyncio.run(jax())

    async def port():
        engine = TorchServingEngine(
            ServingConfig.from_dict(cfg), device="cpu",
            params=params_from_numpy(flat, device="cpu", dtype=torch.float32))
        try:
            return await scenario(engine)
        finally:
            await engine.close()

    return want, asyncio.run(port())


async def _stream(engine):
    prompt = "stream me the full answer please"
    plain = await engine.generate(prompt, {"max-tokens": 24})
    chunks = []
    streamed = await engine.generate(
        prompt, {"max-tokens": 24, "stop": plain["text"][5:7]},
        on_chunk=lambda ids, delta, final: chunks.append((list(ids), delta, final)))
    emits = [e for e in engine.flight.recent_events(0) if e["kind"] == "stream-emit"]
    section = engine.stats().get("streaming")
    return plain, streamed, chunks, emits, section


@pytest.mark.parametrize("layout", [{}, PAGED], ids=["dense", "paged"])
def test_streamed_chunks_equal_the_jax_engines(layout):
    """``streaming: true``: the same chunks (ids, text deltas, final flag)
    as the JAX engine, tiling the final text; TBT telemetry in
    ``request_timings``, ``stats()["streaming"]`` and one ``stream-emit``
    event."""
    cfg = {**TINY, **layout, "streaming": True}
    want, got = _both(cfg, _stream)
    plain, streamed, chunks, emits, section = got
    assert chunks == want[2]
    assert streamed["text"] == want[1]["text"] and streamed["tokens"] == want[1]["tokens"]
    assert len(chunks) >= 2 and [c[2] for c in chunks].count(True) == 1 and chunks[-1][2]
    assert "".join(delta for _, delta, _ in chunks) == streamed["text"]
    assert [t for ids, _, _ in chunks for t in ids] == streamed["tokens"]
    assert len(emits) == len(want[3]) == 1
    assert emits[0]["emits"] == len(chunks) and emits[0]["stalls"] == 0
    assert emits[0]["tokens"] == len(streamed["tokens"])
    assert set(section) == set(want[4])
    assert section["emits"] == len(chunks) and section["tbt"]["default"]["count"] >= 1
    assert section["cancelled"] == section["reclaimed"] == 0 and section["active"] == 0


def test_default_engine_stays_as_it_was():
    """No ``streaming`` key: ``on_chunk`` still tiles the text, but no
    streaming section, ``tbt_burn``, TBT timing key or stream event appears,
    and ``stats()`` gains only the JAX engine's ``health``, ``scheduler``,
    ``drain`` and ``survival`` sections."""
    cfg = {**TINY, **PAGED}

    async def scenario(engine):
        prompt = "default config pin prompt"
        plain = await engine.generate(prompt, {"max-tokens": 16})
        chunks = []
        streamed = await engine.generate(prompt, {"max-tokens": 16},
                                         on_chunk=lambda ids, d, f: chunks.append(d))
        kinds = {e["kind"] for e in engine.flight.recent_events(0)}
        return (plain["text"], streamed["text"], "".join(chunks), engine.stats(),
                engine.health(), list(engine.request_timings)[-1], kinds)

    want, got = _both(cfg, scenario)
    plain, streamed, joined, stats, health, timing, kinds = got
    assert plain == streamed == joined == want[0]
    assert "streaming" not in stats and "tbt_burn" not in health
    assert "tbt_p50" not in timing and set(timing) == set(want[5])
    assert not any(k.startswith("stream-") for k in kinds)
    assert stats["scheduler"] == want[3]["scheduler"]
    before_this_slice = {
        "model", "device", "slots", "active", "queued", "total-generated", "completed",
        "prefill-calls", "prefill-continue-calls", "prefix", "decode-chunks", "pipeline",
        "device-cache", "steps", "attribution", "kernels", "kv", "deadline-sheds", "warmup",
    }
    assert set(stats) == before_this_slice | {"health", "scheduler", "drain", "survival"}
    assert {"drain", "survival"} <= set(want[3])


class _ReleaseLog:
    """Counts, per slot, the releases that dropped a reservation."""

    def __init__(self, engine):
        self.nonzero = []
        real = engine.block_mgr.release

        def release(slot):
            if engine.block_mgr._slot_reservation[slot]:
                self.nonzero.append(slot)
            real(slot)

        engine.block_mgr.release = release


def _cancel_from_thread(registry, key):
    t = threading.Thread(target=registry.cancel, args=(key,))
    t.start()
    t.join()


async def _disconnect(engine, state: str):
    """Cancel the stream ``sk-<state>`` from another thread while its
    request is in ``state``; a neighbour request completes."""
    key = f"sk-{state}"
    engine.tokenizer.eos_id = -1  # no stream ends early on EOS
    log = _ReleaseLog(engine)
    seen = {}
    long_prompt = "a long prompt that prefills in several chunks " * 3
    neighbour_opts = {"max-tokens": 24}
    target_prompt, target_opts = "a request the client will abandon", {"max-tokens": 96}

    if state == "queued":
        # one slot: the target waits behind the neighbour and is cancelled
        # from the neighbour's first delivery
        def on_neighbour(ids, delta, final):
            if "done" not in seen:
                seen["done"] = True
                _cancel_from_thread(STREAMS, key)
        target_cb = None
    elif state == "prefilling":
        target_prompt = long_prompt

        def on_neighbour(ids, delta, final):
            slot = next((s for s in engine.slots if s.prefilling), None)
            if slot is not None and "done" not in seen:
                seen["done"] = slot.request.stream_key
                _cancel_from_thread(STREAMS, key)
        target_cb = None
    elif state == "pending":
        real_drain = engine._drain_pending

        async def drain(loop):
            pending = engine._pending_chunk
            if pending is not None and "done" not in seen and any(
                    r is not None and r.stream_key == key for r in pending[2]):
                seen["done"] = True
                _cancel_from_thread(STREAMS, key)
                await asyncio.sleep(0)  # the cancel lands while the chunk is pending
            await real_drain(loop)

        engine._drain_pending = drain
        on_neighbour = None
        target_cb = None
    else:  # speculative
        on_neighbour = None

        def target_cb(ids, delta, final):
            if "done" not in seen and engine.spec_steps > 0:
                seen["done"] = True
                _cancel_from_thread(STREAMS, key)

    neighbour = asyncio.ensure_future(engine.generate(
        "the neighbour request", neighbour_opts,
        on_chunk=on_neighbour or (lambda *a: None)))
    target = asyncio.ensure_future(engine.generate(
        target_prompt, {**target_opts, "stream-key": key},
        on_chunk=target_cb or (lambda *a: None)))
    if state == "pending":
        # a third request arrives once the burst runs: the burst yields for
        # it and leaves its last chunk pending
        while engine.stats()["decode-chunks"]["dispatched"] < 2:
            await asyncio.sleep(0.001)
        late = asyncio.ensure_future(engine.generate("a late arrival", {"max-tokens": 4},
                                                     on_chunk=lambda *a: None))
    with pytest.raises(asyncio.CancelledError):
        await target
    assert (await neighbour)["tokens"]
    if state == "pending":
        assert (await late)["tokens"]
    await engine.settled()
    for _ in range(100):  # the finished drain runs at the next flush
        if not any(e["kind"] == "stream-cancel" for e in engine.flight.recent_events(0)) \
                and state != "queued":
            await asyncio.sleep(0.01)
    return key, seen, log


@pytest.mark.parametrize("state", ["queued", "prefilling", "pending", "speculative"])
def test_disconnect_frees_slot_and_blocks_exactly_once(state):
    cfg = {**TINY, **PAGED, "streaming": True, "kv-pool-blocks": 64}
    if state == "queued":
        cfg["slots"] = 1
    if state == "prefilling":
        cfg["prefill-chunk"] = 16
    if state == "pending":
        cfg.update({"slots": 3, "decode-chunk-light": 0})
    if state == "speculative":
        cfg["speculative-drafts"] = 4
    engine = TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu")

    async def main():
        try:
            key, seen, log = await _disconnect(engine, state)
            return key, seen, log, engine.stats(), [
                e for e in engine.flight.recent_events(0) if e["kind"] == "stream-cancel"]
        finally:
            await engine.close()

    key, seen, log, stats, cancels = asyncio.run(main())
    assert seen.get("done"), f"the cancel never landed in state {state}"
    section = stats["streaming"]
    held_a_slot = state != "queued"
    assert section["cancelled"] == section["reclaimed"] == int(held_a_slot)
    assert section["active"] == 0 and stats["active"] == 0
    assert stats["kv"]["reserved_blocks"] == 0
    assert stats["kv"]["free_blocks"] == stats["kv"]["num_blocks"] - 1
    # one reservation-dropping release per request that held a slot
    admitted = stats["scheduler"]["admitted"]
    assert len(log.nonzero) == admitted - (0 if held_a_slot else 1)
    assert STREAMS.consume_cancelled(key) is True and STREAMS.active() == 0
    if state in ("pending", "speculative"):
        assert len(cancels) == 1 and cancels[0]["slot_reclaimed"]
        assert cancels[0]["tokens_wasted"] == (
            cancels[0]["tokens_generated"] - cancels[0]["tokens_delivered"])
    if state == "speculative":
        assert stats["speculative"]["steps"] > 0
    assert stats["completed"] == admitted - 1  # all but the cancelled target


def test_disconnect_matches_jax_evidence():
    """The JAX engine's disconnect acceptance on both engines: the same
    cancel counters, the same ``stream-cancel`` evidence keys, no
    completion counted."""
    cfg = {**TINY, "decode-chunk": 2, "streaming": True}

    async def scenario(engine):
        key = f"sk-both-{type(engine).__name__}"
        first = asyncio.Event()
        task = asyncio.ensure_future(engine.generate(
            "long streaming request the client will abandon",
            {"max-tokens": 96, "stream-key": key}, on_chunk=lambda *a: first.set()))
        await asyncio.wait_for(first.wait(), timeout=60)
        registry = STREAMS if isinstance(engine, TorchServingEngine) else PLATFORM_STREAMS
        assert registry.cancel(key) == 1
        with pytest.raises(asyncio.CancelledError):
            await task
        for _ in range(200):
            if engine.stats()["streaming"]["reclaimed"] >= 1:
                break
            await asyncio.sleep(0.01)
        section = engine.stats()["streaming"]
        ev = [e for e in engine.flight.recent_events(0) if e["kind"] == "stream-cancel"]
        consumed = registry.consume_cancelled(key)
        return ({k: section[k] for k in ("cancelled", "reclaimed", "active")},
                sorted(set(ev[0]) - {"request"}), engine.completed_requests,
                all(s.free for s in engine.slots), consumed, registry.active())

    want, got = _both(cfg, scenario)
    assert got == want
    assert got[0] == {"cancelled": 1, "reclaimed": 1, "active": 0}


# ---------------------------------------------------------------------------
# the launcher: the platform's registry reaches the port
# ---------------------------------------------------------------------------

CHAT_PIPELINE = """
topics:
  - name: "input-topic"
    creation-mode: create-if-not-exists
  - name: "output-topic"
    creation-mode: create-if-not-exists
  - name: "stream-topic"
    creation-mode: create-if-not-exists
pipeline:
  - name: "convert"
    type: "document-to-json"
    input: "input-topic"
    configuration:
      text-field: "question"
  - name: "chat"
    type: "ai-chat-completions"
    output: "output-topic"
    configuration:
      model: "mock-model"
      completion-field: "value.answer"
      stream-to-topic: "stream-topic"
      stream-response-completion-field: "value"
      min-chunks-per-message: 1
      max-tokens: 64
      messages:
        - role: user
          content: "Q: {{ value.question }}"
"""
INSTANCE = """
instance:
  streamingCluster:
    type: "memory"
"""


def test_platform_cancel_reaches_the_port_through_the_launcher(tmp_path, monkeypatch):
    """A record carrying ``langstream-stream-id`` is served by the port
    (``serve_torch.register(device="cpu")``, ``streaming: true``); after its
    first chunk the gateway's ``STREAMS.cancel(key)`` — the platform's
    registry — cancels it: the engine frees the slot, the chat agent's
    disconnect check consumes the key and commits the record without an
    answer, and the next record is answered."""
    import serve_torch

    (tmp_path / "pipeline.yaml").write_text(CHAT_PIPELINE)
    (tmp_path / "configuration.yaml").write_text(yaml.safe_dump({"configuration": {
        "resources": [{"type": "tpu-serving-configuration", "name": "tpu",
                       "configuration": {**TINY, **PAGED, "streaming": True}}]}}))
    key = "sk-launcher-disconnect"
    delivered, release = asyncio.Event(), asyncio.Event()
    real = TorchServingEngine._deliver_chunk

    async def gated(self, request, is_final, now):
        # hold the engine after the stream's first delivery until the test
        # has cancelled: the cancel then lands mid-decode, deterministically
        await real(self, request, is_final, now)
        if request.stream_key == key and not delivered.is_set():
            delivered.set()
            await release.wait()

    monkeypatch.setattr(TorchServingEngine, "_deliver_chunk", gated)

    async def main():
        runner = LocalApplicationRunner.from_directory(tmp_path, instance=INSTANCE)
        try:
            async with runner:
                await runner.produce("input-topic", "abandoned question",
                                     headers={"langstream-stream-id": key})
                await asyncio.wait_for(delivered.wait(), timeout=120)
                engine = next(iter(TorchServingEngine._instances.values()))
                assert engine.streams is PLATFORM_STREAMS
                assert PLATFORM_STREAMS.cancel(key) == 1
                release.set()
                await runner.produce("input-topic", "second question")
                final = await runner.wait_for_messages("output-topic", 1, timeout=120)
                await engine.settled()
                return final, engine.stats()
        finally:
            engines = list(TorchServingEngine._instances.values())
            TorchServingEngine.reset_instances()
            for engine in engines:
                await engine.close()

    factory = jax_services._provider_factories["tpu-serving-configuration"]
    try:
        serve_torch.register(device="cpu")
        final, stats = asyncio.run(main())
    finally:
        jax_services.register_provider("tpu-serving-configuration", factory)
    assert len(final) == 1 and final[0].value["question"] == "second question"
    assert final[0].value["answer"]
    section = stats["streaming"]
    assert section["cancelled"] == section["reclaimed"] == 1 and stats["active"] == 0
    assert stats["kv"]["reserved_blocks"] == 0 and stats["completed"] == 1
    # the agent's disconnect check consumed the key (one-shot)
    assert PLATFORM_STREAMS.consume_cancelled(key) is False
    assert PLATFORM_STREAMS.active() == 0 and STREAMS.active() == 0

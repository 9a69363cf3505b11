"""The provider seam: the port's ``TorchServiceProvider`` against the JAX
package's ``TpuServiceProvider``, through the platform's agents.

Both packages load the same weights from the in-repo HF fixture
(``checkpoint:``), so their greedy streams, texts, chunk lists and token
counts must be identical. Also here: the engine's submit-time refusals,
the JAX engine's chunk-length rule (light and heavy regimes), warmup,
``get_or_create``, the launcher ``serve_torch.py`` and the chat example's
resource as ``chip_smoke.py`` writes it.
"""

import asyncio
import logging
import time
from pathlib import Path

import numpy as np
import pytest
import yaml

from langstream_tpu.agents import services as jax_services
from langstream_tpu.agents.tpu_provider import (
    TpuServiceProvider,
    _render_chat_prompt as jax_render_chat_prompt,
    _StreamAdapter as JaxStreamAdapter,
)
from langstream_tpu.runtime.local_runner import LocalApplicationRunner
from langstream_tpu.serving.engine import (
    ServingConfig as JaxServingConfig,
    TpuServingEngine,
)
from langstream_tpu_torch.agents.provider import (
    TorchServiceProvider,
    _render_chat_prompt,
    _StreamAdapter,
)
from langstream_tpu_torch.models.tokenizer import ByteTokenizer
from langstream_tpu_torch.serving.deadline import DeadlineExceeded
from langstream_tpu_torch.serving.streaming import STREAMS as PORT_STREAMS
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

REPO = Path(__file__).resolve().parents[1]
FIXTURE = str(REPO / "tests" / "fixtures" / "llama_tiny_golden")
TINY = {"model": "tiny", "model-dtype": "float32", "slots": 3, "max-seq-len": 128,
        "checkpoint": FIXTURE, "decode-chunk": 4, "decode-chunk-light": 2,
        "max-tokens": 12}
PAGED = {"kv-layout": "paged", "prefix-cache": False, "kv-block-size": 16}
INSTANCE = """
instance:
  streamingCluster:
    type: "memory"
"""


async def _close_all():
    """Close and forget every shared engine of both packages (inside the
    event loop that served them)."""
    for cls in (TorchServingEngine, TpuServingEngine):
        engines = list(cls._instances.values())
        cls.reset_instances()
        for engine in engines:
            await engine.close()


@pytest.fixture(autouse=True)
def _no_shared_engines():
    yield
    TorchServingEngine.reset_instances()
    TpuServingEngine.reset_instances()


# ---------------------------------------------------------------------------
# stream adapter and chat template
# ---------------------------------------------------------------------------

STREAMS = [  # (text the tokens spell, stop, end on EOS)
    ("héllo wörld 🙂 done", None, False),
    ("héllo wörld 🙂 done", None, True),
    ("abc STOP def", "STOP", False),
    ("xx ends with S", ["STOP", "wör"], False),
    ("日本語 and ST then more", ["ST", "本語 x"], True),
    ("smile 🙂 here", ["🙂"], False),
]


@pytest.mark.parametrize("text,stop,eos", STREAMS)
def test_stream_adapter_matches_jax(text, stop, eos):
    """Token by token over split multi-byte characters and one or two stop
    strings: the same Chunk list (text, index, last)."""
    tok = ByteTokenizer()
    ids = list(text.encode("utf-8")) + ([tok.eos_id] if eos else [])
    out = {}
    for name, cls in (("jax", JaxStreamAdapter), ("port", _StreamAdapter)):
        chunks = []
        adapter = cls(tok, lambda c: chunks.append((c.text, c.index, c.last)), stop=stop)

        async def feed(adapter=adapter):
            for i, t in enumerate(ids):
                await adapter.on_token(t, 0.0, i == len(ids) - 1)

        asyncio.run(feed())
        out[name] = chunks
    assert out["port"] == out["jax"]
    assert out["port"][-1][2] and sum(c[2] for c in out["port"]) == 1


def test_chat_template_matches_jax():
    for messages in ([], [{"content": "hi"}],
                     [{"role": "system", "content": "be brief"},
                      {"role": "user", "content": "Q: what?"},
                      {"role": "assistant", "content": "A."}]):
        assert _render_chat_prompt(messages) == jax_render_chat_prompt(messages)


# ---------------------------------------------------------------------------
# the two providers on the same checkpoint
# ---------------------------------------------------------------------------

CHATS = [
    [{"role": "user", "content": "Q: what is it?"}],
    [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hello"}],
    [{"role": "user", "content": "a longer question about paged attention"}],
    [{"role": "user", "content": "fourth"}],
]


async def _serve_provider(provider, stop):
    """Three chats (one with a stop string) and one text completion at
    once, every one streamed; (result fields, chunks) per request."""
    service = provider.get_completions_service({})
    assert provider.get_completions_service({}).engine is service.engine
    chunks = [[] for _ in range(len(CHATS) + 1)]
    calls = [
        service.chat_completions(
            m, {"max-tokens": 12, **({"stop": stop} if i == 1 else {})},
            lambda c, i=i: chunks[i].append((c.text, c.index, c.last)))
        for i, m in enumerate(CHATS[:3])
    ] + [service.text_completions("complete this", {"max-tokens": 9},
                                  lambda c: chunks[3].append((c.text, c.index, c.last)))]
    try:
        results = await asyncio.gather(*calls)
    finally:
        await _close_all()
    return [((r.text, r.num_prompt_tokens, r.num_completion_tokens, r.finish_reason), c)
            for r, c in zip(results, chunks)]


@pytest.mark.parametrize("layout", [{}, PAGED], ids=["dense", "paged"])
def test_provider_matches_jax_provider(layout):
    resource = {"type": "tpu-serving-configuration", "name": "tpu", **TINY, **layout}
    plain = asyncio.run(_serve_provider(TpuServiceProvider(resource), None))
    # a stop string the second chat's greedy text contains
    stop = plain[1][0][0][2:4]
    want = asyncio.run(_serve_provider(TpuServiceProvider(resource), stop))
    got = asyncio.run(_serve_provider(TorchServiceProvider(resource, device="cpu"), stop))
    assert got == want
    text, _, _, reason = got[1][0]
    assert reason == "stop" and stop not in text
    for (text, *_), chunks in got:
        assert "".join(c[0] for c in chunks) == text
        assert [c[1] for c in chunks] == list(range(len(chunks)))


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
      log-field: "value.prompt"
      stream-to-topic: "stream-topic"
      stream-response-completion-field: "value"
      min-chunks-per-message: 2
      max-tokens: 16
      messages:
        - role: user
          content: "Q: {{ value.question }}"
"""


def _pipeline_config() -> str:
    return yaml.safe_dump({"configuration": {"resources": [{
        "type": "tpu-serving-configuration", "name": "tpu",
        "configuration": {k: v for k, v in TINY.items() if k != "max-tokens"}
        | {"warmup-on-start": True},
    }]}})


def _run_chat_pipeline(app_dir):
    """The chat pipeline of ``tests/test_agents.py`` under the local
    runner: the answer and the stream reassembled in index order."""

    async def main():
        runner = LocalApplicationRunner.from_directory(app_dir, instance=INSTANCE)
        try:
            async with runner:
                await runner.produce("input-topic", "what is it?", headers={"session": "s1"})
                final = await runner.wait_for_messages("output-topic", 1, timeout=120)
                for _ in range(100):
                    chunks = await runner.wait_for_messages("stream-topic", 1)
                    if any(c.header("stream-last-message") == "true" for c in chunks):
                        break
                    await asyncio.sleep(0.05)
                chunks.sort(key=lambda c: int(c.header("stream-index")))
                assert chunks[0].header("session") == "s1"
                return final[0].value["answer"], "".join(c.value for c in chunks)
        finally:
            await _close_all()

    return asyncio.run(main())


def test_chat_pipeline_through_the_launcher_matches_jax(tmp_path):
    """``serve_torch.register(device="cpu")`` makes the platform's agents
    reach the port: the same answer and stream as the JAX provider."""
    import serve_torch

    (tmp_path / "pipeline.yaml").write_text(CHAT_PIPELINE)
    (tmp_path / "configuration.yaml").write_text(_pipeline_config())
    want = _run_chat_pipeline(tmp_path)
    factory = jax_services._provider_factories["tpu-serving-configuration"]
    try:
        serve_torch.register(device="cpu")
        provider = jax_services.resolve_service_provider(
            {"tpu": {"type": "tpu-serving-configuration", "name": "tpu", "model": "tiny"}})
        assert isinstance(provider, TorchServiceProvider) and provider.device == "cpu"
        got = _run_chat_pipeline(tmp_path)
    finally:
        jax_services.register_provider("tpu-serving-configuration", factory)
    assert got == want
    assert got[0] and got[0] == got[1]


def test_launcher_registers_then_runs_the_cli():
    import serve_torch

    factory = jax_services._provider_factories["tpu-serving-configuration"]
    try:
        with pytest.raises(SystemExit) as info:
            serve_torch.main(["--device", "cpu", "--help"])
        assert info.value.code == 0
        provider = jax_services._provider_factories["tpu-serving-configuration"](
            {"type": "tpu-serving-configuration", "name": "tpu"})
        assert isinstance(provider, TorchServiceProvider) and provider.device == "cpu"
    finally:
        jax_services.register_provider("tpu-serving-configuration", factory)


# ---------------------------------------------------------------------------
# the engine's front: refusals, chunk length, warmup, get_or_create
# ---------------------------------------------------------------------------

def _engine(**settings):
    cfg = {"model": "tiny", "model-dtype": "float32", "slots": 3, "max-seq-len": 128,
           "decode-chunk": 4, **settings}
    return TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu")


def test_submit_refusals_touch_no_slot(caplog):
    """``adapter`` raises the JAX engine's ValueError; a spent deadline
    raises DeadlineExceeded; both before the request queues. A future or
    malformed deadline is served; the planes' options are acted on, not
    logged as ignored: the stream key registers and self-cleans, and the
    FIFO scheduler admits both requests."""
    engine = _engine()

    async def main():
        try:
            with pytest.raises(ValueError, match="no adapter store"):
                await engine.generate("hi", {"adapter": "tenant-ft"})
            with pytest.raises(DeadlineExceeded, match="at submit"):
                await engine.generate("hi", {"deadline": time.time() - 1})
            with pytest.raises(DeadlineExceeded):
                await engine.generate("hi", {"deadline-s": 0})
            s = engine.stats()
            assert (s["queued"], s["active"], s["completed"], s["prefill-calls"]) == (0, 0, 0, 0)
            assert engine._loop_task is None and s["deadline-sheds"] == 2
            opts = {"max-tokens": 4, "deadline-s": 30, "stream-key": "k",
                    "qos-tenant": "acme", "priority": "high"}
            served = [await engine.generate("hi", opts),
                      await engine.generate("hi", {**opts, "deadline": "garbage"})]
            return served, engine.stats()
        finally:
            await engine.close()

    jax_engine = TpuServingEngine(JaxServingConfig.from_dict({"model": "tiny"}))

    async def jax_refuses():
        with pytest.raises(ValueError, match="no adapter store"):
            await jax_engine.generate("hi", {"adapter": "tenant-ft"})

    asyncio.run(jax_refuses())
    with caplog.at_level(logging.INFO, logger="langstream_tpu_torch.serving.engine"):
        served, stats = asyncio.run(main())
    assert all(r["tokens"] for r in served) and stats["completed"] == 2
    assert not [r for r in caplog.records if "not acted on" in r.getMessage()]
    assert stats["scheduler"] == {"policy": "fifo", "queued": 0, "admitted": 2}
    assert PORT_STREAMS.active() == 0


def _record_ks(engine, port: bool) -> list:
    """The K of every dispatched decode chunk."""
    ks = []
    if port:
        real = engine._run_decode

        def run_decode(*args):
            ks.append(args[5])
            return real(*args)

        engine._run_decode = run_decode
    else:
        real = engine._decode_fn

        def decode_fn(sampler_mode, window, k_steps=0, use_pen=False):
            ks.append(k_steps or engine.config.decode_chunk)
            return real(sampler_mode, window, k_steps, use_pen)

        engine._decode_fn = decode_fn
    return ks


WAVES = {  # name: prompts (the threshold is max(1, 3 // 8) = 1 active slot)
    "lone": [("a lone request", {"max-tokens": 11})],
    "wave": [("first of the wave", {}), ("second!", {"max-tokens": 7}),
             ("third prompt", {}), ("fourth, queued", {"max-tokens": 5}),
             ("fifth, queued too", {"max-tokens": 10})],
}


@pytest.mark.parametrize("layout", [{}, {**PAGED, "kv-quantize": "int8"}],
                         ids=["dense-f32", "paged-int8-kv"])
def test_chunk_length_and_streams_match_jax(layout):
    """``decode-chunk-light`` while at most the light threshold is active,
    ``decode-chunk`` above it, halved only while K >= 2·max(remaining,
    light): the K of every dispatched chunk equals the JAX engine's
    (``pipeline: false``), so on an int8 pool the commit boundaries and
    with them the greedy streams are identical too."""
    cfg = {**TINY, **layout, "pipeline": False}

    async def serve(engine, port):
        ks = _record_ks(engine, port)
        try:
            out = {}
            for name, wave in WAVES.items():
                results = await asyncio.gather(*(
                    engine.generate(p, {"max-tokens": 12, **o}) for p, o in wave))
                out[name] = ([r["tokens"] for r in results], list(ks))
                ks.clear()
            return out
        finally:
            await engine.close()

    want = asyncio.run(serve(TpuServingEngine(JaxServingConfig.from_dict(cfg)), False))
    got = asyncio.run(serve(TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu"),
                            True))
    assert got == want
    assert set(got["lone"][1]) == {2}
    assert {2, 4} <= set(got["wave"][1])


def test_light_threshold_as_jax():
    for settings in ({}, {"slots": 64}, {"slots": 64, "light-load-slots": 3},
                     {"decode-chunk-light": 0}, {"decode-chunk-light": 16}):
        cfg = {"model": "tiny", "decode-chunk": 16, **settings}
        jax_engine = TpuServingEngine(JaxServingConfig.from_dict(cfg))
        assert _engine(**cfg)._light_threshold() == jax_engine._light_threshold(), settings


def test_warmup_gate():
    """``warmup-on-start``: early requests await one shared task (a lone
    probe, then a wave); their results equal an engine's without warmup;
    the probes reach no caller; ``warmup()`` is idempotent."""
    prompts = ["first early request", "second", "third one here"]

    async def serve(engine):
        order = []
        try:
            results = await asyncio.gather(*(
                engine.generate(p, {"max-tokens": 10}, on_token=lambda *a: order.append(
                    engine._warmup_task is None or engine._warmup_task.done()))
                for p in prompts))
            stats = engine.stats()
            again = await engine.warmup() if engine.config.warmup_on_start else None
            return [r["tokens"] for r in results], order, again, stats, engine.stats()
        finally:
            await engine.close()

    warm = _engine(**{"warmup-on-start": True, "decode-chunk-light": 2})
    assert warm.stats()["warmup"] == {"state": "pending"}
    tokens, order, again, stats, after = asyncio.run(serve(warm))
    cold_tokens, _, _, cold, _ = asyncio.run(serve(_engine(**{"decode-chunk-light": 2})))
    assert tokens == cold_tokens and all(order)
    assert again["wave"] == 3 and again["probe_tokens"] == 5
    assert stats["warmup"]["state"] == "done" and stats["warmup"]["wave"] == 3
    # the probes ran (one lone, a wave of three) and went to no caller; the
    # explicit warmup() after the gate's reran nothing
    assert stats["completed"] == len(prompts) + 1 + 3
    assert after["completed"] == stats["completed"]
    assert after["total-generated"] == stats["total-generated"]
    assert cold["warmup"] == {"state": "not-required"} and cold["completed"] == len(prompts)


def test_get_or_create_one_engine_per_config_and_device():
    cfg = ServingConfig.from_dict({"model": "tiny", "model-dtype": "float32"})
    a = TorchServingEngine.get_or_create(cfg, device="cpu")
    assert TorchServingEngine.get_or_create(
        ServingConfig.from_dict({"model": "tiny", "model-dtype": "float32"}), "cpu") is a
    other = TorchServingEngine.get_or_create(
        ServingConfig.from_dict({"model": "tiny", "model-dtype": "float32", "slots": 2}),
        device="cpu")
    assert other is not a
    # an engine whose event loop has closed is replaced, not handed out
    first = asyncio.run(a.generate("hi", {"max-tokens": 3}))
    b = TorchServingEngine.get_or_create(cfg, device="cpu")
    assert b is not a
    assert asyncio.run(b.generate("hi", {"max-tokens": 3}))["tokens"] == first["tokens"]
    # a refused key holding a raw mapping is refused before the config is
    # hashed; a qos section parses into a hashable spec and shares
    with pytest.raises(NotImplementedError, match="prefix-store"):
        TorchServingEngine.get_or_create(
            ServingConfig.from_dict({"model": "tiny", "prefix-store": {"t0-bytes": 0}}), "cpu")
    qos = {"model": "tiny", "model-dtype": "float32", "qos": {"classes": {}}}
    q = TorchServingEngine.get_or_create(ServingConfig.from_dict(qos), "cpu")
    assert TorchServingEngine.get_or_create(ServingConfig.from_dict(qos), "cpu") is q
    assert q is not b and q.stats()["scheduler"]["policy"] == "qos"
    if not _cuda():
        with pytest.raises(RuntimeError, match="cuda"):
            TorchServingEngine.get_or_create(cfg)


def _cuda() -> bool:
    import torch

    return torch.cuda.is_available()


def test_chip_smoke_resource_is_the_chat_example():
    """``chip_smoke.py`` path E writes the chat example's resource out (the
    card may lack PyYAML): it must equal the example's file."""
    import chip_smoke

    example = yaml.safe_load(
        (REPO / "examples/applications/chat-completions/configuration.yaml").read_text())
    assert chip_smoke.CHAT_EXAMPLE_RESOURCE == example["configuration"]["resources"][0]

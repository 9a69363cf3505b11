"""The port's request tracing (``langstream_tpu_torch/core/tracing.py``)
against the JAX package's ``core/tracing.py``.

Nothing here computes in floating point but timings, and timings are
compared only as orderings and bounds: the header round trip, the
malformed values, the buffer's bounds and summaries are exact; the spans
of the same traced request on both engines have the same names, parents
and attributes (exact), durations aside.
"""

import asyncio
import time

import numpy as np
import pytest

from langstream_tpu.core import tracing as jax_tracing
from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.core import tracing
from langstream_tpu_torch.core.tracing import SpanBuffer, TraceContext, start_span
from langstream_tpu_torch.serving import kvtransfer
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
from test_torch_engine import flatten_jax_params
from test_torch_journey import port_engine

TINY = {"model": "tiny", "model-dtype": "float32", "slots": 2, "max-seq-len": 128,
        "decode-chunk": 4, "kv-layout": "paged", "kv-block-size": 16,
        "prefix-cache": False}


@pytest.fixture(autouse=True)
def _fresh_spans(monkeypatch):
    """Both buffers empty, and the port's unmirrored (a launcher registered
    earlier in this process may have pointed it at the JAX buffer)."""
    monkeypatch.setattr(tracing.SPANS, "mirror", None)
    tracing.SPANS.clear()
    jax_tracing.SPANS.clear()
    yield
    tracing.SPANS.clear()
    jax_tracing.SPANS.clear()


def _shape(spans):
    """Span names, parents and attributes, durations and ids aside."""
    return sorted((s["name"], s["parent_id"], tuple(sorted((s.get("attributes") or {}).items())))
                  for s in spans)


def test_header_round_trip_equals_jax():
    for _ in range(8):
        ctx = TraceContext.new()
        header = ctx.to_header()
        assert header == jax_tracing.TraceContext(ctx.trace_id, ctx.span_id).to_header()
        assert TraceContext.parse(header) == ctx
        assert jax_tracing.TraceContext.parse(header).trace_id == ctx.trace_id
        child = ctx.child()
        assert child.trace_id == ctx.trace_id and child.span_id != ctx.span_id
    assert len(tracing.fresh_trace_id()) == 32


@pytest.mark.parametrize("bad", [
    None, "", "not-a-traceparent", "00-zz-yy-01",
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    {"nested": "junk"}, 42,
])
def test_malformed_headers_parse_as_jax(bad):
    assert TraceContext.parse(bad) is None
    assert jax_tracing.TraceContext.parse(bad) is None


def test_start_span_parent_resolution_and_ambient_context():
    root = start_span("root", service="svc")
    assert root.parent_id is None
    child = start_span("child", service="svc", parent=root)
    assert (child.trace_id, child.parent_id) == (root.trace_id, root.span_id)
    from_header = start_span("h", service="svc", parent=root.context().to_header())
    assert from_header.trace_id == root.trace_id
    token = tracing.set_current(root.context())
    try:
        assert tracing.current_context() == root.context()
        assert start_span("amb", service="svc").trace_id == root.trace_id
    finally:
        tracing.reset_current(token)
    assert tracing.current_context() is None
    assert start_span("junk", service="svc", parent="garbage").parent_id is None


def test_span_end_idempotent_and_buffered():
    with start_span("op", service="svc", attributes={"k": "v"}) as span:
        pass
    span.end(error="late")
    spans = tracing.SPANS.spans(span.trace_id)
    assert len(spans) == 1 and spans[0]["attributes"] == {"k": "v"}
    assert "error" not in spans[0]
    failed = start_span("boom", service="svc")
    failed.end(error=ValueError("bad"))
    assert tracing.SPANS.spans(failed.trace_id)[0]["error"] == "bad"


def test_record_span_retroactive_timing():
    ctx = TraceContext.new()
    t1 = time.monotonic() - 0.25
    before_ms = time.time() * 1000.0
    tracing.record_span("phase", "svc", ctx, t1, t1 + 0.2, attributes={"n": 1})
    (span,) = tracing.SPANS.spans(ctx.trace_id)
    assert span["parent_id"] == ctx.span_id and span["attributes"] == {"n": 1}
    assert abs(span["duration_ms"] - 200.0) < 1.0
    # anchored at the phase's start, a quarter second back
    assert before_ms - 300.0 < span["start_ms"] < before_ms - 200.0
    # a reversed interval clamps to zero, never raises
    tracing.record_span("neg", "svc", ctx, t1 + 1.0, t1)
    assert tracing.SPANS.spans(ctx.trace_id)[-1]["duration_ms"] == 0.0


def test_buffer_bounds_and_summaries_equal_jax():
    rng = np.random.default_rng(7)
    port, jax = SpanBuffer(maxlen=16), jax_tracing.SpanBuffer(maxlen=16)
    traces = [f"{i:032x}" for i in range(1, 5)]
    for i in range(60):
        span = {
            "trace_id": traces[int(rng.integers(len(traces)))],
            "span_id": f"{i:016x}",
            "parent_id": f"{int(rng.integers(max(i, 1))):016x}" if rng.random() < 0.6 else None,
            "name": f"op{int(rng.integers(5))}",
            "service": f"svc{int(rng.integers(3))}",
            "start_ms": float(rng.integers(0, 10_000)),
            "duration_ms": float(rng.integers(0, 500)),
        }
        if rng.random() < 0.2:
            span["error"] = "e"
        port.add(dict(span))
        jax.add(dict(span))
    assert len(port.snapshot()) == 16
    assert port.snapshot() == jax.snapshot()
    assert port.summaries() == jax.summaries()
    for t in traces:
        assert port.spans(t) == jax.spans(t)
    port.clear()
    assert port.snapshot() == [] and port.summaries() == []


def test_buffer_size_from_the_environment(monkeypatch):
    for value, want in (("4096", 4096), ("8", 64), ("junk", 2048)):
        monkeypatch.setenv("LS_TPU_TRACE_BUFFER", value)
        assert tracing._buffer_size() == jax_tracing._buffer_size() == want


def test_mirror_adds_every_span_to_a_second_buffer(monkeypatch):
    other = SpanBuffer()
    monkeypatch.setattr(tracing.SPANS, "mirror", other)
    ctx = TraceContext.new()
    tracing.record_span("phase", "svc", ctx, 1.0, 2.0)
    assert tracing.SPANS.spans(ctx.trace_id) == other.spans(ctx.trace_id) != []


def test_one_trace_context_copy_in_the_port():
    assert kvtransfer.TraceContext is TraceContext
    ctx = TraceContext.new()
    assert kvtransfer.trace_context({"trace": ctx.to_header()}) == ctx
    assert kvtransfer.journey_id({"trace": ctx.to_header()}) == ctx.trace_id
    assert kvtransfer.journey_id({"journey": "j", "trace": ctx.to_header()}) == "j"
    assert kvtransfer.trace_context({"trace": "junk"}) is None


def _traced_run(engine, mod, prompts):
    """``prompts`` one after another on ``engine`` under one ambient trace of
    ``mod`` (either package's tracing module); (the trace, the results)."""
    async def main():
        ctx = mod.TraceContext.new()
        token = mod.set_current(ctx)
        try:
            results = [await engine.generate(p, {"max-tokens": 5}) for p in prompts]
        finally:
            mod.reset_current(token)
            await engine.close()
        return ctx, results

    return asyncio.run(main())


def _weights():
    return flatten_jax_params(TpuServingEngine(JaxServingConfig.from_dict(TINY)).params)


def test_same_traced_request_same_spans_on_both_engines():
    prompts = ["trace me", "and me too"]
    jax_ctx, jax_results = _traced_run(
        TpuServingEngine(JaxServingConfig.from_dict(TINY)), jax_tracing, prompts)
    ctx, results = _traced_run(port_engine(TINY, _weights()), tracing, prompts)
    assert [r["tokens"] for r in results] == [r["tokens"] for r in jax_results]
    port_spans = tracing.SPANS.spans(ctx.trace_id)
    jax_spans = jax_tracing.SPANS.spans(jax_ctx.trace_id)
    assert len(port_spans) == 6
    rename = {jax_ctx.span_id: ctx.span_id}
    assert _shape(port_spans) == _shape(
        [{**s, "parent_id": rename.get(s["parent_id"], s["parent_id"])} for s in jax_spans])
    assert {s["service"] for s in port_spans} == {s["service"] for s in jax_spans} == {
        "engine:tiny"}
    by_name = {}
    for s in port_spans:
        by_name.setdefault(s["name"], []).append(s)
        assert s["duration_ms"] >= 0.0
    # the phases tile each request in order: queue, prefill, decode
    for q, p, d in zip(by_name["engine.queue"], by_name["engine.prefill"],
                       by_name["engine.decode"]):
        assert q["start_ms"] <= p["start_ms"] <= d["start_ms"]


def test_no_ambient_trace_records_no_span():
    async def main():
        engine = TorchServingEngine(ServingConfig.from_dict(TINY), device="cpu")
        try:
            await engine.generate("untraced", {"max-tokens": 4})
        finally:
            await engine.close()

    asyncio.run(main())
    assert tracing.SPANS.snapshot() == []


def test_handoff_spans_join_one_trace_on_both_packages():
    """A traced request through a prefill pool and a decode pool: the
    prefill side records queue, prefill and kv-export, the decode side
    kv-import and the finish phases, all under the one trace, in both
    packages alike."""
    flat = _weights()

    def run(make, mod):
        async def main():
            pre = make({**TINY, "pool-role": "prefill"})
            dec = make({**TINY, "pool-role": "decode"})
            ctx = mod.TraceContext.new()
            token = mod.set_current(ctx)
            try:
                ticket = await pre.generate("hand me off", {"max-tokens": 6})
            finally:
                mod.reset_current(token)
            try:
                result = await dec.import_handoff(pre.take_export(ticket["handoff"]))
            finally:
                await pre.close()
                await dec.close()
            return ctx, result

        return asyncio.run(main())

    jax_ctx, jax_result = run(lambda c: TpuServingEngine(JaxServingConfig.from_dict(c)),
                              jax_tracing)
    ctx, result = run(lambda c: port_engine(c, flat), tracing)
    assert result["tokens"] == jax_result["tokens"]
    spans = tracing.SPANS.spans(ctx.trace_id)
    assert sorted(s["name"] for s in spans) == sorted(
        s["name"] for s in jax_tracing.SPANS.spans(jax_ctx.trace_id)) == sorted([
            "engine.queue", "engine.prefill", "engine.kv-export", "engine.kv-import",
            "engine.queue", "engine.prefill", "engine.decode"])
    assert all(s["parent_id"] == ctx.span_id for s in spans)


def test_provider_runs_requests_under_the_ambient_trace():
    """The provider hands the caller's ambient trace (a header value) to the
    engine: the request's spans and journey key follow it."""
    from langstream_tpu_torch.agents.provider import TorchServiceProvider

    ctx = TraceContext.new()
    provider = TorchServiceProvider({"type": "tpu-serving-configuration", **TINY},
                                    device="cpu", ambient_trace=ctx.to_header)

    async def main():
        service = provider.get_completions_service({})
        try:
            return await service.text_completions("provider trace", {"max-tokens": 3})
        finally:
            TorchServingEngine.reset_instances()
            await service.engine.close()

    result = asyncio.run(main())
    assert result.num_completion_tokens == 3
    assert {s["name"] for s in tracing.SPANS.spans(ctx.trace_id)} == {
        "engine.queue", "engine.prefill", "engine.decode"}
    assert tracing.current_context() is None

"""The port's cross-replica failure domain (``langstream_tpu_torch/
serving/handoff.py`` and the engine's hooks) against the JAX package's.

Exact throughout: the deadline helpers, ``RetryPolicy.delay_s`` (the
hashed jitter) and the breaker's state sequence under a scripted clock
equal the JAX module's; each chainer outcome of ``tests/test_handoff.py``
(a Retry-After hold, a timeout that reroutes, 409 and 504 terminal, the
cap's local fallback, a lost export, an ``http-import`` drop, an
``http-export`` fault) is the same for the port's chainer over a port
prefill engine as for the JAX chainer over a JAX prefill engine, under the
same scripted transport and the platform's real ``ReplicaRouter``; greedy
tokens are compared exactly (f32 on the JAX engine's weights). The chainer
also runs over the pod's real HTTP plane through ``serve_torch.register``,
and a settle retires the journal entry.
"""

import asyncio
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from langstream_tpu.gateway.router import ReplicaRouter
from langstream_tpu.serving import handoff as jax_handoff
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu.serving.engine import _deadline_from_options as jax_deadline_from_options
from langstream_tpu_torch.serving import handoff, journey, kvtransfer
from langstream_tpu_torch.serving.faults import FaultInjector, FaultPlan
from langstream_tpu_torch.serving.handoff import (
    BreakerSpec,
    CircuitBreaker,
    HandoffChainer,
    RetryPolicy,
)
from langstream_tpu_torch.serving.engine import TorchServingEngine
from test_torch_journey import TINY, both, kinds, ledger_of, port_engine

PAIR = {**TINY, "slots": 2, "max-seq-len": 128, "kv-pool-blocks": 24}


@pytest.fixture(autouse=True)
def _unmirrored(monkeypatch):
    monkeypatch.setattr(journey.JOURNEYS, "mirror", None)


@pytest.fixture(scope="module")
def flat():
    return both(PAIR, lambda e: asyncio.sleep(0))[2]


# ---------------------------------------------------------------------------
# deadlines, retry policy, breaker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value", [None, "garbage", "", -5.0, 0, "1234.5", 1234.5,
                                   float("inf"), [1]])
def test_parse_deadline_equals_jax(value):
    assert handoff.parse_deadline(value) == jax_handoff.parse_deadline(value)


def test_remaining_and_socket_timeout_equal_jax():
    now = 1000.0
    for deadline in (None, 1002.5, 990.0, now + 300.0, now + 3.0, now + 0.001, now - 5.0):
        assert handoff.remaining_s(deadline, now) == jax_handoff.remaining_s(deadline, now)
        assert handoff.socket_timeout_s(deadline, now) == jax_handoff.socket_timeout_s(
            deadline, now)
    assert handoff.DEADLINE_HEADER == jax_handoff.DEADLINE_HEADER
    assert (handoff.SOCKET_TIMEOUT_FLOOR_S, handoff.SOCKET_TIMEOUT_CAP_S) == (
        jax_handoff.SOCKET_TIMEOUT_FLOOR_S, jax_handoff.SOCKET_TIMEOUT_CAP_S)


def test_deadline_from_options_equals_the_jax_engine():
    for options in ({}, {"deadline": "garbage"}, {"deadline": 1234.5},
                    {"deadline": 99.0, "deadline-s": 5}, {"deadline-s": "x"}):
        assert handoff.deadline_from_options(options) == jax_deadline_from_options(options)
    t0 = time.time()
    rel = handoff.deadline_from_options({"deadline-s": 5})
    assert t0 + 4.5 <= rel <= time.time() + 5.5
    assert handoff.deadline_from_options({"deadline-s": -3}) <= time.time()


def test_retry_policy_schedule_equals_jax():
    policies = [(5, 0.1, 0.5, 0.25), (3, 0.05, 2.0, 0.25), (8, 0.01, 1.0, 1.0),
                (4, 0.1, 0.5, 0.0)]
    for args in policies:
        port, jax = RetryPolicy(*args), jax_handoff.RetryPolicy(*args)
        for key in ("", "req-1", "tiny-00000001", "ab" * 16):
            assert [port.delay_s(a, key) for a in range(10)] == [
                jax.delay_s(a, key) for a in range(10)]
    for bad in ({"attempts": 0}, {"backoff_s": 0.0}, {"backoff_s": 1.0, "backoff_cap_s": 0.5},
                {"jitter": 1.5}):
        with pytest.raises(ValueError) as port_err:
            RetryPolicy(**bad)
        with pytest.raises(ValueError) as jax_err:
            jax_handoff.RetryPolicy(**bad)
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("seed", range(4))
def test_breaker_state_sequence_equals_jax(seed):
    rng = np.random.default_rng(seed)
    spec = dict(failures=int(rng.integers(1, 4)), window_s=10.0, open_s=5.0,
                half_open_probes=int(rng.integers(1, 3)))
    clock = [0.0]
    port = CircuitBreaker(BreakerSpec(**spec), clock=lambda: clock[0])
    jax = jax_handoff.CircuitBreaker(jax_handoff.BreakerSpec(**spec), clock=lambda: clock[0])
    trace = []
    for _ in range(200):
        clock[0] += float(rng.choice([0.0, 0.5, 2.0, 6.0, 12.0]))
        op = int(rng.integers(4))
        if op == 0:
            kind = "timeout" if rng.random() < 0.5 else "error"
            got = (port.record_failure(kind), jax.record_failure(kind))
        elif op == 1:
            got = (port.record_success(), jax.record_success())
        elif op == 2:
            got = (port.can_serve(), jax.can_serve())
        else:
            port.note_probe()
            jax.note_probe()
            got = (port.state, jax.state)
        assert got[0] == got[1]
        assert port.stats() == jax.stats()
        trace.append(port.state)
    assert {"closed", "open"} <= set(trace)


def test_breaker_spec_validation_equals_jax():
    for bad in ({"failures": 0}, {"window_s": 0}, {"open_s": -1}, {"half_open_probes": 0}):
        with pytest.raises(ValueError) as port_err:
            BreakerSpec(**bad)
        with pytest.raises(ValueError) as jax_err:
            jax_handoff.BreakerSpec(**bad)
        assert str(port_err.value) == str(jax_err.value)


def test_aiohttp_is_imported_only_by_the_http_transport():
    code = ("import sys; import langstream_tpu_torch.serving.handoff as h; "
            "assert 'aiohttp' not in sys.modules; h.http_transport(lambda r: r); "
            "assert 'aiohttp' in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_the_router_route_seam_takes_the_port_injector():
    router = ReplicaRouter(clock=lambda: 0.0)
    router.observe([{"replica": "dec-0", "queued": 0, "occupancy": 0, "slots": 4,
                     "pool": "decode"}])
    router.fault_injector = FaultInjector((
        FaultPlan(site="route", shape="drop", count=1),
        FaultPlan(site="route", shape="error", count=1, message="registry down")))
    assert router.pick(phase="decode") is None
    with pytest.raises(RuntimeError, match="registry down"):
        router.pick(phase="decode")
    assert router.pick(phase="decode") == "dec-0"


# ---------------------------------------------------------------------------
# the chainer over real engines: the port's against the JAX package's
# ---------------------------------------------------------------------------

PROMPT = "chained handoff prompt"


def _router(replicas=("dec-0", "dec-1"), failures=2):
    router = ReplicaRouter(clock=lambda: 0.0,
                           breaker=jax_handoff.BreakerSpec(failures=failures, open_s=5.0))
    router.observe([{"replica": r, "queued": i, "occupancy": 0, "slots": 4, "pool": "decode"}
                    for i, r in enumerate(replicas)])
    return router


async def _no_sleep(_s):
    return None


def _scripted(script):
    """A transport answering from ``script[replica]``: an exception class to
    raise, or a status code (200 answers a fixed body)."""
    calls = []

    async def transport(replica, payload, headers, timeout_s):
        calls.append(replica)
        answer = script[replica]
        if isinstance(answer, type):
            raise answer("refused") if answer is ConnectionError else answer()
        if answer == 200:
            return 200, {"tokens": [5], "finish_reason": "stop"}, {}
        if answer == 503:
            return 503, {"retry_after_s": 9.0}, {}
        return answer, {"error": f"scripted {answer}"}, {}

    return transport, calls


CASES = {
    "retry-after-hold": ({"dec-0": 503, "dec-1": 200}, {}),
    "timeout-reroute": ({"dec-0": asyncio.TimeoutError, "dec-1": 200}, {}),
    "409-terminal": ({"dec-0": 409, "dec-1": 409}, {}),
    "504-terminal": ({"dec-0": 504, "dec-1": 504}, {}),
    "cap-local-fallback": ({"dec-0": ConnectionError, "dec-1": ConnectionError},
                           {"policy": (3, 0.001)}),
    "lost-export": ({"dec-0": 200, "dec-1": 200}, {"lost": True}),
    "http-import-drop": ({"dec-0": 200, "dec-1": 200},
                         {"faults": [{"site": "http-import", "shape": "drop", "count": 1}]}),
    "http-export-fault": ({"dec-0": 200, "dec-1": 200},
                          {"faults": [{"site": "http-export", "shape": "drop", "count": 1}]}),
}


def _chain_outcome(case):
    script, opts = CASES[case]

    async def scenario(pre):
        is_port = isinstance(pre, TorchServingEngine)
        mod = handoff if is_port else jax_handoff
        router = _router()
        transport, calls = _scripted(script)
        policy = mod.RetryPolicy(*opts["policy"]) if "policy" in opts else None
        chainer = mod.HandoffChainer(pre, router=router, transport=transport, policy=policy,
                                     sleep=_no_sleep)
        ticket = await pre.generate(PROMPT, {"max-tokens": 10})
        attempts = [ticket if not opts.get("lost") else {"handoff": "gone"}]
        if "http-export" in case:
            attempts.append(ticket)  # the drop disarmed: the retried pickup lands
        outcomes = []
        for t in attempts:
            try:
                result = await chainer.chain(t)
                outcomes.append(("ok", result["tokens"], result.get("finish_reason")))
            except Exception as e:  # the outcome is the exception's class
                outcomes.append(("raised", type(e).__name__))
        await asyncio.sleep(0.05)
        flight = [e["kind"] for e in pre.flight.recent_events(0)
                  if e["kind"].startswith(("handoff-", "breaker-", "fault-injected"))]
        rstats = router.stats()
        stats = pre.stats()
        return {
            "outcomes": outcomes, "calls": calls, "chainer": chainer.stats(),
            "held": rstats["held_replicas"],
            "breakers": {r: b["state"] for r, b in rstats["breakers"].items()},
            "flight": flight,
            "survival": {k: stats["survival"][k] for k in ("handoff_retries",
                                                            "handoff_fallbacks")},
            "kvtransfer": {k: stats["kvtransfer"][k] for k in (
                "retries", "fallbacks", "unsettled_handoffs", "exports", "imports")},
            "journeys": [kinds(ledger_of(pre).events(j)) for j in ledger_of(pre).ids()[-1:]],
        }

    cfg = {**PAIR, "pool-role": "prefill", "faults": opts.get("faults", [])}
    return both(cfg, scenario)


@pytest.mark.parametrize("case", list(CASES))
def test_chainer_outcome_equals_jax(case):
    want, got, _ = _chain_outcome(case)
    assert got == want
    outcomes = got["outcomes"]
    if case == "retry-after-hold":
        assert got["calls"] == ["dec-0", "dec-1"] and got["held"] == {"dec-0": 9.0}
        assert outcomes == [("ok", [5], "stop")] and got["survival"]["handoff_retries"] == 1
    elif case == "timeout-reroute":
        assert got["calls"] == ["dec-0", "dec-1"] and outcomes[0][0] == "ok"
    elif case == "409-terminal":
        assert outcomes == [("raised", "LookupError")] and got["calls"] == ["dec-0"]
    elif case == "504-terminal":
        assert outcomes == [("raised", "DeadlineExceeded")]
    elif case == "cap-local-fallback":
        assert got["survival"] == {"handoff_retries": 3, "handoff_fallbacks": 1}
        assert got["breakers"]["dec-0"] == "open" and "breaker-open" in got["flight"]
        assert got["kvtransfer"]["imports"] == 1 and got["kvtransfer"]["exports"] == 1
        # the fallback's journey runs export → ... → finish on the prefill engine
        assert got["journeys"][0][-1] == "finish" and "import" in got["journeys"][0]
    elif case == "lost-export":
        assert outcomes == [("raised", "HandoffLost")] and got["calls"] == []
    elif case == "http-import-drop":
        assert got["calls"] == ["dec-1"] and "fault-injected" in got["flight"]
    elif case == "http-export-fault":
        assert outcomes == [("raised", "HandoffLost"), ("ok", [5], "stop")]
    assert got["kvtransfer"]["unsettled_handoffs"] == 0


def test_local_fallback_is_byte_identical_to_combined(flat):
    """Every decode replica dead: past the cap the export decodes on the
    prefill engine itself, token for token the combined engine's, and the
    request never re-exports."""
    async def run(cfg):
        engine = port_engine(cfg, flat)
        try:
            if cfg.get("pool-role") != "prefill":
                return await engine.generate(PROMPT, {"max-tokens": 10})
            chainer = HandoffChainer(
                engine, router=_router(("dead-0",), failures=1),
                transport=_scripted({"dead-0": ConnectionError})[0],
                policy=RetryPolicy(attempts=2, backoff_s=0.005))
            result = await chainer.chain(await engine.generate(PROMPT, {"max-tokens": 10}))
            timing = list(engine.request_timings)[-1]
            return result, chainer.fallbacks, timing.get("imported"), engine.kv_exports_total
        finally:
            await engine.close()

    combined = asyncio.run(run(PAIR))
    result, fallbacks, imported, exports = asyncio.run(run({**PAIR, "pool-role": "prefill"}))
    assert result["tokens"] == combined["tokens"] and result["text"] == combined["text"]
    assert (fallbacks, imported, exports) == (1, 1.0, 1)


def test_local_fallback_admits_only_its_own_export(flat):
    async def main():
        pre = port_engine({**PAIR, "pool-role": "prefill"}, flat)
        other = port_engine({**PAIR, "pool-role": "prefill"}, flat)
        try:
            own = pre.take_export((await pre.generate(PROMPT, {"max-tokens": 6}))["handoff"])
            foreign = other.take_export(
                (await other.generate("another prompt", {"max-tokens": 6}))["handoff"])
            with pytest.raises(kvtransfer.LayoutMismatch):
                await pre.import_handoff(own)  # no fallback: a prefill pool refuses
            with pytest.raises(kvtransfer.LayoutMismatch, match="own exports"):
                await pre.import_handoff(foreign, local_fallback=True)
            result = await pre.import_handoff(own, local_fallback=True)
            with pytest.raises(kvtransfer.LayoutMismatch, match="own exports"):
                await pre.import_handoff(own, local_fallback=True)  # once
            return result
        finally:
            await pre.close()
            await other.close()

    assert len(asyncio.run(main())["tokens"]) == 6


def test_wire_header_carries_trace_and_journey(flat):
    from langstream_tpu_torch.core import tracing

    async def main():
        pre = port_engine({**PAIR, "pool-role": "prefill"}, flat)
        dec = port_engine({**PAIR, "pool-role": "decode"}, flat)
        ctx = tracing.TraceContext.new()
        token = tracing.set_current(ctx)
        try:
            ticket = await pre.generate(PROMPT, {"max-tokens": 6})
        finally:
            tracing.reset_current(token)
        try:
            entry = pre.take_export_entry(ticket["handoff"])
            header = kvtransfer.peek_header(entry["payload"])
            await dec.import_handoff(entry["payload"])
            return ctx, entry, header
        finally:
            await pre.close()
            await dec.close()

    ctx, entry, header = asyncio.run(main())
    assert header["trace"] == entry["trace"] == ctx.to_header()
    assert header["journey"] == entry["journey"] == ctx.trace_id
    events = journey.JOURNEYS.events(ctx.trace_id)
    assert kinds(events) == ["submit", "admit", "first-token", "export", "export-taken",
                             "import-received", "import", "first-step", "finish"]


def test_settle_retires_the_journal_entry(tmp_path, flat):
    async def main():
        pre = port_engine({**PAIR, "pool-role": "prefill", "journal-dir": str(tmp_path / "j")},
                          flat)
        dec = port_engine({**PAIR, "pool-role": "decode"}, flat)

        async def transport(replica, payload, headers, timeout_s):
            return 200, await dec.import_handoff(payload), {}

        chainer = HandoffChainer(pre, router=_router(("live",)), transport=transport)
        try:
            ticket = await pre.generate("settle me", {"max-tokens": 6})
            assert pre.journal.flush(5.0) and pre.journal.depth() == 1
            result = await chainer.chain(ticket)
            assert pre.journal.flush(5.0)
            # the pull model settles at the pickup instead
            pulled = await pre.generate("pull me", {"max-tokens": 6})
            assert pre.journal.flush(5.0) and pre.journal.depth() == 1
            assert pre.take_export(pulled["handoff"]) is not None
            assert pre.journal.flush(5.0)
            return result, pre.journal.depth(), pre.stats()["kvtransfer"]["unsettled_handoffs"]
        finally:
            await pre.close()
            await dec.close()

    result, depth, unsettled = asyncio.run(main())
    assert len(result["tokens"]) == 6 and depth == 0 and unsettled == 0


def test_chainer_over_the_pod_http_plane(monkeypatch, flat):
    """The production transport end to end through ``serve_torch.register``:
    the port chainer offers the payload over aiohttp to the pod's
    ``/kv/import`` (a closed port for the dead replica, the real pod server
    for the live one), which lands it in the port's decode pool; the result
    equals the combined engine's."""
    import socket

    import serve_torch
    from langstream_tpu.agents import services
    from langstream_tpu.runtime import pod
    from langstream_tpu.serving import engine as jax_engine_module
    from langstream_tpu_torch.core.tracing import SPANS
    from langstream_tpu_torch.serving.engine import ServingConfig

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    for name in serve_torch.POD_SEAM:
        monkeypatch.setattr(jax_engine_module, name, getattr(jax_engine_module, name))
    monkeypatch.setattr(services, "_provider_factories", dict(services._provider_factories))
    monkeypatch.setattr(SPANS, "mirror", SPANS.mirror)
    monkeypatch.setattr(TpuServingEngine, "_instances", {})
    monkeypatch.setattr(TorchServingEngine, "_instances", {})
    serve_torch.register(device="cpu")
    live, dead = free_port(), free_port()
    monkeypatch.setenv("LS_HTTP_PORT", str(live))

    async def main():
        combined = port_engine(PAIR, flat)
        want = await combined.generate(PROMPT, {"max-tokens": 8})
        await combined.close()
        pre = port_engine({**PAIR, "pool-role": "prefill"}, flat)
        dec = port_engine({**PAIR, "pool-role": "decode"}, flat)
        TorchServingEngine._instances[(ServingConfig.from_dict({**PAIR, "pool-role": "decode"}),
                                       "cpu", None)] = dec
        server = await pod._serve_info(None, health=pod.PodHealth())
        urls = {"dead-0": f"http://127.0.0.1:{dead}", "live-1": f"http://127.0.0.1:{live}"}
        chainer = HandoffChainer(
            pre, router=_router(("dead-0", "live-1")),
            transport=handoff.http_transport(lambda replica: urls[replica]),
            policy=RetryPolicy(attempts=4, backoff_s=0.005, backoff_cap_s=0.02))
        try:
            ticket = await pre.generate(PROMPT, {"max-tokens": 8, "deadline-s": 120})
            got = await chainer.chain(ticket)
            return want, got, chainer.stats(), pre.stats()["kvtransfer"], dec.kv_imports_total
        finally:
            server.close()
            await pre.close()
            await dec.close()

    want, got, stats, kv, imports = asyncio.run(main())
    assert got["tokens"] == want["tokens"] and got["text"] == want["text"]
    assert stats["retries"] >= 1 and stats["fallbacks"] == 0 and imports == 1
    assert kv["unsettled_handoffs"] == 0 and kv["retries"] == stats["retries"]

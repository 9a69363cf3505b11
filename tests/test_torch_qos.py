"""The admission plane of the port against the JAX package's.

The policy units (token buckets, ``QosSpec``, ``TenantLimiter``,
``QosScheduler``) run the same operations under one fake clock in both
packages and must give the same answers: dequeue order, ``RateLimited``
reasons and retry hints, preemption victims and ``to_dict()``. The tiny
f32 engine then serves the same requests on the same parameters in both
packages, in four layouts (paged, paged int8 KV, prefix cache, the
sequential loop): a batch request preempted under KV pressure by an
interactive arrival resumes to the tokens of its unpreempted run and of
the JAX engine, with the same ``preempt``/``resume`` events; a WDRR
saturation, a tenant's token-bucket throttle and the admission-estimate
deadline shed give the JAX engine's admission order, counters, refusals
and tokens. moe-tiny, whose expert capacity follows the batch, is held to
the JAX engine under the same preemption schedule, not to an unpreempted
run.
"""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from langstream_tpu.serving import qos as jax_qos
from langstream_tpu.serving import scheduler as jax_sched
from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu.serving.handoff import DeadlineExceeded as JaxDeadlineExceeded
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.serving import qos, scheduler
from langstream_tpu_torch.serving.handoff import DeadlineExceeded
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
from test_torch_engine import flatten_jax_params
from test_torch_pipeline import _engine as pipeline_engine
from test_torch_pipeline import check_dispatch_path_makes_no_blocking_copy


class _Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _req(priority="default", tenant="", enqueue=0.0, generated=(), preemptions=0):
    return SimpleNamespace(priority=priority, tenant=tenant, enqueue_time=enqueue,
                           generated=list(generated), preemptions=preemptions,
                           max_tokens=8)


PACKAGES = {"port": (qos, scheduler), "jax": (jax_qos, jax_sched)}

SPECS = [
    {},
    {"classes": {"interactive": {"weight": 16, "tbt-p99-s": 0.25}},
     "tenants": {"bulk": {"requests-per-s": 5, "burst": 10}}, "max-preemptions": 3},
    {"enabled": "false", "preempt": False, "deadline-headers": True},
    {"classes": {"batch": {"queue-limit": 3, "deadline-s": 30}},
     "tenants": {"*": {"tokens-per-s": 20, "token-burst": 40},
                 "acme": {"requests-per-s": 1, "adapter": "acme-ft"}}},
]


# ---------------------------------------------------------------------------
# policy units, under one fake clock
# ---------------------------------------------------------------------------


def test_token_bucket_matches_jax():
    out = {}
    for name, (q, _) in PACKAGES.items():
        clock = _Clock()
        b = q.TokenBucket(rate=2.0, burst=4.0, clock=clock)
        trace = [b.try_acquire(4), b.try_acquire(1), b.retry_after(1)]
        clock.t = 0.5
        trace += [b.try_acquire(1), b.available()]
        b.debit(10)
        trace += [b.available(), b.retry_after(0)]
        clock.t = 100.0
        trace.append(b.available())
        zero = q.TokenBucket(rate=0.0, burst=1.0, clock=clock)
        zero.debit(2)
        trace.append(zero.retry_after(1))
        out[name] = trace
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_qos_spec_parses_as_jax(i):
    port = qos.QosSpec.from_dict(SPECS[i])
    jax = jax_qos.QosSpec.from_dict(SPECS[i])
    assert port.to_dict() == jax.to_dict()
    assert qos.QosSpec.from_dict(port.to_dict()) == port
    assert qos.QosSpec.from_dict(port) is port and qos.QosSpec.from_dict(None) is None
    hash(port)  # rides inside the hashable ServingConfig
    for cls in ("interactive", "default", "batch", "vip"):
        assert port.class_policy(cls).to_dict() == jax.class_policy(cls).to_dict()
    for tenant in ("bulk", "acme", "nobody"):
        p, j = port.tenant_policy(tenant), jax.tenant_policy(tenant)
        assert (p and p.to_dict()) == (j and j.to_dict())
    for value in ("interactive", "BATCH ", "vip", None, ""):
        assert qos.normalize_priority(value) == jax_qos.normalize_priority(value)
        assert qos.priority_rank(qos.normalize_priority(value)) == jax_qos.priority_rank(
            jax_qos.normalize_priority(value))


@pytest.mark.parametrize(
    "bad",
    [
        {"classes": {"vip": {}}},
        {"classes": {"batch": {"weight": 0}}},
        {"classes": {"batch": {"queue-limit": 0}}},
        {"classes": "nope"},
        {"tenants": {"a": {"requests-per-s": -1}}},
        {"tenants": {"a": {"tokens-per-s": 0}}},
        {"max-preemptions": -1},
        {"classes": {"interactive": {"tbt-p99-s": 0}}},
        {"classes": {"default": {"deadline-s": 0}}},
        {"tenants": {"a": {"adapter": "bad name!"}}},
        {"tenants": ["a"]},
        "not a mapping",
    ],
)
def test_malformed_qos_specs_rejected_as_in_jax(bad):
    with pytest.raises(ValueError):
        jax_qos.QosSpec.from_dict(bad)
    with pytest.raises(ValueError):
        qos.QosSpec.from_dict(bad)


def _limiter_trace(q):
    clock = _Clock()
    spec = q.QosSpec.from_dict({"tenants": {
        "alice": {"requests-per-s": 1, "burst": 2},
        "bulk": {"tokens-per-s": 10, "token-burst": 10},
        "*": {"requests-per-s": 100},
    }})
    limiter = q.TenantLimiter(spec, clock=clock)
    trace = [limiter.admit_request("alice") for _ in range(3)]
    clock.t = 1.0
    trace.append(limiter.admit_request("alice"))
    trace.append(limiter.admit_request("bulk"))
    limiter.debit_tokens("bulk", 30)
    trace += [limiter.admit_request("bulk"), limiter.retry_after("bulk")]
    clock.t = 3.1
    trace += [limiter.admit_request("bulk"), limiter.retry_after("alice")]
    trace += [limiter.admit_request(f"anon-{i}") for i in range(3)]
    return trace, limiter.stats()


def test_tenant_limiter_matches_jax():
    assert _limiter_trace(qos) == _limiter_trace(jax_qos)


def _flood(q, s, spec: dict, pops: int):
    clock = _Clock()
    sched = s.QosScheduler(q.QosSpec.from_dict(spec), clock=clock)
    refusals = []
    for i in range(20):
        for cls, tenant in (("interactive", "live"), ("batch", "bulk"), ("default", "")):
            try:
                sched.submit(_req(cls, tenant=tenant, enqueue=float(i)))
            except q.RateLimited as e:
                refusals.append((i, cls, e.reason, e.retry_after))
        clock.t += 0.25
    order = []
    for _ in range(min(pops, sched.qsize())):
        head = sched.peek()
        popped = sched.pop()
        assert head is popped
        order.append((popped.priority, popped.enqueue_time))
    sched.requeue_front(_req("batch", preemptions=1, generated=[1, 2]))
    order.append((sched.peek().priority, sched.peek().preemptions))
    return order, refusals, sched.stats(), sched.depths()


@pytest.mark.parametrize("spec", [
    {},
    {"classes": {"interactive": {"weight": 4}, "batch": {"weight": 2, "queue-limit": 12}}},
    {"classes": {"default": {"queue-limit": 5}},
     "tenants": {"bulk": {"requests-per-s": 2, "burst": 3}}},
])
def test_wdrr_order_and_refusals_match_jax(spec):
    """Dequeue order, shed reasons with their retry hints, per-class and
    per-tenant counters, queue waits and depths: all equal."""
    port = _flood(qos, scheduler, spec, pops=40)
    jax = _flood(jax_qos, jax_sched, spec, pops=40)
    assert port == jax
    order, refusals, stats, _ = port
    assert {cls for cls, _ in order[:-1]} == {"interactive", "default", "batch"}
    if spec.get("tenants"):
        assert any(reason == "throttled" for _, _, reason, _ in refusals)
    if spec.get("classes", {}).get("default"):
        assert any(reason == "queue-full" for _, _, reason, _ in refusals)


def test_preempt_candidate_matches_jax():
    """Random running sets against random heads: the same victim."""
    rng = np.random.default_rng(7)
    classes = ["interactive", "default", "batch"]
    for spec in ({}, {"max-preemptions": 1}, {"preempt": False}):
        clock = _Clock(100.0)
        port = scheduler.QosScheduler(qos.QosSpec.from_dict(spec), clock=clock)
        jax = jax_sched.QosScheduler(jax_qos.QosSpec.from_dict(spec), clock=clock)
        seen = set()
        for _ in range(200):
            head = _req(classes[rng.integers(3)], enqueue=float(rng.uniform(90, 100)))
            running = [
                (slot, _req(classes[rng.integers(3)], enqueue=float(rng.uniform(-100, 100)),
                            generated=[1] * int(rng.integers(0, 40)),
                            preemptions=int(rng.integers(0, 3))))
                for slot in range(int(rng.integers(0, 6)))
            ]
            victim = port.preempt_candidate(head, running)
            assert victim == jax.preempt_candidate(head, running)
            seen.add(victim is None)
        assert seen == ({True} if spec.get("preempt") is False else {True, False})


def test_make_scheduler_and_fifo_match_jax():
    for spec in (None, {"enabled": False}, {}):
        port = scheduler.make_scheduler(qos.QosSpec.from_dict(spec))
        jax = jax_sched.make_scheduler(jax_qos.QosSpec.from_dict(spec))
        assert type(port).__name__ == type(jax).__name__
        for s in (port, jax):
            s.submit(_req())
            s.submit(_req("batch"))
            s.pop()
        stats = []
        for s in (port, jax):  # the queue waits are wall time here
            out = s.stats()
            for c in out.get("classes", {}).values():
                c.pop("queue_wait_p50_s"), c.pop("queue_wait_p95_s")
            stats.append(out)
        assert stats[0] == stats[1]
        assert port.depths() == jax.depths()
        assert len(port.drain()) == len(jax.drain()) == 1


def test_warmup_probes_bypass_policy_as_in_jax():
    spec = {"tenants": {"*": {"requests-per-s": 1, "burst": 1, "tokens-per-s": 1,
                              "token-burst": 1}}}
    out = []
    for q, s in PACKAGES.values():
        sched = s.QosScheduler(q.QosSpec.from_dict(spec), clock=_Clock())
        for _ in range(5):
            warm = _req()
            warm.warmup = True
            sched.submit(warm)
            warm.generated = [1] * 8
            sched.on_finished(warm)
        real = _req()
        real.warmup = False
        sched.submit(real)
        out.append(sched.stats())
    assert out[0] == out[1]
    assert out[0]["tenants"][""]["throttled"] == 0


# ---------------------------------------------------------------------------
# the engines: the same requests on the same parameters
# ---------------------------------------------------------------------------

BASE = {"model": "tiny", "model-dtype": "float32", "slots": 2, "max-seq-len": 256,
        "decode-chunk": 4, "kv-layout": "paged", "kv-block-size": 16,
        "prefix-cache": False}
LAYOUTS = {
    "paged": {},
    "paged-int8-kv": {"kv-quantize": "int8"},
    "prefix-cache": {"prefix-cache": True},
    "sequential": {"pipeline": False},
}
# tests/test_qos.py's preemption shape: 8 blocks of 16 (7 usable); the batch
# request reserves ceil((25 + 40 + 1) / 16) = 5, the interactive one needs 3
PREEMPT_POOL = {"kv-pool-blocks": 8}
BATCH_PROMPT = "quarterly report: revenue"
INTER_PROMPT = "what should i check now?"


async def _close(engine):
    await engine.close()
    if engine.block_mgr is not None:
        assert engine.block_mgr.stats()["reserved_blocks"] == 0


def _both(cfg: dict, scenario):
    """Run ``scenario(engine)`` on the JAX engine, then on the port's with
    the JAX engine's parameters; returns (jax result, port result)."""

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
            await _close(engine)

    return want, asyncio.run(port())


def _events(engine, *kinds):
    return [{k: v for k, v in e.items() if k not in ("seq", "t_ms", "m_s", "waited_ms")}
            for e in engine.flight.recent_events(0) if e["kind"] in kinds]


def _preemption(options=None, trigger=3):
    """The batch request alone, then again with an interactive arrival
    submitted from its ``trigger``-th token (awaited inside the delivery, so
    both engines see it queued at the same chunk boundary)."""
    options = options or {}

    async def scenario(engine):
        alone = await engine.generate(BATCH_PROMPT, {"max-tokens": 40, **options})
        seen, inter = 0, []

        async def on_token(token, logprob, last):
            nonlocal seen
            seen += 1
            if seen == trigger:
                inter.append(asyncio.ensure_future(engine.generate(
                    INTER_PROMPT, {"max-tokens": 8, "priority": "interactive"})))
                for _ in range(3):
                    await asyncio.sleep(0)

        resumed = await engine.generate(
            BATCH_PROMPT, {"max-tokens": 40, "priority": "batch", "qos-tenant": "bulk",
                           **options}, on_token=on_token)
        interactive = await inter[0]
        stats = engine.stats()["scheduler"]
        return (alone["tokens"], resumed["tokens"], resumed["text"], interactive["tokens"],
                _events(engine, "preempt", "resume"),
                {k: stats[k] for k in ("preempted", "resumed", "shed", "admitted")})

    return scenario


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_preemption_round_trip_matches_unpreempted_and_jax(layout):
    cfg = {**BASE, **LAYOUTS[layout], **PREEMPT_POOL, "qos": {}}
    want, got = _both(cfg, _preemption())
    assert got == want
    alone, resumed, _, interactive, events, counts = got
    assert resumed == alone and interactive
    assert counts["preempted"] == counts["resumed"] == 1
    assert [e["kind"] for e in events] == ["preempt", "resume"]
    assert events[0]["reason"] == "no-kv-blocks" and events[0]["priority"] == "batch"
    assert events[1]["generated"] >= 3


def test_penalized_resume_matches_jax():
    """With presence and frequency penalties the generated tokens feed the
    counts after the resume, as in the JAX engine (its resume prefill, like
    every prefill, samples without them)."""
    cfg = {**BASE, **PREEMPT_POOL, "qos": {}}
    want, got = _both(cfg, _preemption({"presence-penalty": 0.7, "frequency-penalty": 0.4}))
    assert got == want
    assert got[5]["preempted"] == 1


@pytest.mark.parametrize("pipeline", [True, False])
def test_moe_preemption_matches_jax_under_the_same_schedule(pipeline):
    cfg = {**BASE, **PREEMPT_POOL, "model": "moe-tiny", "pipeline": pipeline, "qos": {}}
    want, got = _both(cfg, _preemption())
    assert got == want
    assert got[5]["preempted"] == got[5]["resumed"] == 1


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_wdrr_saturation_matches_jax(layout):
    """A batch flood and a few interactive requests, all queued before the
    loop runs: the same admission order (first tokens), the same per-class
    and per-tenant counters, the same tokens."""
    cfg = {**BASE, **LAYOUTS[layout], "kv-pool-blocks": 40,
           "qos": {"classes": {"interactive": {"weight": 4},
                               "batch": {"weight": 1, "queue-limit": 64}}}}

    async def scenario(engine):
        await engine.generate("warm the engine up", {"max-tokens": 2})
        firsts = []

        def first_token(i):
            def on_token(token, logprob, last):
                if i not in firsts:
                    firsts.append(i)
            return on_token

        specs = ([(f"batch flood request {i}", "batch", "bulk") for i in range(10)]
                 + [(f"interactive request {i}", "interactive", "live") for i in range(4)])
        results = await asyncio.gather(*(
            engine.generate(prompt, {"max-tokens": 6, "priority": cls, "qos-tenant": tenant},
                            on_token=first_token(i))
            for i, (prompt, cls, tenant) in enumerate(specs)))
        stats = engine.stats()["scheduler"]
        for c in stats["classes"].values():
            c.pop("queue_wait_p50_s")
            c.pop("queue_wait_p95_s")
        return firsts, [r["tokens"] for r in results], stats

    want, got = _both(cfg, scenario)
    assert got == want
    firsts, _, stats = got
    assert stats["classes"]["interactive"]["admitted"] == 4
    assert stats["classes"]["batch"]["admitted"] == 10
    # interactive drains first, batch still gets its share in between
    assert max(firsts.index(i) for i in range(10, 14)) < max(firsts.index(i) for i in range(10))
    assert stats["tenants"]["bulk"]["submitted"] == 10


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tenant_throttle_and_queue_full_match_jax(layout):
    """Under one fake clock in both schedulers: a tenant that overdrew its
    token bucket is throttled with the same retry hint, a full class queue
    sheds, and both refusals are ``shed`` events."""
    cfg = {**BASE, **LAYOUTS[layout], "kv-pool-blocks": 40,
           "qos": {"tenants": {"bulk": {"tokens-per-s": 1, "token-burst": 1}},
                   "classes": {"batch": {"queue-limit": 1}}}}

    async def scenario(engine):
        clock = _Clock()
        pkg = jax_sched if isinstance(engine, TpuServingEngine) else scheduler
        engine.scheduler = pkg.QosScheduler(engine.config.qos, clock=clock)
        limited = (jax_qos if pkg is jax_sched else qos).RateLimited
        first = await engine.generate("tenant budget probe",
                                      {"max-tokens": 8, "qos-tenant": "bulk"})
        refusals = []
        try:
            await engine.generate("over budget now", {"max-tokens": 8, "qos-tenant": "bulk"})
        except limited as e:
            refusals.append((e.reason, e.retry_after))
        clock.t = 7.5  # the bucket has refilled past zero
        again = await engine.generate("over budget now", {"max-tokens": 4,
                                                          "qos-tenant": "bulk"})
        outcomes = await asyncio.gather(*(
            engine.generate(f"batch {i}", {"max-tokens": 2, "priority": "batch"})
            for i in range(3)), return_exceptions=True)
        refusals += [(e.reason, e.retry_after) for e in outcomes if isinstance(e, limited)]
        served = [r["tokens"] for r in outcomes if isinstance(r, dict)]
        stats = engine.stats()["scheduler"]
        return (first["tokens"], again["tokens"], served, refusals,
                _events(engine, "shed"), stats["tenants"], stats["shed"])

    want, got = _both(cfg, scenario)
    assert got == want
    refusals = got[3]
    assert refusals[0] == ("throttled", 7.0)
    assert ("queue-full", 120.0) in refusals[1:]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_admission_estimate_deadline_shed_matches_jax(layout):
    """A budget that is not spent but cannot cover the median recent
    prefill is shed at admission, before any device work; a wide budget is
    served."""
    cfg = {**BASE, **LAYOUTS[layout], "kv-pool-blocks": 40}

    async def scenario(engine):
        engine.request_timings.extend({"prefill": p} for p in (4.0, 5.0, 6.0))
        estimate = engine._admit_estimate_s()
        error = JaxDeadlineExceeded if isinstance(engine, TpuServingEngine) else DeadlineExceeded
        with pytest.raises(error, match="at admission"):
            await engine.generate("short budget", {"max-tokens": 4, "deadline-s": 2.0})
        served = await engine.generate("wide budget", {"max-tokens": 4, "deadline-s": 600})
        events = _events(engine, "deadline-exceeded")
        for e in events:
            e.pop("remaining_s")
        return estimate, served["tokens"], events, engine.deadline_sheds

    want, got = _both(cfg, scenario)
    assert got == want
    assert got[0] == 5.0 and got[3] == 1 and got[2][0]["where"] == "admission"


def test_dispatch_path_stays_free_of_blocking_copies_under_qos():
    """QoS on changes nothing on the dispatch thread: one fetch per chunk,
    no blocking copy, uploads only on device-cache misses."""
    check_dispatch_path_makes_no_blocking_copy(
        pipeline_engine("paged", True, qos={"classes": {"batch": {"weight": 2}}}),
        paged=True)

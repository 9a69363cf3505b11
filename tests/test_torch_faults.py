"""The port's device-survival plane against the JAX package's.

- The fault plans (``serving/faults.py``): parsing, round trips, the
  validation messages, ``plans_from_env`` and the injector's fire
  sequences, each case run through both packages' modules.
- The allocator-failure classifier: the JAX package's spellings, PyTorch's
  (a ``torch.OutOfMemoryError`` by type, ``CUDA out of memory``, ...), and
  its negatives.
- The block manager's budget (reduce, restore, admission, ``used_ratio``)
  under one operation sequence, equal in both packages.
- Engine chaos, tiny f32 model on the JAX engine's weights: an injected
  allocator failure at ``pool-grow``, ``prefill``, the chunked-prefill grow
  and an import's ``scatter`` shrinks the budget and every request completes
  with the tokens of the unfaulted port run and of the JAX engine's faulted
  run; a persistent prefill failure is shed past the retry cap; the lowest
  class pays; a ``fetch`` hang reads WEDGED, then ok; a ``t2-get`` drop
  computes cold.
"""

import asyncio
import json
import time

import numpy as np
import pytest
import torch

from langstream_tpu.models.paged import BlockManager as JaxBlockManager
from langstream_tpu.models.paged import PagedLayout as JaxPagedLayout
from langstream_tpu.serving import faults as jax_faults
from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu.serving.qos import RateLimited as JaxRateLimited
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.models.paged import BlockManager, PagedLayout
from langstream_tpu_torch.serving import faults
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
from langstream_tpu_torch.serving.qos import RateLimited
from test_torch_engine import flatten_jax_params

# ---------------------------------------------------------------------------
# plans and the injector
# ---------------------------------------------------------------------------

PLANS = [
    {"site": "pool-grow"},
    {"site": "prefill", "shape": "oom", "after": 2, "count": 3},
    {"site": "fetch", "shape": "hang", "hang-ms": 250.0},
    {"site": "scatter", "shape": "oom", "message": "RESOURCE_EXHAUSTED: custom"},
    {"site": "t2-get", "shape": "drop", "count": 2},
    {"site": "t2-get", "shape": "delay-ms", "hang_ms": 5},
    {"site": "http-export", "shape": "error"},
    {"site": "http-import", "shape": "drop", "after": 1},
    {"site": "route", "shape": "delay-ms", "hang-ms": 10},
    # refused, with the JAX package's messages
    {"site": "nonsense"},
    {"site": "pool-grow", "shape": "explode"},
    {"site": "pool-grow", "count": 0},
    {"site": "pool-grow", "after": -1},
    {"site": "prefill", "shape": "hang", "hang-ms": 0},
    {"site": "t2-get", "shape": "delay-ms"},
    "pool-grow",
    ["site", "fetch"],
]


def _parse(module, d):
    try:
        return module.FaultPlan.from_dict(d).to_dict()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("plan", PLANS, ids=[f"plan{i}" for i in range(len(PLANS))])
def test_plan_parses_and_round_trips_as_jax(plan):
    got = _parse(faults, plan)
    assert got == _parse(jax_faults, plan)
    if isinstance(got, dict):
        assert faults.FaultPlan.from_dict(got).to_dict() == got
        # hashable: it rides the engine's config
        hash(faults.FaultPlan.from_dict(got))


ENVS = [
    "", "   ", "[]",
    json.dumps([{"site": "fetch", "shape": "oom", "after": 1}]),
    json.dumps([{"site": "prefill"}, {"site": "pool-grow", "count": 2}]),
    json.dumps({"site": "fetch"}),
    "not json",
    json.dumps([{"site": "nowhere"}]),
]


def _env(module, raw):
    try:
        return [p.to_dict() for p in module.plans_from_env({"LS_TPU_FAULTS": raw})]
    except ValueError as e:  # json.JSONDecodeError is a ValueError
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("raw", ENVS, ids=[f"env{i}" for i in range(len(ENVS))])
def test_plans_from_env_as_jax(raw):
    assert _env(faults, raw) == _env(jax_faults, raw)
    assert faults.plans_from_env({}) == ()


SEQUENCES = [
    ([{"site": "pool-grow", "after": 2, "count": 2}], ["pool-grow"] * 6 + ["prefill"]),
    ([{"site": "prefill"}, {"site": "prefill", "shape": "hang", "hang-ms": 5, "count": 2}],
     ["prefill"] * 5),
    ([{"site": "fetch", "after": 1}, {"site": "scatter", "count": 3}],
     ["scatter", "fetch", "fetch", "scatter", "fetch", "scatter", "scatter"]),
]


def _fires(module, plans, sites):
    injector = module.FaultInjector(tuple(module.FaultPlan.from_dict(p) for p in plans))
    out = []
    for site in sites:
        action = injector.fire(site)
        out.append(None if action is None else
                   (action.site, action.shape, action.hang_ms, action.message, action.seq))
    return out, injector.stats()


@pytest.mark.parametrize("plans,sites", SEQUENCES, ids=["after-count", "same-site", "mixed"])
def test_injector_fires_as_jax(plans, sites):
    got = _fires(faults, plans, sites)
    assert got == _fires(jax_faults, plans, sites)
    assert any(a is not None for a in got[0])


def test_injected_fault_carries_its_site():
    err = faults.InjectedFault("pool-grow", "RESOURCE_EXHAUSTED: injected")
    assert err.fault_site == "pool-grow" and isinstance(err, RuntimeError)
    assert TorchServingEngine._resource_exhausted(err)


# ---------------------------------------------------------------------------
# the classifier
# ---------------------------------------------------------------------------

JAX_SPELLINGS = [
    "RESOURCE_EXHAUSTED: Out of memory allocating 123 bytes",
    "Out of memory while trying to allocate 17179869184 bytes",
    "Failed to allocate request for 1.20GiB (1288490189B) on device",
    "Allocation of 4096000000 bytes exceeds 90% of free system memory",
    "paged KV pool exhausted despite reservation accounting",
]
TORCH_SPELLINGS = [
    "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total capacity of "
    "79.11 GiB of which 1.06 GiB is free.",
    "CUDA error: out of memory\nCUDA kernel errors might be asynchronously reported",
    "CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling `cublasCreate(handle)`",
]
NEGATIVES = [
    "ValueError: shapes do not match",
    "connection reset by peer",
    "INVALID_ARGUMENT: bad block table",
    "CUDA error: an illegal memory access was encountered",
]


@pytest.mark.parametrize("message", JAX_SPELLINGS + TORCH_SPELLINGS + NEGATIVES)
def test_classifier_on_both_packages_spellings(message):
    port = TorchServingEngine._resource_exhausted(RuntimeError(message))
    jax = TpuServingEngine._resource_exhausted(RuntimeError(message))
    if message in JAX_SPELLINGS:
        assert port and jax
    elif message in TORCH_SPELLINGS:
        # the trap: the JAX classifier's "Out of memory" is capitalised
        assert port and not jax
    else:
        assert not port and not jax


@pytest.mark.parametrize("kind", ["torch", "torch.cuda"])
def test_classifier_takes_pytorch_oom_by_type(kind):
    error_type = torch.OutOfMemoryError if kind == "torch" else torch.cuda.OutOfMemoryError
    assert TorchServingEngine._resource_exhausted(error_type("allocator refused"))


# ---------------------------------------------------------------------------
# the block manager's budget
# ---------------------------------------------------------------------------


def _budget_trace(manager_cls, layout_cls):
    layout = layout_cls(block_size=16, num_blocks=33, max_blocks_per_slot=16)
    mgr = manager_cls(layout, 4)
    out = [mgr.configured_blocks, mgr.usable_blocks]
    ops = [("admit", 0, 10 * 16), ("reduce", 10), ("can", 6 * 16), ("can", 10 * 16),
           ("reduce", 100), ("reduce", 1), ("admit", 1, 4 * 16), ("restore", 4),
           ("can", 8 * 16), ("release", 0), ("restore", None), ("restore", 5),
           ("admit", 2, 16 * 16), ("reduce", 3), ("release", 1), ("release", 2)]
    for op, *args in ops:
        if op == "admit":
            out.append(mgr.can_admit(args[1]))
            if out[-1]:
                mgr.admit(*args)
                mgr.ensure_capacity(args[0], args[1] // 2)
        elif op == "release":
            mgr.release(*args)
        elif op == "reduce":
            out.append(mgr.reduce_budget(*args))
        elif op == "restore":
            out.append(mgr.restore_budget(*args))
        else:
            out.append(mgr.can_admit(*args))
        out.append((mgr.usable_blocks, mgr.budget_reduction, mgr.reserved_blocks,
                    round(mgr.used_ratio(), 9), mgr.stats()))
    return out


def test_block_manager_budget_matches_jax():
    got = _budget_trace(BlockManager, PagedLayout)
    assert got == _budget_trace(JaxBlockManager, JaxPagedLayout)
    assert got[-1][4]["withheld_blocks"] == 3 and got[-1][4]["budget_blocks"] == 29


# ---------------------------------------------------------------------------
# engine chaos
# ---------------------------------------------------------------------------

BASE = {"model": "tiny", "slots": 4, "max-seq-len": 192, "model-dtype": "float32",
        "kv-layout": "paged", "kv-block-size": 16, "decode-chunk": 4, "max-tokens": 24,
        "shrink-recovery-s": 0.3}
PROMPTS = [f"chaos request {i} says hello" for i in range(6)]
CHUNKED = [f"chunked prefill fault request number {i} with a longer prompt" for i in range(4)]


def _jax_engine(cfg):
    return TpuServingEngine(JaxServingConfig.from_dict(cfg))


def _port_engine(cfg, flat):
    return TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu",
                              params=params_from_numpy(flat, device="cpu",
                                                       dtype=torch.float32))


async def _wave(engine, prompts, max_tokens=16, priorities=None):
    outs = await asyncio.gather(*(
        engine.generate(p, {"max-tokens": max_tokens, "temperature": 0,
                            **({"priority": priorities[i]} if priorities else {})})
        for i, p in enumerate(prompts)))
    for _ in range(100):  # the recovery probe restores the budget
        if not engine.stats()["survival"].get("withheld_blocks"):
            break
        await asyncio.sleep(0.05)
    return [o["tokens"] for o in outs]


def _chaos(cfg, faults_, prompts, max_tokens=16):
    """(JAX faulted tokens, port unfaulted tokens, port faulted tokens, the
    port's survival section and event kinds) on the JAX engine's weights."""
    fcfg = {**cfg, "faults": faults_}

    async def jax():
        engine = _jax_engine(fcfg)
        try:
            return flatten_jax_params(engine.params), await _wave(engine, prompts, max_tokens)
        finally:
            await engine.close()
            TpuServingEngine.reset_instances()

    flat, want = asyncio.run(jax())

    async def port(c):
        engine = _port_engine(c, flat)
        try:
            tokens = await _wave(engine, prompts, max_tokens)
            return (tokens, engine.stats()["survival"],
                    [e["kind"] for e in engine.flight.recent_events(0)])
        finally:
            await engine.close()
            assert engine.block_mgr.stats()["reserved_blocks"] == 0

    clean = asyncio.run(port(cfg))[0]
    return want, clean, *asyncio.run(port(fcfg))


@pytest.mark.parametrize("case", ["pool-grow", "prefill", "chunked-grow"])
def test_chaos_tokens_equal_unfaulted_and_jax(case):
    if case == "pool-grow":
        cfg, plan, prompts = BASE, [{"site": "pool-grow", "after": 3, "count": 2}], PROMPTS
    elif case == "prefill":
        cfg, plan, prompts = BASE, [{"site": "prefill", "count": 1}], PROMPTS[:5]
    else:
        cfg = {**BASE, "prefill-chunk": 8, "slots": 2}
        plan, prompts = [{"site": "pool-grow", "count": 1}], CHUNKED
    want, clean, got, survival, kinds = _chaos(cfg, plan, prompts,
                                               10 if case == "chunked-grow" else 16)
    assert got == clean == want
    assert survival["shrinks"] >= 1 and survival["withheld_blocks"] == 0
    if case == "pool-grow":
        assert survival["restores"] >= 1 and "pool-restore" in kinds
    assert kinds.index("fault-injected") < kinds.index("pool-shrink")
    assert survival["faults"][0]["fired"] == survival["faults"][0]["count"]


def test_scatter_fault_on_a_decode_pool_shrinks_then_serves_every_import():
    """An allocator failure in an import's scatter: the JAX engine refuses
    the import (``kv-import-oom``, the caller retries); the port's shrinks
    the budget and retries it on the next pass. Both serve every import with
    the tokens of the unfaulted pair."""
    cfg = {**BASE, "max-seq-len": 128}
    prompts = PROMPTS[:3]

    async def run(make, role_cfg):
        pre = make({**role_cfg, "pool-role": "prefill"})
        dec = make({**role_cfg, "pool-role": "decode",
                    "faults": [{"site": "scatter", "count": 1}]})
        clean = make({**role_cfg, "pool-role": "decode"})
        try:
            tickets = await asyncio.gather(*(
                pre.generate(p, {"max-tokens": 12, "temperature": 0}) for p in prompts))
            payloads = [pre.take_export(t["handoff"]) for t in tickets]
            want = [r["tokens"] for r in await asyncio.gather(
                *(clean.import_handoff(p) for p in payloads))]
            got, refusals = [], 0
            for payload in payloads:
                while True:
                    try:
                        got.append((await dec.import_handoff(payload))["tokens"])
                        break
                    except (RateLimited, JaxRateLimited) as e:
                        assert e.reason == "kv-import-oom"
                        refusals += 1
            return want, got, refusals, dec.stats()["survival"]["shrinks"]
        finally:
            for engine in (pre, dec, clean):
                await engine.close()

    jax_engine = _jax_engine(cfg)
    flat = flatten_jax_params(jax_engine.params)
    jax_want, jax_got, jax_refusals, jax_shrinks = asyncio.run(run(_jax_engine, cfg))
    TpuServingEngine.reset_instances()
    want, got, refusals, shrinks = asyncio.run(run(lambda c: _port_engine(c, flat), cfg))
    assert got == want == jax_got == jax_want
    assert (jax_refusals, jax_shrinks) == (1, 0)
    assert (refusals, shrinks) == (0, 1)


def test_persistent_prefill_failure_is_shed_past_the_retry_cap():
    plan = [{"site": "prefill", "count": 1000}]

    async def run(engine):
        try:
            with pytest.raises((RateLimited, JaxRateLimited)) as err:
                await asyncio.wait_for(
                    engine.generate("doomed request", {"max-tokens": 8, "temperature": 0}),
                    timeout=60.0)
            sheds = [e for e in engine.flight.recent_events(0)
                     if e["kind"] == "shed" and e.get("reason") == "device-oom"]
            return err.value.reason, err.value.retry_after, [e["retries"] for e in sheds]
        finally:
            await engine.close()

    want = asyncio.run(run(_jax_engine({**BASE, "faults": plan})))
    TpuServingEngine.reset_instances()
    got = asyncio.run(run(TorchServingEngine(ServingConfig.from_dict({**BASE, "faults": plan}),
                                             device="cpu")))
    assert got == want == ("device-oom", 2.0, [3])


def test_shrink_preempts_the_lowest_class_first():
    cfg = {**BASE, "qos": {}, "shrink-fraction": 0.5,
           "faults": [{"site": "pool-grow", "after": 6, "count": 1}]}
    engine = TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu")
    priorities = ["batch" if i % 2 else "interactive" for i in range(6)]
    prompts = [f"victim candidate {i} reporting" for i in range(6)]

    async def run():
        try:
            return await _wave(engine, prompts, 24, priorities)
        finally:
            await engine.close()

    outs = asyncio.run(run())
    stats = engine.stats()
    assert len(outs) == 6 and all(outs)
    survival, classes = stats["survival"], stats["scheduler"]["classes"]
    assert survival["shrinks"] == 1 and survival["shrink_preempted"] >= 1
    assert classes["batch"]["preempted"] >= 1 and classes["interactive"]["preempted"] == 0
    preempts = [e for e in engine.flight.recent_events(0)
                if e["kind"] == "preempt" and e.get("reason") == "pool-shrink"]
    assert preempts and all(p["priority"] == "batch" for p in preempts)


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "sequential"])
def test_fetch_hang_reads_wedged_then_ok(pipeline):
    """A hang at the ``fetch`` seam stalls the chunk's copy: the heartbeat
    stops with work in flight and ``health()`` reads WEDGED, then ok once
    the chunk lands; the requests complete."""
    cfg = {**BASE, "slots": 8, "decode-chunk-light": 2, "wedge-window-s": 0.25,
           "pipeline": pipeline,
           "faults": [{"site": "fetch", "shape": "hang", "hang-ms": 1200.0, "after": 2}]}
    engine = TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu")

    async def run():
        try:
            tasks = [asyncio.ensure_future(engine.generate(
                p, {"max-tokens": 20, "temperature": 0})) for p in PROMPTS]
            states = []
            deadline = time.monotonic() + 20.0
            while not all(t.done() for t in tasks) and time.monotonic() < deadline:
                states.append(engine.health()["state"])
                await asyncio.sleep(0.05)
            outs = await asyncio.gather(*tasks)
            for _ in range(100):
                if engine.health()["state"] == "ok":
                    break
                await asyncio.sleep(0.05)
            # the fault-injected event reaches the ring at the loop's next
            # pass, after the idle wait
            for _ in range(60):
                if any(e["kind"] == "fault-injected" for e in engine.flight.recent_events(0)):
                    break
                await asyncio.sleep(0.05)
            return states, outs, engine.health(), engine.flight.recent_events(0)
        finally:
            await engine.close()

    states, outs, health, events = asyncio.run(run())
    assert "wedged" in states and all(len(o["tokens"]) == 20 for o in outs)
    assert health["state"] == "ok"
    assert any(e["kind"] == "fault-injected" and e["shape"] == "hang"
               and e["site"] == "fetch" for e in events)
    assert engine.stats()["decode-chunks"]["host_fetches_per_chunk"] == 1.0


def test_t2_get_drop_is_served_cold(tmp_path):
    """A ``t2-get`` drop: the hydrator reports the blob missing (a
    ``fault-injected`` event from the store) and the request computes cold,
    with the tokens of the replica that wrote the blobs."""
    cfg = {"model": "tiny", "slots": 2, "max-seq-len": 256, "decode-chunk": 4,
           "model-dtype": "float32", "kv-layout": "paged", "kv-block-size": 16,
           "kv-pool-blocks": 48, "prefix-cache": True,
           "prefix-store": {"t0-bytes": 0, "t1-bytes": 1, "t2-rescan-s": 0.2,
                            "t2": {"type": "local", "path": str(tmp_path)}}}
    prompt, opts = list(range(1, 100)), {"max-tokens": 8, "temperature": 0}

    async def writer():
        engine = TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu")
        try:
            out = await engine.generate(prompt, dict(opts))
            for _ in range(750):
                st = engine.stats()["prefixstore"]
                if (st["t0"]["blocks"] == 0 and st["t1"]["entries"] == 0
                        and not st["t2"]["pending_jobs"]):
                    break
                await asyncio.sleep(0.02)
            assert engine.stats()["prefixstore"]["t2"]["entries"] > 0
            return out
        finally:
            await engine.close()

    async def reader():
        engine = TorchServingEngine(ServingConfig.from_dict(
            {**cfg, "faults": [{"site": "t2-get", "shape": "drop", "count": 1000}]}),
            device="cpu")
        try:
            assert engine.prefix_store.flush(10)
            out = await engine.generate(prompt, dict(opts))
            return out, engine.stats(), engine.flight.recent_events(0)
        finally:
            await engine.close()

    want = asyncio.run(writer())
    got, stats, events = asyncio.run(reader())
    assert got["tokens"] == want["tokens"]
    assert any(e["kind"] == "fault-injected" and e["site"] == "t2-get" for e in events)
    st = stats["prefixstore"]
    assert st["hydrations"] == 0 and st["t0"]["hits"] == 0
    assert stats["survival"]["faults"][0]["fired"] >= 1


def test_default_engine_has_no_injector_and_an_inert_plan_changes_nothing():
    async def run(cfg):
        engine = TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu")
        try:
            outs = [await engine.generate(p, {"max-tokens": 8, "temperature": 0})
                    for p in PROMPTS[:3]]
            return [o["tokens"] for o in outs], engine._faults, engine.stats()["survival"]
        finally:
            await engine.close()

    plain, injector, survival = asyncio.run(run(BASE))
    assert injector is None and "faults" not in survival and "journal" not in survival
    assert survival["shrinks"] == 0 and survival["restores"] == 0
    armed, injector, _ = asyncio.run(run({**BASE, "faults": [
        {"site": "pool-grow", "after": 10 ** 9}]}))
    assert injector is not None and armed == plain


def test_survival_section_has_the_jax_keys():
    async def run(engine):
        try:
            await engine.generate("hello", {"max-tokens": 4, "temperature": 0})
            return engine.stats()
        finally:
            await engine.close()

    cfg = {**BASE, "faults": [{"site": "fetch", "after": 10 ** 9}]}
    want = asyncio.run(run(_jax_engine(cfg)))
    TpuServingEngine.reset_instances()
    got = asyncio.run(run(TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu")))
    assert set(got["survival"]) == set(want["survival"])
    for key in ("shrinks", "restores", "shrink_preempted", "recovery_s", "recovering",
                "budget_blocks", "configured_blocks", "withheld_blocks", "withheld_bytes"):
        assert got["survival"][key] == want["survival"][key], key
    assert [{k: v for k, v in f.items() if k != "seen"} for f in got["survival"]["faults"]] \
        == [{k: v for k, v in f.items() if k != "seen"} for f in want["survival"]["faults"]]
    assert got["health"]["budget_withheld"] == want["health"]["budget_withheld"] == 0
    assert got["kv"]["budget_blocks"] == want["kv"]["budget_blocks"]


def test_memory_ledger_reports_the_withheld_budget():
    engine = TorchServingEngine(ServingConfig.from_dict(BASE), device="cpu")
    before = engine._memory_ledger()
    engine.block_mgr.reduce_budget(4)
    during = engine._memory_ledger()
    health = engine.health()
    engine.block_mgr.restore_budget()
    after = engine._memory_ledger()
    assert before["kv_pool_withheld_bytes"] == after["kv_pool_withheld_bytes"] == 0
    assert during["kv_pool_withheld_bytes"] == 4 * engine._kv_block_bytes
    assert health["budget_withheld"] == 4
    assert (before["hbm_bytes_by_owner"]["kv-pool"] == during["hbm_bytes_by_owner"]["kv-pool"]
            == after["hbm_bytes_by_owner"]["kv-pool"])
    asyncio.run(engine.close())
    np.testing.assert_equal(engine.block_mgr.usable_blocks, engine.block_mgr.configured_blocks)

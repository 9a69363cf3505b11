"""The port's drain against the JAX engine's, tiny f32 model on the JAX
engine's weights.

- A drain under load requeues every running request once at the loop's safe
  point and serves the backlog: the greedy tokens equal the undrained run's
  and the JAX engine's, and the report's counts equal the JAX engine's.
- A submission or a KV import during a drain is refused with
  ``RateLimited("draining")``; a drain whose grace runs out sheds the rest
  explicitly and leaves no future pending.
- ``stats()["drain"]`` and ``survival_section()`` carry the JAX engine's
  keys; ``health()`` reads draining and not ready.
"""

import asyncio

import pytest
import torch

from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu.serving.qos import RateLimited as JaxRateLimited
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
from langstream_tpu_torch.serving.qos import RateLimited
from test_torch_engine import flatten_jax_params

BASE = {"model": "tiny", "slots": 4, "max-seq-len": 192, "model-dtype": "float32",
        "kv-layout": "paged", "kv-block-size": 16, "decode-chunk": 4, "max-tokens": 24}
PROMPTS = [f"drain request {i} wants an answer" for i in range(6)]
LAYOUTS = {"paged": {}, "paged-int8": {"kv-quantize": "int8"},
           "dense": {"kv-layout": "dense"}, "sequential": {"pipeline": False}}


def _both(cfg, scenario):
    """``scenario(engine)`` on the JAX engine, then on the port's with the
    JAX engine's weights: (JAX result, port result, flat weights)."""

    async def jax():
        engine = TpuServingEngine(JaxServingConfig.from_dict(cfg))
        try:
            return flatten_jax_params(engine.params), await scenario(engine)
        finally:
            await engine.close()
            TpuServingEngine.reset_instances()

    flat, want = asyncio.run(jax())

    async def port():
        engine = _port(cfg, flat)
        try:
            return await scenario(engine)
        finally:
            await engine.close()
            if engine.block_mgr is not None:
                assert engine.block_mgr.stats()["reserved_blocks"] == 0

    return want, asyncio.run(port()), flat


def _port(cfg, flat):
    return TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu",
                              params=params_from_numpy(flat, device="cpu",
                                                       dtype=torch.float32))


async def _undrained(engine):
    outs = await asyncio.gather(*(engine.generate(p, {"max-tokens": 16, "temperature": 0})
                                  for p in PROMPTS))
    return [o["tokens"] for o in outs]


async def _drained(engine):
    """Hold the engine inside its first token flush once every slot decodes,
    start the drain, submit during it, then let it run."""
    gate, held = asyncio.Event(), asyncio.Event()
    seen = [0]

    async def on_token(token, logprob, last):
        seen[0] += 1
        if seen[0] >= len(PROMPTS) + 2:  # past the first prefills
            held.set()
            await gate.wait()

    tasks = [asyncio.ensure_future(engine.generate(
        p, {"max-tokens": 16, "temperature": 0}, on_token=on_token)) for p in PROMPTS]
    await held.wait()
    occupied = sum(1 for s in engine.slots if not s.free)
    drain = asyncio.ensure_future(engine.drain(grace_s=60.0))
    await asyncio.sleep(0)
    try:
        await engine.generate("too late", {"max-tokens": 4})
        refused = None
    except (RateLimited, JaxRateLimited) as e:
        refused = e.reason
    health = engine.health()
    gate.set()
    report = await drain
    outs = await asyncio.gather(*tasks)
    stats = engine.stats()
    return ([o["tokens"] for o in outs], occupied,
            {k: v for k, v in report.items() if k != "duration_s"}, refused,
            (health["draining"], health["ready"]),
            {k: v for k, v in stats["drain"].items() if k != "duration_s"})


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_drain_under_load_equals_undrained_and_jax(layout):
    cfg = {**BASE, **LAYOUTS[layout]}
    want, got, flat = _both(cfg, _drained)
    clean = asyncio.run(_close_after(_port(cfg, flat), _undrained))
    tokens, occupied, report, refused, health, section = got
    assert tokens == clean == want[0]
    assert report == want[2] and section == want[5]
    assert report["requeued"] == occupied >= 1
    assert report["completed"] == len(PROMPTS) and report["shed"] == 1  # "too late"
    assert refused == want[3] == "draining"
    assert health == want[4] == (True, False)
    assert section["draining"] is True


async def _close_after(engine, scenario):
    try:
        return await scenario(engine)
    finally:
        await engine.close()


def test_a_drain_past_its_grace_sheds_the_rest_explicitly():
    engine = TorchServingEngine(ServingConfig.from_dict(BASE), device="cpu")

    async def slow(token, logprob, last):
        await asyncio.sleep(0.02)

    async def run():
        try:
            tasks = [asyncio.ensure_future(engine.generate(
                p, {"max-tokens": 150, "temperature": 0}, on_token=slow)) for p in PROMPTS]
            while not any(not s.free for s in engine.slots):
                await asyncio.sleep(0.01)
            report = await engine.drain(grace_s=0.3)
            done = await asyncio.gather(*tasks, return_exceptions=True)
            return report, done, engine.stats()
        finally:
            await engine.close()

    report, done, stats = asyncio.run(run())
    errors = [r for r in done if isinstance(r, BaseException)]
    assert report["shed"] >= 1 and report["completed"] + report["shed"] == len(PROMPTS)
    assert len(errors) == report["shed"]
    assert all(isinstance(e, RateLimited) and e.reason == "draining" for e in errors)
    assert stats["active"] == 0 and stats["queued"] == 0
    assert stats["kv"]["reserved_blocks"] == 0
    assert stats["drain"]["shed"] == report["shed"]


def test_an_import_during_a_drain_is_refused():
    cfg = {**BASE, "max-seq-len": 128}

    async def run():
        pre = TorchServingEngine(ServingConfig.from_dict({**cfg, "pool-role": "prefill"}),
                                 device="cpu")
        dec = TorchServingEngine(ServingConfig.from_dict({**cfg, "pool-role": "decode"}),
                                 device="cpu")
        try:
            ticket = await pre.generate("hand me off", {"max-tokens": 8, "temperature": 0})
            payload = pre.take_export(ticket["handoff"])
            report = await dec.drain(grace_s=1.0)
            with pytest.raises(RateLimited) as err:
                await dec.import_handoff(payload)
            return report, err.value.reason
        finally:
            await pre.close()
            await dec.close()

    report, reason = asyncio.run(run())
    assert reason == "draining"
    assert report == {**report, "requeued": 0, "completed": 0, "shed": 0}


def test_drain_sections_have_the_jax_keys():
    async def scenario(engine):
        idle = (engine.stats()["drain"], engine.survival_section())
        await engine.generate("hello", {"max-tokens": 4, "temperature": 0})
        report = await engine.drain(grace_s=5.0)
        again = await engine.drain(grace_s=5.0)  # joins: nothing left
        return idle, report, again, engine.stats()["drain"], engine.health()

    want, got, _ = _both(BASE, scenario)
    assert got[0][0] == want[0][0] == {"draining": False}
    assert set(got[0][1]) == set(want[0][1])
    assert set(got[1]) == set(want[1]) == {"requeued", "completed", "shed", "duration_s"}
    assert {k: got[2][k] for k in ("requeued", "completed", "shed")} == \
        {k: want[2][k] for k in ("requeued", "completed", "shed")}
    assert set(got[3]) == set(want[3])
    assert got[4]["draining"] and not got[4]["ready"] and got[4]["state"] == want[4]["state"]


def test_a_closed_engine_drains_to_nothing():
    engine = TorchServingEngine(ServingConfig.from_dict(BASE), device="cpu")
    asyncio.run(engine.close())
    report = asyncio.run(engine.drain(grace_s=1.0))
    assert report == {"requeued": 0, "completed": 0, "shed": 0, "duration_s": 0.0,
                      "stopped": True}

"""Multi-LoRA serving in the port's engine against the JAX engine.

Tiny f32 paged engines on the JAX engine's parameters (carried across with
``params_from_numpy``) and the same ``make_lora_arrays`` factors, at
``scale=0.5`` so an adapter steers the greedy tokens (the JAX package's own
pin uses 0.02, which flips no token of the random tiny model). Greedy
tokens and text are compared exactly:

- one adapter equals the JAX engine and the port's offline-merged engine
  (``merge_adapter_into_params``) and differs from the base model;
- adapter-less traffic on an adapter-enabled engine equals a store-less
  engine, which computes no delta at all and shows no adapter surface;
- a mixed batch (two adapters and base on 4 slots) equals the JAX engine
  per request on the paged f32 pool, with chunked prefill, with
  speculation (whose streams also equal plain decode), on the int8 pool
  and on moe-tiny;
- refusals: an unknown adapter and a hydration timeout are counted
  ``AdapterUnavailable`` refusals; a wrong-rank install is a ValueError;
- more adapters than T0 rows under concurrent traffic completes every
  request with a conserved ledger and no pin left, and a fresh replica
  hydrating from the shared T2 directory gives the local tokens;
- a blob published by either package hydrates in the other's engine with
  identical tokens;
- an adapter request neither hits nor registers the prefix cache;
- a QoS preemption of an adapter request resumes with the adapter and its
  unpreempted tokens, as in the JAX engine;
- the pipelined loop equals the sequential one on a mixed-adapter load,
  and its dispatch path makes no blocking copy with the adapter rows;
- a KV handoff of an adapter request decodes on the other pool with row 0
  (the base model), in both packages alike.
"""

import asyncio

import numpy as np
import pytest
import torch

from langstream_tpu.serving import adapters as jax_ad
from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.models import llama as port_llama
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.serving.adapters import (
    AdapterStoreSpec,
    AdapterUnavailable,
    make_lora_arrays,
    merge_adapter_into_params,
    publish_adapter,
)
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
from test_torch_engine import flatten_jax_params
from test_torch_pipeline import check_dispatch_path_makes_no_blocking_copy

BASE = {"model": "tiny", "model-dtype": "float32", "slots": 4, "max-seq-len": 256,
        "decode-chunk": 4, "kv-layout": "paged", "kv-block-size": 16,
        "kv-pool-blocks": 64}
STORE = {"rank": 4, "t0-entries": 2, "t1-bytes": 8 << 20, "hydrate-timeout-s": 10.0,
         "t2-rescan-s": 0.1}
OPTS = {"max-tokens": 8, "temperature": 0}
PROMPT = list(range(1, 80))


def _factors(seed: int, rank: int = 4) -> dict[str, np.ndarray]:
    """Factors for the tiny models (llama and moe-tiny share the attention
    widths) at ``scale=0.5``: enough to steer the greedy tokens."""
    return make_lora_arrays(layers=2, hidden=64, heads=4, kv_heads=2, head_dim=16,
                            rank=rank, seed=seed, scale=0.5)


ADAPTERS = {"tenant-a": _factors(11), "tenant-b": _factors(12)}


def _cfg(store: dict | None = STORE, **extra) -> dict:
    cfg = {**BASE, **extra}
    if store is not None:
        cfg["adapter-store"] = store
    return cfg


def _opts(adapter: str = "", **extra) -> dict:
    return {**OPTS, **extra, **({"adapter": adapter} if adapter else {})}


def _jax(cfg: dict, scenario, install=ADAPTERS):
    """``scenario(engine)`` on a JAX engine with ``install`` installed;
    returns (its numpy parameters, the result)."""

    async def main():
        engine = TpuServingEngine(JaxServingConfig.from_dict(cfg))
        try:
            for name, arrays in (install or {}).items():
                engine.install_adapter(name, arrays)
            return flatten_jax_params(engine.params), await scenario(engine)
        finally:
            await engine.close()
            TpuServingEngine.reset_instances()

    return asyncio.run(main())


def _port(cfg: dict, params, scenario, install=ADAPTERS):
    """``scenario(engine)`` on a port engine; after close the block manager
    is idle and no adapter pin is left."""

    async def main():
        engine = TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu",
                                    params=params)
        try:
            for name, arrays in (install or {}).items():
                engine.install_adapter(name, arrays)
            return engine, await scenario(engine)
        finally:
            await engine.close()

    engine, result = asyncio.run(main())
    assert engine.block_mgr.stats()["reserved_blocks"] == 0
    if engine.adapter_store is not None:
        assert engine.stats()["adapters"]["t0"]["pinned"] == {}
    return result


def _params(flat):
    return params_from_numpy(flat, device="cpu", dtype=torch.float32)


def _events(engine, prefix: str = "adapter") -> list[str]:
    return [e["kind"] for e in engine.flight.recent_events(0)
            if str(e["kind"]).startswith(prefix)]


def _conserved(ledger: dict) -> bool:
    return (ledger["t1_bytes"] + ledger["in_transit_bytes"] + ledger["t2_bytes"]
            == ledger["inserted_bytes"] + ledger["discovered_bytes"] - ledger["evicted_bytes"])


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------


def test_serving_config_parses_adapter_store_as_jax():
    d = _cfg({**STORE, "t2": {"type": "local", "path": "/tmp/x"}})
    mine, theirs = ServingConfig.from_dict(d), JaxServingConfig.from_dict(d)
    assert isinstance(mine.adapter_store, AdapterStoreSpec)
    assert mine.adapter_store.to_dict() == theirs.adapter_store.to_dict()
    assert ServingConfig.from_dict(BASE).adapter_store is None
    # a parsed config is hashable: one shared engine per config
    hash(mine)
    with pytest.raises(ValueError, match="unknown adapter-store keys"):
        ServingConfig.from_dict(_cfg({"rank": 4, "bogus": 1}))


# --------------------------------------------------------------------------
# one adapter: JAX, the offline merge, the base model
# --------------------------------------------------------------------------


async def _adapted_and_base(engine):
    adapted = await engine.generate(PROMPT, _opts("tenant-a"))
    base = await engine.generate(PROMPT, _opts())
    return adapted, base, engine.stats().get("adapters")


def test_single_adapter_equals_jax_and_offline_merge():
    flat, (want_a, want_b, _) = _jax(_cfg(), _adapted_and_base)
    params = _params(flat)
    adapted, base, st = _port(_cfg(), params, _adapted_and_base)
    assert adapted["tokens"] == want_a["tokens"] and adapted["text"] == want_a["text"]
    assert base["tokens"] == want_b["tokens"]
    assert adapted["tokens"] != base["tokens"]  # the adapter steers
    assert st["t0"]["loads"] == 1 and st["t0"]["resident"] == ["tenant-a"]

    merged_params = merge_adapter_into_params(params, ADAPTERS["tenant-a"])
    merged = _port(_cfg(None), merged_params,
                   lambda e: e.generate(PROMPT, _opts()), install=None)
    assert merged["tokens"] == adapted["tokens"] and merged["text"] == adapted["text"]


def test_adapterless_traffic_equals_storeless_engine(monkeypatch):
    """Row 0 is the base model; a store-less engine computes no delta at all
    (no ``lora_delta`` call: its launches are the pre-adapter engine's) and
    shows no adapter surface."""
    flat, _ = _jax(_cfg(None), lambda e: asyncio.sleep(0), install=None)
    params = _params(flat)
    calls = []
    real = port_llama.lora_delta

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(port_llama, "lora_delta", counting)
    prompts = [PROMPT, list(range(5, 40)), list(range(9, 130))]

    async def serve(engine):
        out = await asyncio.gather(*(engine.generate(p, _opts()) for p in prompts))
        return [r["tokens"] for r in out], engine.stats(), _events(engine)

    want, stats, events = _port(_cfg(None), params, serve, install=None)
    assert not calls
    assert "adapters" not in stats and not events

    async def serve_store(engine):
        assert engine.adapter_store is not None and engine._ad_layers is not None
        assert engine._ad_layers["wq_a"].shape == (2, 3, 64, 4)  # row 0 + 2 T0 rows
        return await serve(engine)

    got, stats, events = _port(_cfg(), params, serve_store,
                               install={"unused": _factors(5)})
    assert got == want
    assert calls  # the store's engine adds (zero) deltas
    assert "adapter-load" not in events and stats["adapters"]["t0"]["loads"] == 0
    default = TorchServingEngine(ServingConfig.from_dict({"model": "tiny"}), device="cpu")
    assert default.adapter_store is None and "adapters" not in default.stats()
    asyncio.run(default.close())


# --------------------------------------------------------------------------
# mixed batches, per layout, against the JAX engine
# --------------------------------------------------------------------------

PREAMBLE = list(range(100, 150))
MIXED = [  # (prompt, adapter)
    (PROMPT, "tenant-a"),
    (PREAMBLE + list(range(3, 40)), "tenant-b"),
    (list(range(7, 60)), ""),
    ([5, 6, 7, 8] * 12, "tenant-a"),   # repetitive: prompt lookup drafts land
    (PREAMBLE + [9, 10, 11] * 8, "tenant-b"),
]
LAYOUTS = {
    "paged": {},
    "prefill-chunk": {"prefill-chunk": 32},
    "speculative": {"speculative-drafts": 4, "prefix-cache": False},
    "paged-int8-kv": {"kv-quantize": "int8"},
    "moe-tiny": {"model": "moe-tiny"},
}


async def _mixed(engine):
    out = await asyncio.gather(*(engine.generate(p, _opts(a, **{"max-tokens": 10}))
                                 for p, a in MIXED))
    return [(r["tokens"], r["text"]) for r in out], engine.stats()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mixed_batch_equals_jax(layout, monkeypatch):
    # the speculative uplift verdict is a wall-clock ratio: keep the
    # calibration chunk out of reach so both engines speculate throughout
    monkeypatch.setenv("LS_TPU_SPEC_CALIBRATE_EVERY", "100000")
    cfg = _cfg(**LAYOUTS[layout])
    flat, (want, _) = _jax(cfg, _mixed)
    params = _params(flat)
    got, stats = _port(cfg, params, _mixed)
    assert got == want
    st = stats["adapters"]
    assert st["t0"]["loads"] == 2 and _conserved(st["ledger"])
    if layout == "prefill-chunk":
        assert stats["prefill-continue-calls"] > 0
    if layout == "speculative":
        assert stats["speculative"]["steps"] > 0 and stats["speculative"]["drafts_accepted"] > 0
        plain = _port(_cfg(**{**LAYOUTS[layout], "speculative-drafts": 0}), params, _mixed)[0]
        assert got == plain  # f32: speculation emits plain decode's tokens
    # each adapter steers its requests: base-only serving differs somewhere
    base = _port(cfg, params, lambda e: asyncio.gather(*(
        e.generate(p, _opts(**{"max-tokens": 10})) for p, _ in MIXED)), install=None)
    if layout != "moe-tiny":  # routed capacity couples a MoE batch's rows
        assert base[2]["tokens"] == got[2][0]  # the base request
    assert any(base[i]["tokens"] != got[i][0] for i in (0, 1, 3, 4))


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------


def test_unknown_adapter_refused_cold_and_counted():
    async def scenario(engine):
        with pytest.raises(AdapterUnavailable, match="not resident"):
            await engine.generate(PROMPT, _opts("ghost"))
        served = await engine.generate(PROMPT, _opts("tenant-a"))
        return served, engine.stats()["adapters"], _events(engine)

    served, st, events = _port(_cfg(), None, scenario)
    assert served["tokens"] and st["refusals"] == 1 and "adapter-refused" in events


def test_submit_without_store_refused_as_jax():
    async def scenario(engine):
        with pytest.raises(ValueError, match="no adapter store configured"):
            await engine.generate(PROMPT, _opts("tenant-a"))
        return True

    assert _port(_cfg(None), None, scenario, install=None)
    engine = TorchServingEngine(ServingConfig.from_dict(_cfg(None)), device="cpu")
    with pytest.raises(ValueError, match="adapter store not configured"):
        engine.install_adapter("tenant-a", ADAPTERS["tenant-a"])
    asyncio.run(engine.close())


def test_hydrate_timeout_refused_cold_and_counted(tmp_path):
    """A hydration whose blob never arrives refuses the request inside the
    timeout: never a strand, never base-model output under the adapter's
    name."""
    store = {**STORE, "t2": {"type": "local", "path": str(tmp_path)}, "hydrate-timeout-s": 0.3}

    async def scenario(engine):
        publish_adapter({"type": "local", "path": str(tmp_path)}, "slow", _factors(3),
                        engine.adapter_fingerprint())
        ads = engine.adapter_store
        for _ in range(500):  # the hydrator's rescan finds the blob
            ads.apply_results()
            if ads.t2_has("slow"):
                break
            await asyncio.sleep(0.02)
        assert ads.t2_has("slow")
        ads._jobs.append(("stop",))  # the hydrator exits: no fetch completes
        ads._kick.set()
        with pytest.raises(AdapterUnavailable, match="timed out"):
            await asyncio.wait_for(engine.generate(PROMPT, _opts("slow")), 30)
        stages = [e.get("stage") for e in engine.flight.recent_events(0)
                  if e["kind"] == "adapter-hydrate"]
        return stages, engine.stats()["adapters"], engine._adapter_hydrating

    stages, st, stash = _port(_cfg(store), None, scenario, install=None)
    assert stages == ["begin", "timeout"] and not stash
    assert st["refusals"] == 1 and st["hydrate_failures"] == 1


@pytest.mark.parametrize("bad", ["rank", "missing"])
def test_install_adapter_shape_checked(bad):
    engine = TorchServingEngine(ServingConfig.from_dict(_cfg()), device="cpu")
    arrays = _factors(1, rank=2) if bad == "rank" else {
        k: v for k, v in _factors(1).items() if k != "wo_b"}
    with pytest.raises(ValueError, match="factor"):
        engine.install_adapter("bad", arrays)
    assert engine.adapter_store.installs == 0
    asyncio.run(engine.close())


def test_a_request_left_queued_keeps_one_pin():
    """Two requests of one adapter in different length buckets: the second
    resolves, the bucket break leaves it queued, and the next pass admits it
    on the row it holds. The port pins it once, so every pin is released at
    the end; the JAX engine resolves it again and leaks one pin (ROADMAP.md
    Queue 3, a fault of the reference kept out of the port)."""
    short, long = list(range(1, 20)), list(range(1, 100))  # buckets 32 and 128

    async def scenario(engine):
        out = await asyncio.gather(engine.generate(short, _opts("tenant-a")),
                                   engine.generate(long, _opts("tenant-a")))
        return [r["tokens"] for r in out], engine.stats()["adapters"]["t0"]["pinned"]

    flat, (want, jax_pins) = _jax(_cfg(), scenario)
    got, pins = _port(_cfg(), _params(flat), scenario)
    assert got == want
    assert pins == {} and jax_pins == {"tenant-a": 1}


def test_a_pinned_request_cancelled_while_queued_releases_its_pin():
    """The second request resolves its adapter (a pin) and stays queued
    behind the first's length bucket; its caller gives up during the first
    request's prefill. The next pass drops it and releases the pin."""
    short, long = list(range(1, 20)), list(range(1, 100))

    async def scenario(engine):
        held = {}

        async def on_token(token, logprob, last):
            if not held["b"].done():
                held["b"].cancel()

        a = asyncio.ensure_future(engine.generate(short, _opts("tenant-a"), on_token=on_token))
        held["b"] = asyncio.ensure_future(engine.generate(long, _opts("tenant-a")))
        first = await a
        with pytest.raises(asyncio.CancelledError):
            await held["b"]
        await engine.generate(short, _opts())  # one more pass of the loop
        return first["tokens"], engine.adapter_store.stats()

    tokens, st = _port(_cfg(), None, scenario)
    assert tokens and st["t0"]["pinned"] == {} and st["t0"]["hits"] >= 1


# --------------------------------------------------------------------------
# tier churn and replicas
# --------------------------------------------------------------------------


def test_more_adapters_than_rows_under_concurrent_traffic(tmp_path):
    """Four adapters over two T0 rows and ~2.5 adapters of T1: waves of
    mixed-adapter traffic churn both tiers, every request completes, the
    ledger is conserved and no pin is left; a fresh replica on the shared
    T2 directory serves a T2-only adapter with the local tokens."""
    per = int(sum(a.nbytes for a in _factors(0).values()))
    t2 = {"type": "local", "path": str(tmp_path)}
    store = {**STORE, "t2": t2, "t1-bytes": int(per * 2.5)}
    names = [f"ad-{i}" for i in range(4)]
    flat, _ = _jax(_cfg(None), lambda e: asyncio.sleep(0), install=None)
    params = _params(flat)

    async def storm(engine):
        for i in (2, 3):
            publish_adapter(t2, names[i], _factors(20 + i), engine.adapter_fingerprint())
        ads = engine.adapter_store
        for _ in range(400):
            ads.apply_results()
            if all(ads.known(n) for n in names):
                break
            await asyncio.sleep(0.02)
        results = []
        for wave in range(3):
            results += await asyncio.gather(*(
                engine.generate(list(range(1 + i, 60 + i)),
                                _opts(n if (i % 2 == 0 or wave == 0) else "", **{"max-tokens": 4}))
                for i, n in enumerate(names)), return_exceptions=True)
        ref = await engine.generate(PROMPT, _opts(names[2]))
        return results, ref, engine.stats()["adapters"], _events(engine)

    install = {names[0]: _factors(20), names[1]: _factors(21)}
    results, ref, st, events = _port(_cfg(store), params, storm, install=install)
    assert not [r for r in results if isinstance(r, BaseException)], results
    assert len(results) == 12 and all(r["tokens"] for r in results)
    assert st["t0"]["evictions"] + st["evictions"] > 0 and st["hydrations"] >= 1
    assert _conserved(st["ledger"]) and st["t0"]["pinned"] == {}
    assert st["t0"]["bytes"] == st["t0"]["entries"] * st["entry_bytes"]
    assert "adapter-load" in events and "adapter-evict" in events

    async def replica_b(engine):
        ads = engine.adapter_store
        assert ads.flush(10)
        ads.apply_results()
        out = await engine.generate(PROMPT, _opts(names[2]))
        return out, engine.stats()["adapters"]

    cold, st_b = _port(_cfg({**STORE, "t2": t2}), params, replica_b, install=None)
    assert cold["tokens"] == ref["tokens"] and cold["text"] == ref["text"]
    assert st_b["hydrations"] >= 1 and _conserved(st_b["ledger"])


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_published_blob_hydrates_across_packages(tmp_path, publisher):
    """Two replicas, one per package, sharing a T2 directory: an adapter the
    one publishes hydrates in the other with the tokens the publisher's
    side gives it installed locally."""
    t2 = {"type": "local", "path": str(tmp_path)}
    store = {**STORE, "t2": t2}
    factors = _factors(31)

    async def local(engine):
        return await engine.generate(PROMPT, _opts("pub"))

    flat, want = _jax(_cfg(), local, install={"pub": factors})
    params = _params(flat)
    port_fp = TorchServingEngine(ServingConfig.from_dict(_cfg()), device="cpu",
                                 params=params).adapter_fingerprint()

    async def hydrate(engine):
        ads = engine.adapter_store
        assert ads.flush(10)
        ads.apply_results()
        assert ads.t2_has("pub")
        out = await engine.generate(PROMPT, _opts("pub"))
        st = engine.stats()["adapters"]
        assert st["hydrations"] >= 1 and st["fingerprint_refusals"] == 0
        return out

    if publisher == "jax":
        jax_ad.publish_adapter(t2, "pub", factors, port_fp)
        got = _port(_cfg(store), params, hydrate, install=None)
    else:
        publish_adapter(t2, "pub", factors, port_fp)
        _, got = _jax(_cfg(store), hydrate, install=None)
    assert got["tokens"] == want["tokens"] and got["text"] == want["text"]


def test_fingerprint_equals_jax():
    async def fp(engine):
        return engine.adapter_fingerprint(), engine._adapter_entry_bytes()

    for extra in ({}, {"model-dtype": "bfloat16"}, {"model": "moe-tiny"}):
        _, want = _jax(_cfg(**extra), fp, install=None)
        assert _port(_cfg(**extra), None, fp, install=None) == want


# --------------------------------------------------------------------------
# the prefix plane, preemption, the pipelined loop, handoffs
# --------------------------------------------------------------------------


def test_adapter_requests_bypass_the_prefix_cache():
    async def scenario(engine):
        first = await engine.generate(PROMPT, _opts("tenant-a"))
        after_first = (engine.prefix_hits, engine.block_mgr.prefix_block_count())
        again = await engine.generate(PROMPT, _opts("tenant-a"))
        base = await engine.generate(PROMPT, _opts())      # registers its blocks
        cached = engine.block_mgr.prefix_block_count()
        third = await engine.generate(PROMPT, _opts("tenant-a"))
        base2 = await engine.generate(PROMPT, _opts())     # hits them
        return (first, again, third, base, base2, after_first, cached,
                engine.prefix_hits)

    flat, want = _jax(_cfg(), scenario)
    got = _port(_cfg(), _params(flat), scenario)
    first, again, third, base, base2, after_first, cached, hits = got
    assert after_first == (0, 0)  # no registration
    assert cached > 0 and hits == 1  # only the base repeat hit
    assert first["tokens"] == again["tokens"] == third["tokens"] != base["tokens"]
    assert base2["tokens"] == base["tokens"]
    assert [r["tokens"] for r in got[:5]] == [r["tokens"] for r in want[:5]]
    assert got[5:] == want[5:]


QOS = {"slots": 2, "kv-pool-blocks": 8, "prefix-cache": False, "qos": {}}


def _preemption(adapter: str):
    async def scenario(engine):
        alone = await engine.generate("quarterly report: revenue",
                                      {"max-tokens": 40, "adapter": adapter})
        seen, inter = 0, []

        async def on_token(token, logprob, last):
            nonlocal seen
            seen += 1
            if seen == 3:
                inter.append(asyncio.ensure_future(engine.generate(
                    "what should i check now?",
                    {"max-tokens": 8, "priority": "interactive", "adapter": "tenant-b"})))
                for _ in range(3):
                    await asyncio.sleep(0)

        resumed = await engine.generate(
            "quarterly report: revenue",
            {"max-tokens": 40, "priority": "batch", "adapter": adapter}, on_token=on_token)
        interactive = await inter[0]
        sched = engine.stats()["scheduler"]
        return (alone["tokens"], resumed["tokens"], interactive["tokens"],
                (sched["preempted"], sched["resumed"]))

    return scenario


def test_qos_preemption_resumes_with_the_adapter():
    cfg = _cfg(**QOS)
    flat, want = _jax(cfg, _preemption("tenant-a"))
    got = _port(cfg, _params(flat), _preemption("tenant-a"))
    assert got == want
    alone, resumed, interactive, counts = got
    assert resumed == alone and interactive and counts == (1, 1)
    # the adapter rode the resume: base weights give other tokens
    base = _port(_cfg(**QOS), _params(flat), _preemption(""))
    assert base[0] != alone


MIXED_LOAD = [(list(range(1 + i, 20 + 9 * i)), 3 + 2 * (i % 4), ("tenant-a", "", "tenant-b")[i % 3])
              for i in range(8)]


async def _load(engine):
    out = await asyncio.gather(*(engine.generate(p, _opts(a, **{"max-tokens": n}))
                                 for p, n, a in MIXED_LOAD))
    if isinstance(engine, TorchServingEngine):
        await engine.settled()  # the over-run chunk applied: stats are final
    return [r["tokens"] for r in out], engine.stats()


def test_pipelined_loop_equals_sequential_with_mixed_adapters(monkeypatch):
    cfg = _cfg(slots=3, **{"decode-chunk-light": 0})
    flat, (want, _) = _jax(cfg, _load)
    params = _params(flat)
    piped, stats = _port(cfg, params, _load)
    assert stats["pipeline"] and stats["decode-chunks"]["heavy"] > 0
    assert stats["decode-chunks"]["host_fetches_per_chunk"] == 1.0
    monkeypatch.setenv("LS_TPU_PIPELINE", "0")
    sequential, stats_seq = _port(cfg, params, _load)
    assert not stats_seq["pipeline"]
    assert piped == sequential == want


def test_dispatch_path_makes_no_blocking_copy_with_adapter_rows():
    """The pipeline's guard on an adapter-enabled engine: the adapter rows
    upload through the content-keyed cache of the block tables (one upload
    per miss) and nothing on the dispatch path syncs."""
    engine = TorchServingEngine(ServingConfig.from_dict(_cfg(slots=3, **{"decode-chunk-light": 0})),
                                device="cpu")
    engine.install_adapter("tenant-a", ADAPTERS["tenant-a"])
    check_dispatch_path_makes_no_blocking_copy(engine, paged=True)


def test_handoff_of_an_adapter_request_decodes_with_row_0():
    """The reference's trait, kept: an export zeroes the slot's adapter row
    and the wire carries no adapter, so the decode pool continues an
    adapter request on row 0 (the base model). The first token is the
    adapter's; the rest differs from a combined engine's adapter stream;
    both packages give the same tokens."""
    pre_cfg = _cfg(**{"pool-role": "prefill", "prefix-cache": False})
    dec_cfg = _cfg(**{"pool-role": "decode", "prefix-cache": False})
    opts = _opts("tenant-a", **{"max-tokens": 12})

    def run(make, install_dec):
        async def main():
            pre, dec = make(pre_cfg), make(dec_cfg)
            try:
                pre.install_adapter("tenant-a", ADAPTERS["tenant-a"])
                if install_dec:
                    dec.install_adapter("tenant-a", ADAPTERS["tenant-a"])
                ticket = await pre.generate(PROMPT, dict(opts))
                payload = pre.take_export(ticket["handoff"])
                assert b'"adapter"' not in payload[:payload.index(b'"arrays"')]
                return ticket["tokens"], (await dec.import_handoff(payload))["tokens"]
            finally:
                await pre.close()
                await dec.close()
                TpuServingEngine.reset_instances()

        return asyncio.run(main())

    flat, combined = _jax(_cfg(**{"prefix-cache": False}),
                          lambda e: e.generate(PROMPT, dict(opts)))
    params = _params(flat)
    jax_first, jax_out = run(lambda c: TpuServingEngine(JaxServingConfig.from_dict(c)), True)
    for install_dec in (True, False):
        first, out = run(lambda c: TorchServingEngine(ServingConfig.from_dict(c), device="cpu",
                                                      params=params), install_dec)
        assert (first, out) == (jax_first, jax_out)
    assert first == combined["tokens"][:1] and out[0] == first[0]
    assert out != combined["tokens"]  # decoded on row 0, not under the adapter

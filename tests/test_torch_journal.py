"""The port's crash-requeue journal against the JAX package's.

- ``RequestJournal`` units (admit, retire, reload, the bound, compaction and
  a torn tail, the fingerprint refusal), each written by one package's
  journal and read by either's: the file format is line for line the
  same, so a journal crosses the packages both ways.
- Engines: a JAX engine's abandoned journal is replayed by a port engine to
  the JAX engine's undisturbed greedy tokens, and the reverse; every entry
  retires once, the journal ends empty. A request that no longer fits is
  retired loudly; finish and explicit failure retire; a prefill pool's
  export stays live until the decode side answers.
"""

import asyncio

import pytest
import torch

from langstream_tpu.serving import journal as jax_journal
from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.serving import journal as port_journal
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
from langstream_tpu_torch.serving.qos import RateLimited
from test_torch_engine import flatten_jax_params

MODULES = {"jax": jax_journal, "port": port_journal}
PAIRS = [("jax", "jax"), ("jax", "port"), ("port", "jax"), ("port", "port")]
PAIR_IDS = [f"{w}-writes-{r}-reads" for w, r in PAIRS]


def _entry(i: int) -> dict:
    return {"id": f"req-{i}", "prompt": [1, 2, 3 + i], "max-tokens": 8,
            "temperature": 0.0, "top-k": 0, "top-p": 1.0, "presence-penalty": 0.0,
            "frequency-penalty": 0.0, "stop": [], "tenant": f"t{i}",
            "priority": "default", "deadline": None}


@pytest.mark.parametrize("writer,reader", PAIRS, ids=PAIR_IDS)
def test_admit_retire_and_reload(tmp_path, writer, reader):
    j = MODULES[writer].RequestJournal(str(tmp_path))
    for i in range(4):
        j.admit(_entry(i))
    j.retire("req-1")
    j.retire("req-1")  # idempotent
    j.retire("never-admitted")
    assert j.flush(5.0)
    st = j.stats()
    assert st["appended"] == 4 and st["retired"] == 1
    j.close()
    j2 = MODULES[reader].RequestJournal(str(tmp_path))
    pending = j2.pending()
    assert [e["id"] for e in pending] == ["req-0", "req-2", "req-3"]
    assert pending[0]["prompt"] == [1, 2, 3]
    j2.close()


@pytest.mark.parametrize("writer,reader", PAIRS, ids=PAIR_IDS)
def test_bound_evicts_the_oldest_loudly(tmp_path, writer, reader):
    evicted = []
    j = MODULES[writer].RequestJournal(str(tmp_path), max_entries=3, on_evict=evicted.append)
    for i in range(5):
        j.admit(_entry(i))
    assert j.flush(5.0)
    assert evicted == ["req-0", "req-1"]
    assert j.stats()["live"] == 3 and j.stats()["evicted"] == 2
    j.close()
    j2 = MODULES[reader].RequestJournal(str(tmp_path))
    assert [e["id"] for e in j2.pending()] == ["req-2", "req-3", "req-4"]
    j2.close()


@pytest.mark.parametrize("writer,reader", PAIRS, ids=PAIR_IDS)
def test_compaction_and_torn_tail(tmp_path, writer, reader):
    j = MODULES[writer].RequestJournal(str(tmp_path), max_entries=4)
    # the writer waits on the table's lock, so it takes the 401 ops in one
    # pass: the file then passes the 256-op threshold in one write and
    # compacts (in several passes the last ones may stay under it)
    with j._lock:
        for i in range(200):  # past the 256-op compaction threshold
            j.admit(_entry(i))
            j.retire(f"req-{i}")
        j.admit(_entry(999))
    assert j.flush(10.0)
    j.close()
    path = tmp_path / "requests.jsonl"
    assert len(path.read_text().strip().splitlines()) <= 16
    with open(path, "a") as fh:  # a crash mid-append
        fh.write('{"op": "admit", "id": "torn-req", "pro')
    j2 = MODULES[reader].RequestJournal(str(tmp_path))
    assert [e["id"] for e in j2.pending()] == ["req-999"]
    j2.close()


@pytest.mark.parametrize("writer,reader", PAIRS, ids=PAIR_IDS)
def test_fingerprint_mismatch_is_refused_and_kept(tmp_path, writer, reader):
    j = MODULES[writer].RequestJournal(str(tmp_path), fingerprint={"model": "tiny"})
    j.admit(_entry(0))
    assert j.flush(5.0)
    j.close()
    other = MODULES[reader].RequestJournal(str(tmp_path), fingerprint={"model": "llama-1b"})
    assert other.pending() == []
    assert other.stats()["mismatched"] == 1 and other.stats()["live"] == 1
    other.close()
    same = MODULES[reader].RequestJournal(str(tmp_path), fingerprint={"model": "tiny"})
    assert [e["id"] for e in same.pending()] == ["req-0"]
    same.close()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_the_file_stays_bounded_across_restarts(tmp_path, package):
    for _ in range(6):
        j = MODULES[package].RequestJournal(str(tmp_path), max_entries=8)
        for i in range(40):
            j.admit(_entry(i))
            j.retire(f"req-{i}")
        assert j.flush(10.0)
        j.close()
    assert len((tmp_path / "requests.jsonl").read_text().splitlines()) <= 256 + 80


def test_the_files_are_line_for_line_the_same(tmp_path):
    """The same ops through both journals write the same file."""
    texts = []
    for name, module in MODULES.items():
        j = module.RequestJournal(str(tmp_path / name),
                                  fingerprint={"model": "tiny", "tokenizer": "byte"})
        for i in range(3):
            j.admit(_entry(i))
        j.retire("req-1")
        assert j.flush(5.0)
        j.close()
        texts.append((tmp_path / name / "requests.jsonl").read_text())
    assert texts[0] == texts[1] and texts[0].count("\n") == 4


def test_request_entry_as_jax():
    from types import SimpleNamespace

    request = SimpleNamespace(journey_id="ab" * 16, prompt_tokens=[5, 6], max_tokens=9,
                              temperature=0.5, top_k=3, top_p=0.9, presence_penalty=0.1,
                              frequency_penalty=0.2, stop=["x"], tenant="acme",
                              priority="batch", deadline=1.9e9)
    assert port_journal.request_entry(request) == jax_journal.request_entry(request)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

BASE = {"model": "tiny", "slots": 2, "max-seq-len": 192, "model-dtype": "float32",
        "kv-layout": "paged", "kv-block-size": 16, "decode-chunk": 4, "max-tokens": 24}
PROMPTS = [f"journaled request {i}" for i in range(3)]
OPTS = {"max-tokens": 6, "temperature": 0}
HANG = [{"site": "prefill", "shape": "hang", "hang-ms": 3000.0, "count": 1}]


def _jax(cfg):
    return TpuServingEngine(JaxServingConfig.from_dict(cfg))


def _port(cfg, flat):
    return TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu",
                              params=params_from_numpy(flat, device="cpu", dtype=torch.float32))


async def _crash(engine):
    """Accept the prompts while the prefill hangs, then die: the loop first
    (it never sees the callers go), then the callers, and no close()."""
    tasks = [asyncio.ensure_future(engine.generate(p, {**OPTS, "qos-tenant": f"t{i}"}))
             for i, p in enumerate(PROMPTS)]
    await asyncio.sleep(0)
    assert engine.journal.flush(5.0)
    assert engine.journal.stats()["live"] == len(PROMPTS)
    if engine._loop_task is not None:
        engine._loop_task.cancel()
    for t in tasks:
        t.cancel()


async def _restart(engine):
    """A fresh submission starts the loop, which replays the journal front
    of class; returns the replayed requests' results in journal order, the
    fresh result, the journal's stats and the replay event."""
    replayed = []
    requeue = engine.scheduler.requeue_front

    def capture(request):
        if request.journey_id and request.preemptions == 0:
            replayed.append(request)
        requeue(request)

    engine.scheduler.requeue_front = capture
    try:
        fresh = await engine.generate("fresh post-restart request",
                                      {"max-tokens": 4, "temperature": 0})
        results = await asyncio.wait_for(
            asyncio.gather(*(r.future for r in replayed)), 30)
        for _ in range(200):
            if engine.journal.depth() == 0:
                break
            await asyncio.sleep(0.05)
        events = [e for e in engine.flight.recent_events(0) if e["kind"] == "journal-replay"]
        # replayed newest first: each went to the front
        return ([r["tokens"] for r in reversed(results)], fresh, engine.journal.stats(),
                events)
    finally:
        await engine.close()


@pytest.mark.parametrize("crashed", ["jax", "port"])
def test_an_abandoned_journal_replays_in_the_other_package(tmp_path, crashed):
    journal_dir = str(tmp_path / "journal")
    cfg = {**BASE, "journal-dir": journal_dir}

    async def undisturbed():
        engine = _jax(BASE)
        try:
            outs = [await engine.generate(p, dict(OPTS)) for p in PROMPTS]
            return flatten_jax_params(engine.params), [o["tokens"] for o in outs]
        finally:
            await engine.close()

    flat, want = asyncio.run(undisturbed())
    TpuServingEngine.reset_instances()
    faulted = {**cfg, "faults": HANG}
    asyncio.run(_crash(_jax(faulted) if crashed == "jax" else _port(faulted, flat)))
    TpuServingEngine.reset_instances()
    replayer = _port(cfg, flat) if crashed == "jax" else _jax(cfg)
    tokens, fresh, stats, events = asyncio.run(_restart(replayer))
    TpuServingEngine.reset_instances()
    assert tokens == want and fresh["tokens"]
    assert stats["replayed"] == len(PROMPTS) and stats["retired"] == len(PROMPTS) + 1
    assert stats["live"] == 0 and stats["pending_ops"] == 0
    assert [e["requests"] for e in events] == [len(PROMPTS)]
    third = port_journal.RequestJournal(journal_dir)
    assert third.pending() == []  # each entry replayed once
    third.close()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_replay_retires_a_request_that_no_longer_fits(tmp_path, package):
    journal_dir = str(tmp_path / "jfit")
    j = port_journal.RequestJournal(journal_dir, fingerprint={"model": "tiny",
                                                              "tokenizer": "byte"})
    j.admit({**_entry(0), "prompt": list(range(64)), "max-tokens": 100000})
    j.admit({**_entry(1), "prompt": ["not", "a", "token"]})  # corrupt: retired too
    j.admit(_entry(2))
    assert j.flush(5.0)
    j.close()
    cfg = {**BASE, "journal-dir": journal_dir, "kv-pool-blocks": 10}

    async def run():
        engine = (_jax(cfg) if package == "jax" else
                  TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu"))
        try:
            fresh = await engine.generate("post-restart request",
                                          {"max-tokens": 4, "temperature": 0})
            for _ in range(200):
                if engine.journal.depth() == 0:
                    break
                await asyncio.sleep(0.05)
            return fresh, engine.journal.stats()
        finally:
            await engine.close()
            TpuServingEngine.reset_instances()

    fresh, stats = asyncio.run(run())
    assert fresh["tokens"] and stats["live"] == 0


def test_finish_and_explicit_failure_retire(tmp_path):
    journal_dir = str(tmp_path / "j2")
    engine = TorchServingEngine(ServingConfig.from_dict({**BASE, "journal-dir": journal_dir}),
                                device="cpu")

    async def run():
        try:
            await engine.generate("finish me", {"max-tokens": 4, "temperature": 0})
            assert engine.journal.flush(5.0)
            assert engine.journal.stats()["live"] == 0
            task = asyncio.ensure_future(engine.generate(
                "shed me", {"max-tokens": 64, "temperature": 0}))
            await asyncio.sleep(0)
            engine._fail_inflight(RateLimited("draining", 1.0, "test"))
            with pytest.raises(RateLimited):
                await task
            assert engine.journal.flush(5.0)
            return engine.journal.stats()
        finally:
            await engine.close()

    stats = asyncio.run(run())
    assert stats["live"] == 0 and stats["retired"] == 2 and stats["appended"] == 2


def test_a_prefill_pool_export_retires_when_the_decode_side_answers(tmp_path):
    journal_dir = str(tmp_path / "jprefill")
    engine = TorchServingEngine(ServingConfig.from_dict(
        {**BASE, "journal-dir": journal_dir, "pool-role": "prefill"}), device="cpu")

    async def run():
        try:
            out = await engine.generate("handoff me", {"max-tokens": 8, "temperature": 0})
            assert out["finish_reason"] == "handoff"
            assert engine.journal.flush(5.0)
            assert engine.journal.stats()["live"] == 1
            assert engine.stats()["kvtransfer"]["unsettled_handoffs"] == 1
            engine.handoff_settled(out["handoff"])
            engine.handoff_settled(out["handoff"])  # idempotent
            assert engine.journal.flush(5.0)
            assert engine.stats()["kvtransfer"]["unsettled_handoffs"] == 0
            return engine.journal.stats()
        finally:
            await engine.close()

    stats = asyncio.run(run())
    assert stats["appended"] == 1 and stats["retired"] == 1 and stats["live"] == 0


def test_warmup_probes_are_not_journaled(tmp_path):
    journal_dir = str(tmp_path / "jwarm")
    engine = TorchServingEngine(ServingConfig.from_dict(
        {**BASE, "journal-dir": journal_dir, "warmup-on-start": True}), device="cpu")

    async def run():
        try:
            await engine.generate("after warmup", {"max-tokens": 4, "temperature": 0})
            assert engine.journal.flush(5.0)
            return engine.journal.stats(), engine.stats()["warmup"]["state"]
        finally:
            await engine.close()

    stats, warmup = asyncio.run(run())
    assert warmup == "done" and stats["appended"] == 1 and stats["retired"] == 1

"""The port's transform, flow, ``re-rank`` and ``query`` agents against the
JAX package's, on the same inputs: each case builds the agent type from each
package's registry, runs one record through it and compares what comes out
(value, key and headers), with no tolerance.

The cases are ``tests/test_agents.py``'s transform and MMR cases, cases of
each transform's other options, the flow agents' routes and events, and
seeded random ``re-rank`` and ``query`` cases (numpy's generator, seed per
case)."""

import asyncio
import logging
import types

import numpy as np
import pytest

import langstream_tpu.agents.builtin as jax_builtin
import langstream_tpu.agents.vector as jax_vector
import langstream_tpu.api.agent as jax_agent
import langstream_tpu.api.record as jax_record
import langstream_tpu.runtime.composite as jax_composite
import langstream_tpu_torch.agents.builtin as port_builtin
import langstream_tpu_torch.agents.vector as port_vector
import langstream_tpu_torch.api.agent as port_agent
import langstream_tpu_torch.api.record as port_record
import langstream_tpu_torch.runtime.composite as port_composite

PACKAGES = {
    "jax": types.SimpleNamespace(
        factories=jax_builtin._FACTORIES, make_record=jax_record.make_record,
        AgentContext=jax_agent.AgentContext, process_await=jax_composite.process_await,
        vector=jax_vector),
    "port": types.SimpleNamespace(
        factories=port_builtin._FACTORIES, make_record=port_record.make_record,
        AgentContext=port_agent.AgentContext, process_await=port_composite.process_await,
        vector=port_vector),
}


@pytest.fixture(autouse=True)
def _fresh_stores():
    for pkg in PACKAGES.values():
        pkg.vector.InMemoryVectorStore.reset()
    yield
    for pkg in PACKAGES.values():
        pkg.vector.InMemoryVectorStore.reset()


async def _run_single(pkg, agent_type, configuration, record, resources=None):
    agent = pkg.factories[agent_type]()
    await agent.init({**configuration, "__resources__": resources or {}, "__globals__": {}})
    await agent.setup(pkg.AgentContext())
    await agent.start()
    try:
        (result,) = await pkg.process_await(agent, [record])
    finally:
        await agent.close()
    if result.error:
        return ("error", type(result.error).__name__, str(result.error))
    return [(r.value, r.key, r.headers) for r in result.results]


def on_both(agent_type, configuration, value=None, key=None, headers=None, resources=None,
            setup=None):
    """The case under each package: ``setup(pkg)`` runs first (on the
    package's own stores). Returns (jax_out, port_out)."""
    out = []
    for name in ("jax", "port"):
        pkg = PACKAGES[name]

        async def main():
            if setup is not None:
                await setup(pkg)
            record = pkg.make_record(value=value, key=key, headers=headers)
            return await _run_single(pkg, agent_type, configuration, record, resources)

        out.append(asyncio.run(main()))
    return tuple(out)


# ---------------------------------------------------------------------------
# transforms (tests/test_agents.py:48-138, and each step's other options)
# ---------------------------------------------------------------------------

TRANSFORM_CASES = {
    "compute": ("compute", {"fields": [{"name": "value.b", "expression": "value.a * 3"}]},
                {"a": 2, "secret": "x"}, None, [({"a": 2, "secret": "x", "b": 6}, None, ())]),
    "compute-typed": ("compute", {"fields": [
        {"name": "value.s", "expression": "value.a + 1", "type": "string"},
        {"name": "value.f", "expression": "value.a", "type": "double"},
        {"name": "key", "expression": "fn:concat('k-', value.a)"}]}, {"a": 2}, None, None),
    "drop-fields": ("drop-fields", {"fields": ["secret"]}, {"a": 2, "b": 6, "secret": "x"},
                    None, [({"a": 2, "b": 6}, None, ())]),
    "drop-fields-key": ("drop-fields", {"part": "key", "fields": ["k2", "value.v2"]},
                        {"v1": 1, "v2": 2}, {"k1": 1, "k2": 2}, None),
    "when-skips": ("compute", {"when": "value.a > 10",
                               "fields": [{"name": "value.b", "expression": "99"}]},
                   {"a": 1}, None, [({"a": 1}, None, ())]),
    "drop-when": ("drop", {"when": "value.x == 1"}, {"x": 1}, None, []),
    "drop-kept": ("drop", {"when": "value.x == 1"}, {"x": 2}, None, [({"x": 2}, None, ())]),
    "flatten": ("flatten", {}, {"a": {"b": {"c": 1}}}, None, [({"a_b_c": 1}, None, ())]),
    "flatten-key": ("flatten", {"part": "key", "delimiter": "."},
                    {"v": 1}, {"a": {"b": 2, "c": {"d": 3}}, "e": 4}, None),
    "merge-key-value": ("merge-key-value", {}, {"v": 1}, {"k": 2},
                        [({"k": 2, "v": 1}, {"k": 2}, ())]),
    "unwrap-key-value": ("unwrap-key-value", {}, {"v": 1}, {"k": 2}, [({"v": 1}, None, ())]),
    "unwrap-key": ("unwrap-key-value", {"unwrapKey": True}, {"v": 1}, {"k": 2},
                   [({"k": 2}, None, ())]),
    "cast-string": ("cast", {"schema-type": "string"}, {"a": 1}, None,
                    [('{"a": 1}', None, ())]),
    "cast-int32": ("cast", {"schema-type": "int32"}, "42", None, [(42, None, ())]),
    "cast-boolean": ("cast", {"schema-type": "boolean"}, "True", None, None),
    "cast-bytes-key": ("cast", {"schema-type": "bytes", "part": "key"}, "v", "abc", None),
    "cast-unknown": ("cast", {"schema-type": "decimal"}, "1", None, None),
}


@pytest.mark.parametrize("case", sorted(TRANSFORM_CASES))
def test_transform_equals_the_jax_step(case):
    agent_type, cfg, value, key, want = TRANSFORM_CASES[case]
    jax_out, port_out = on_both(agent_type, cfg, value=value, key=key)
    assert port_out == jax_out
    if want is not None:
        assert port_out == want


# ---------------------------------------------------------------------------
# flow control
# ---------------------------------------------------------------------------

ROUTES = {"routes": [
    {"when": "value.kind == 'spam'", "action": "drop"},
    {"when": "value.kind == 'alert'", "destination": "alerts-topic"},
    {"when": "value.n > 5"},
]}
FLOW_CASES = {
    "dispatch-drop": ("dispatch", ROUTES, {"kind": "spam", "n": 9}),
    "dispatch-destination": ("dispatch", ROUTES, {"kind": "alert", "n": 1}),
    "dispatch-match-no-destination": ("dispatch", ROUTES, {"kind": "info", "n": 9}),
    "dispatch-no-match": ("dispatch", ROUTES, {"kind": "info", "n": 1}),
    "trigger-event": ("trigger-event", {
        "when": "value.n > 5", "destination": "events-topic",
        "fields": [{"name": "value.who", "expression": "value.kind"},
                   {"name": "seen", "expression": "value.n * 2"}]}, {"kind": "a", "n": 7}),
    "trigger-event-replace": ("trigger-event", {
        "destination": "events-topic", "continue-processing": False}, {"kind": "a", "n": 1}),
    "trigger-event-guarded": ("trigger-event", {"when": "value.n > 5",
                                                "destination": "events-topic"},
                              {"kind": "a", "n": 1}),
    "log-event": ("log-event", {"message": "got {{ value.kind }}"}, {"kind": "b", "n": 2}),
}


@pytest.mark.parametrize("case", sorted(FLOW_CASES))
def test_flow_agent_equals_the_jax_agent(case, caplog):
    agent_type, cfg, value = FLOW_CASES[case]
    with caplog.at_level(logging.INFO):
        jax_out, port_out = on_both(agent_type, cfg, value=value, key="k1")
    assert port_out == jax_out
    if agent_type == "log-event":
        logged = [r.getMessage() for r in caplog.records if "got b" in r.getMessage()]
        assert len(logged) == 2 and logged[0] == logged[1]


def test_dispatch_routes_by_destination_header():
    _, dropped = on_both("dispatch", ROUTES, value={"kind": "spam"})
    assert dropped == []
    _, routed = on_both("dispatch", ROUTES, value={"kind": "alert", "n": 1})
    assert routed[0][2] == (("langstream-destination-topic", "alerts-topic"),)


def test_timer_source_equals_the_jax_source():
    cfg = {"period-seconds": 0.05, "fields": [
        {"name": "value.kind", "expression": "'tick'"},
        {"name": "value.twice", "expression": "2 * 21"}]}

    async def read(pkg):
        source = pkg.factories["timer-source"]()
        await source.init({**cfg, "__resources__": {}, "__globals__": {}})
        await source.setup(pkg.AgentContext())
        await source.start()
        polls = 0
        while True:
            polls += 1
            records = await source.read()
            if records:
                break
        await source.close()
        return [(r.value, r.key) for r in records], polls > 1

    jax_out = asyncio.run(read(PACKAGES["jax"]))
    port_out = asyncio.run(read(PACKAGES["port"]))
    assert port_out == jax_out == ([({"kind": "tick", "twice": 42}, None)], True)


# ---------------------------------------------------------------------------
# re-rank: tests/test_agents.py:423's MMR case and seeded random ones
# ---------------------------------------------------------------------------

MMR_DOCS = [{"text": "cats purr", "emb": [1.0, 0.0]},
            {"text": "cats purr again", "emb": [0.99, 0.1]},
            {"text": "dogs bark", "emb": [0.0, 1.0]}]
MMR_CFG = {"field": "value.docs", "query-text": "value.q", "query-embeddings": "value.q_emb",
           "text-field": "record.text", "embeddings-field": "record.emb",
           "output-field": "value.docs", "max": 2, "lambda": 0.3}


def test_rerank_mmr_equals_the_jax_agent():
    jax_out, port_out = on_both("re-rank", MMR_CFG,
                                value={"docs": MMR_DOCS, "q": "cats", "q_emb": [1.0, 0.0]})
    assert port_out == jax_out
    assert [d["text"] for d in port_out[0][0]["docs"]] == ["cats purr", "dogs bark"]


WORDS = "cat dog fish bird purr bark swim fly loud soft fast slow".split()


def _random_rerank_case(seed: int):
    rng = np.random.default_rng(seed)
    dim = int(rng.integers(2, 9))
    docs = []
    for i in range(int(rng.integers(0, 25))):
        doc = {"text": " ".join(rng.choice(WORDS, int(rng.integers(1, 9)))), "n": i}
        if rng.random() < 0.8:
            doc["emb"] = rng.standard_normal(dim).round(4).tolist()
        docs.append(doc)
    value = {"docs": docs, "q": " ".join(rng.choice(WORDS, 3))}
    if rng.random() < 0.8:
        value["q_emb"] = rng.standard_normal(dim).round(4).tolist()
    cfg = {**MMR_CFG, "output-field": "value.ranked", "max": int(rng.integers(1, 8)),
           "lambda": float(rng.choice([0.0, 0.3, 0.5, 1.0])),
           "k1": float(rng.choice([0.9, 1.2, 2.0])), "b": float(rng.choice([0.0, 0.75]))}
    return cfg, value


@pytest.mark.parametrize("seed", range(8))
def test_rerank_random_case_equals_the_jax_agent(seed):
    cfg, value = _random_rerank_case(seed)
    jax_out, port_out = on_both("re-rank", cfg, value=value)
    assert port_out == jax_out
    ranked = port_out[0][0]["ranked"]
    assert len(ranked) == min(cfg["max"], len(value["docs"]))


def test_rerank_with_vectorless_results_ranks_by_bm25():
    """The rag-pipeline's trait: ``query-vector-db`` returns no vectors, so
    ``re-rank`` ranks the texts by BM25 alone (a kept reference trait)."""
    docs = [{"id": i, "text": t, "similarity": 0.5}
            for i, t in enumerate(["dogs bark", "cats purr", "cats cats purr"])]
    cfg = {**MMR_CFG, "embeddings-field": "record.vector", "max": 3}
    jax_out, port_out = on_both("re-rank", cfg,
                                value={"docs": docs, "q": "cats", "q_emb": [1.0, 0.0]})
    assert port_out == jax_out
    assert [d["id"] for d in port_out[0][0]["docs"]] == [2, 1, 0]


# ---------------------------------------------------------------------------
# query and query-vector-db on the in-memory store: seeded random cases
# ---------------------------------------------------------------------------

RESOURCES = {"vdb": {"type": "datasource", "name": "vdb",
                     "configuration": {"service": "in-memory"}}}


def _random_store(seed: int):
    rng = np.random.default_rng(seed)
    dim = int(rng.integers(2, 7))
    rows = [(f"d{i}", rng.standard_normal(dim).round(5).tolist() if rng.random() < 0.9 else None,
             {"text": " ".join(rng.choice(WORDS, 3)), "genre": str(rng.choice(["a", "b"]))})
            for i in range(int(rng.integers(1, 30)))]
    query = rng.standard_normal(dim).round(5).tolist()
    top_k = int(rng.integers(1, 12))
    flt = {"genre": "a"} if rng.random() < 0.5 else None
    return rows, query, top_k, flt


def _seed(rows):
    async def setup(pkg):
        store = pkg.vector.InMemoryVectorStore.get("vdb")
        for item_id, vector, payload in rows:
            await store.upsert("docs", item_id, vector, payload)
    return setup


@pytest.mark.parametrize("agent_type", ["query", "query-vector-db"])
@pytest.mark.parametrize("seed", range(6))
def test_query_random_case_equals_the_jax_agent(agent_type, seed):
    rows, query, top_k, flt = _random_store(seed)
    q = '{"collection-name": "docs", "vector": ?, "top-k": %d%s}' % (
        top_k, ', "filter": {"genre": "a"}' if flt else "")
    cfg = {"datasource": "vdb", "query": q, "fields": ["value.qv"],
           "output-field": "value.related"}
    if agent_type == "query" and seed % 2:
        cfg["only-first"] = True
    jax_out, port_out = on_both(agent_type, cfg, value={"qv": query}, resources=RESOURCES,
                                setup=_seed(rows))
    assert port_out == jax_out
    related = port_out[0][0]["related"]
    assert related and all(r["genre"] == "a" for r in related) if flt else related


def test_query_execute_mode_equals_the_jax_agent():
    """``mode: execute`` writes through ``execute_write`` and reports the
    count; the store then holds the row in both packages."""
    cfg = {"datasource": "vdb", "mode": "execute",
           "query": '{"collection": "docs", "id": ?, "vector": ?, "payload": {"t": "x"}}',
           "fields": ["value.id", "value.v"], "output-field": "value.written"}
    jax_out, port_out = on_both("query", cfg, value={"id": "e1", "v": [1.0, 2.0]},
                                resources=RESOURCES)
    assert port_out == jax_out
    assert port_out[0][0]["written"] == {"count": 1}
    rows = [pkg.vector.InMemoryVectorStore.get("vdb").collection("docs").search(None, 5, None)
            for pkg in PACKAGES.values()]
    assert rows[0] == rows[1] == [{"t": "x", "id": "e1"}]


def test_query_with_too_few_params_fails_alike():
    cfg = {"datasource": "vdb", "query": '{"vector": ?, "top-k": ?}', "fields": ["value.qv"]}
    jax_out, port_out = on_both("query", cfg, value={"qv": [1.0]}, resources=RESOURCES)
    assert port_out == jax_out
    assert port_out[0] == "error" and "placeholders" in port_out[2]

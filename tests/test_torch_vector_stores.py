"""The port's vector stores against the JAX package's, on the same inputs:

- the in-memory store: a seeded random run of upserts, deletes and searches
  (with and without vectors and filters), persisted to JSONL and reloaded;
- JDBC over SQLite: the datasource, the ``jdbc-table`` asset manager, and
  ``tests/test_vector_stores.py``'s sink-and-query app through each
  package's runner; the ``postgres`` driver refused alike;
- ``resolve_datasource`` over every service name;
- the HTTP stores (OpenSearch, Pinecone, Milvus, Solr, Astra) against the
  JAX tests' fake services, loaded by path from ``tests/test_vector_stores.py``
  and ``tests/test_vector_stores_ext.py`` and unedited: the same calls
  through both data sources and asset managers give equal results, and the
  fakes see equal requests (method, path, query, body and auth headers);
- Cassandra over CQL v4 against ``tests/test_cassandra_cql.py``'s fake
  server: equal results, rows, DDL and prepared statements; and the type
  codec on that file's cases;
- https and wss through the port's client against TLS fakes with an openssl
  self-signed certificate (as ``tests/test_torch_kafka_security.py`` makes
  one), and OpenSearch's default ``https: true`` through both stores.

Similarities are compared with no tolerance: both packages compute them
with the same numpy operations, or the fakes do."""

import asyncio
import importlib.util
import itertools
import json
import ssl
import subprocess
import types
from pathlib import Path
from urllib.parse import parse_qsl

import numpy as np
import pytest

import langstream_tpu.agents  # noqa: F401  (registers the asset managers)
import langstream_tpu.api.application as jax_application
import langstream_tpu.core.parser as jax_parser
import langstream_tpu.runtime.local_runner as jax_local
import langstream_tpu_torch.agents  # noqa: F401  (registers the asset managers)
import langstream_tpu_torch.api.application as port_application
import langstream_tpu_torch.core.parser as port_parser
import langstream_tpu_torch.runtime.local_runner as port_local

REPO = Path(__file__).resolve().parents[1]


def _package(name, root, application, parser, local):
    def module(name):
        return importlib.import_module(f"{root}.agents.{name}")

    return types.SimpleNamespace(name=name, module=module, AssetDefinition=application.AssetDefinition,
                                 registry=module("assets").AssetManagerRegistry,
                                 parse=parser.build_application_from_files,
                                 Runner=local.LocalApplicationRunner)


PACKAGES = {
    "jax": _package("jax", "langstream_tpu", jax_application, jax_parser, jax_local),
    "port": _package("port", "langstream_tpu_torch", port_application, port_parser, port_local),
}


def _load(name: str):
    """A JAX test module, by path, for its fakes and helpers."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", REPO / "tests" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_CLUSTERS = itertools.count()


def _instance() -> str:
    """``tests/test_vector_stores.py``'s instance on a broker cluster of its
    own (a memory topic serves the first event loop that used it)."""
    return STORES.INSTANCE.replace(
        "type: memory", f"type: memory\n    configuration: {{cluster: 'vs-{next(_CLUSTERS)}'}}")


STORES = _load("test_vector_stores")
STORES_EXT = _load("test_vector_stores_ext")
CQL = _load("test_cassandra_cql")


def on_both(scenario):
    """``scenario(pkg)`` under each package: (jax_result, port_result)."""
    return tuple(asyncio.run(scenario(PACKAGES[name])) for name in ("jax", "port"))


@pytest.fixture(autouse=True)
def _fresh_stores():
    for pkg in PACKAGES.values():
        pkg.module("vector").InMemoryVectorStore.reset()
        pkg.module("jdbc").JdbcDataSource.reset_shared()
    yield
    for pkg in PACKAGES.values():
        pkg.module("vector").InMemoryVectorStore.reset()
        pkg.module("jdbc").JdbcDataSource.reset_shared()


# ---------------------------------------------------------------------------
# the in-memory store
# ---------------------------------------------------------------------------


def _store_ops(seed: int) -> list[tuple]:
    rng = np.random.default_rng(seed)
    dim = int(rng.integers(2, 6))
    ops = []
    for _ in range(60):
        kind = rng.choice(["upsert", "upsert", "upsert", "delete", "search"])
        item = f"i{int(rng.integers(0, 12))}"
        coll = str(rng.choice(["docs", "other"]))
        if kind == "upsert":
            vec = rng.standard_normal(dim).round(6).tolist() if rng.random() < 0.85 else None
            ops.append(("upsert", coll, item, vec, {"g": str(rng.choice(["a", "b"])),
                                                   "n": int(rng.integers(0, 100))}))
        elif kind == "delete":
            ops.append(("delete", coll, item))
        else:
            vec = rng.standard_normal(dim).round(6).tolist() if rng.random() < 0.8 else None
            flt = {"g": "a"} if rng.random() < 0.4 else None
            ops.append(("search", coll, vec, int(rng.integers(1, 9)), flt))
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_in_memory_store_equals_the_jax_store(tmp_path, seed):
    ops = _store_ops(seed)

    async def scenario(pkg):
        vector = pkg.module("vector")
        path = tmp_path / pkg.name
        store = vector.InMemoryVectorStore(path)
        out = []
        for op in ops:
            if op[0] == "upsert":
                await store.upsert(*op[1:])
            elif op[0] == "delete":
                await store.delete_item(*op[1:])
            else:
                out.append(store.collection(op[1]).search(*op[2:]))
        files = {p.name: p.read_text() for p in sorted(path.glob("*.jsonl"))}
        reloaded = vector.InMemoryVectorStore(path)
        again = [reloaded.collection(op[1]).search(*op[2:]) for op in ops if op[0] == "search"]
        return out, files, again

    jax_out, port_out = on_both(scenario)
    assert port_out == jax_out
    assert port_out[1] and any(port_out[0])


def test_in_memory_store_persists_and_reloads_alike(tmp_path):
    """Upsert, delete, filter, persist and reload; the JSONL files equal."""
    async def scenario(pkg):
        vector = pkg.module("vector")
        path = tmp_path / pkg.name
        store = vector.InMemoryVectorStore(path)
        await store.upsert("docs", "a", [1.0, 0.0, 0.0], {"text": "alpha", "g": "x"})
        await store.upsert("docs", "b", [0.0, 2.0, 0.0], {"text": "beta", "g": "y"})
        await store.upsert("docs", "c", None, {"text": "gamma", "g": "x"})
        await store.upsert("docs", "a", [0.8, 0.6, 0.0], {"text": "alpha2", "g": "x"})
        await store.execute_write('{"collection": "docs", "id": "d", "vector": ?, '
                                  '"payload": {"text": "delta", "g": "y"}}', [[0.0, 0.0, 3.0]])
        await store.delete_item("docs", "b")
        await store.execute_write('{"collection": "docs", "id": "zz", "delete": true}', [])
        found = [await store.fetch_data('{"collection": "docs", "vector": ?, "top-k": 5}',
                                        [[1.0, 0.1, 0.0]]),
                 await store.fetch_data('{"collection-name": "docs", "top-k": 5, '
                                        '"filter": {"g": "x"}}', []),
                 await store.fetch_data('{"collection": "docs", "vector": ?, "topK": 1, '
                                        '"filter": {"g": "y"}}', [[1.0, 0.0, 0.0]])]
        files = {p.name: p.read_text() for p in sorted(path.glob("*.jsonl"))}
        reloaded = vector.InMemoryVectorStore(path)
        again = await reloaded.fetch_data('{"collection": "docs", "vector": ?, "top-k": 5}',
                                          [[1.0, 0.1, 0.0]])
        return found, files, again

    jax_out, port_out = on_both(scenario)
    assert port_out == jax_out
    found, files, again = port_out
    assert [r["id"] for r in found[0]] == ["a", "d"] and found[1] == [
        {"text": "alpha2", "g": "x", "id": "a"}, {"text": "gamma", "g": "x", "id": "c"}]
    assert [r["id"] for r in found[2]] == ["d"]
    assert list(files) == ["docs.jsonl"] and again == found[0]


def test_in_memory_collection_asset_alike():
    async def scenario(pkg):
        mgr = pkg.registry.get("in-memory-collection")
        asset = pkg.AssetDefinition(id="a", name="docs", asset_type="in-memory-collection",
                                    creation_mode="create-if-not-exists",
                                    config={"datasource": "vdb", "collection-name": "docs"})
        before = await mgr.asset_exists(asset)
        await mgr.deploy_asset(asset)
        return before, await mgr.asset_exists(asset)

    assert on_both(scenario) == ((False, True), (False, True))


# ---------------------------------------------------------------------------
# JDBC over SQLite
# ---------------------------------------------------------------------------


def test_jdbc_datasource_equals_the_jax_one(tmp_path):
    """``tests/test_vector_stores.py``'s upsert/delete/decode case, with the
    asset manager, an execute and a similarity query, on a file each."""
    async def scenario(pkg):
        jdbc = pkg.module("jdbc")
        url = str(tmp_path / f"{pkg.name}.db")
        mgr = pkg.registry.get("jdbc-table")
        asset = pkg.AssetDefinition(
            id="t", name="t", asset_type="jdbc-table", creation_mode="create-if-not-exists",
            config={"table-name": "t", "datasource": {"service": "jdbc", "url": url},
                    "create-statements": [
                        "CREATE TABLE t (id TEXT PRIMARY KEY, embeddings TEXT, meta TEXT, "
                        "text TEXT)"],
                    "delete-statements": ["DROP TABLE t"]})
        out = [await mgr.asset_exists(asset)]
        await mgr.deploy_asset(asset)
        out.append(await mgr.asset_exists(asset))
        ds = jdbc.JdbcDataSource.get({"configuration": {"url": url}})
        await ds.upsert("t", "x", [0.5, 0.5], {"meta": {"k": "v"}, "text": "ex"})
        await ds.upsert("t", "x", [1.0, 0.0], {"meta": {"k": "v2"}, "text": "ex2"})
        await ds.upsert("t", "y", [0.0, 1.0], {"meta": None, "text": "why"})
        out.append(await ds.execute_write("INSERT INTO t (id, embeddings, text) VALUES (?, ?, ?)",
                                          ["z", [0.6, 0.8], "zed"]))
        out.append(await ds.fetch_data("SELECT * FROM t ORDER BY id", []))
        out.append(await ds.fetch_data(
            "SELECT id, cosine_similarity(embeddings, ?) AS s FROM t ORDER BY s DESC",
            [[1.0, 0.1]]))
        await ds.delete_item("t", "x")
        out.append(await ds.fetch_data("SELECT id FROM t ORDER BY id", []))
        await mgr.delete_asset(asset)
        out.append(await mgr.asset_exists(asset))
        await ds.close()
        return out

    jax_out, port_out = on_both(scenario)
    assert port_out == jax_out
    assert port_out[0:2] == [False, True] and port_out[-1] is False
    assert port_out[3][0]["embeddings"] == [1.0, 0.0]


def test_jdbc_sink_query_asset_app_through_both_runners(tmp_path):
    """``tests/test_vector_stores.py``'s app: the asset creates the table,
    ``vector-db-sink`` writes, ``query-vector-db`` reads back."""
    docs = [{"id": "a", "embedding": [1.0, 0.0, 0.0], "text": "apples"},
            {"id": "b", "embedding": [0.0, 1.0, 0.0], "text": "bread"},
            {"id": "c", "embedding": [0.9, 0.1, 0.0], "text": "apricots"}]

    async def scenario(pkg):
        url = str(tmp_path / f"app-{pkg.name}.db")
        runner = pkg.Runner(pkg.parse(STORES._jdbc_app(url), _instance()))
        ds = pkg.module("jdbc").JdbcDataSource.get(
            {"configuration": {"driver": "sqlite", "url": url}})
        async with runner:
            for d in docs:
                await runner.produce("docs-in", d)
            for _ in range(200):
                rows = await ds.fetch_data("SELECT COUNT(*) AS n FROM docs", [])
                if rows[0]["n"] == 3:
                    break
                await asyncio.sleep(0.05)
            await runner.produce("query-in", {"embedding": [1.0, 0.05, 0.0]})
            (msg,) = await runner.wait_for_messages("query-out", 1)
        stored = await ds.fetch_data("SELECT * FROM docs ORDER BY id", [])
        return msg.value["results"], stored

    jax_out, port_out = on_both(scenario)
    assert port_out == jax_out
    results, stored = port_out
    assert [r["id"] for r in results] == ["a", "c"] and len(stored) == 3


def test_postgres_driver_is_refused_alike():
    resources = {"pg": {"type": "datasource", "name": "pg",
                        "configuration": {"service": "pgvector", "url": "postgres://x"}}}
    errors = []
    for pkg in PACKAGES.values():
        with pytest.raises(RuntimeError, match="psycopg") as info:
            pkg.module("vector").resolve_datasource("pg", resources)
        errors.append(str(info.value).split("client library")[0])
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# resolve_datasource
# ---------------------------------------------------------------------------

SERVICES = {
    "mem": {"service": "in-memory"}, "herd": {"service": "herddb"},
    "sql": {"service": "jdbc", "url": ":memory:"}, "lite": {"service": "sqlite"},
    "os": {"service": "opensearch", "host": "x"}, "es": {"service": "elasticsearch"},
    "pc": {"service": "pinecone", "api-key": "k", "endpoint": "http://x"},
    "mv": {"service": "milvus", "url": "http://x"}, "sl": {"service": "solr", "host": "x"},
    "as": {"service": "astra-vector-db", "token": "t", "endpoint": "http://x"},
    "as2": {"service": "astra", "token": "t", "endpoint": "https://x"},
    "cql": {"service": "cassandra", "contact-points": "10.0.0.1"},
    "nope": {"service": "mongodb"},
}


@pytest.mark.parametrize("name", sorted(SERVICES) + [None, "absent"])
def test_resolve_datasource_equals_the_jax_table(name):
    resources = {rid: {"type": "vector-database" if rid in ("os", "pc") else "datasource",
                       "name": rid, "configuration": cfg} for rid, cfg in SERVICES.items()}
    if name is None:
        resources = {}
    got = []
    for pkg in PACKAGES.values():
        try:
            ds = pkg.module("vector").resolve_datasource(name, resources)
            got.append((type(ds).__name__, type(ds).__module__.rsplit(".", 1)[-1]))
        except RuntimeError as e:
            got.append(("error", str(e)))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# the HTTP stores against the JAX tests' fakes
# ---------------------------------------------------------------------------


def logged(fake_cls):
    """The fake, recording each request after it handled it: method, path,
    decoded query, body (JSON, form pairs or text) and auth headers."""

    class Logged(fake_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.requests = []

        async def handle(self, request):
            response = await super().handle(request)
            raw = await request.read()  # what the handler read, or nothing
            if request.content_type == "application/x-www-form-urlencoded":
                body = sorted(parse_qsl(raw.decode()))
            else:
                try:
                    body = json.loads(raw) if raw else None
                except ValueError:
                    body = raw.decode()
            self.requests.append((request.method, request.path, sorted(request.query.items()),
                                  body, {k: request.headers.get(k)
                                         for k in ("Authorization", "Api-Key", "Token")}))
            return response

    return Logged


def _fake_run(fake_cls, body, ssl_context=None):
    """A scenario: start a fresh logged fake, run ``body(pkg, fake)``,
    return (its result, the fake's requests)."""
    async def scenario(pkg):
        fake = logged(fake_cls)()
        if ssl_context is None:
            await fake.start()
        else:
            await _start_tls(fake, ssl_context)
        try:
            result = await body(pkg, fake)
        finally:
            await fake.stop()
        return result, fake.requests

    return scenario


async def _start_tls(fake, ssl_context):
    import socket

    from aiohttp import web

    app = web.Application()
    app.router.add_route("*", "/{tail:.*}", fake.handle)
    fake.app_runner = web.AppRunner(app)
    await fake.app_runner.setup()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        fake.port = s.getsockname()[1]
    await web.TCPSite(fake.app_runner, "127.0.0.1", fake.port, ssl_context=ssl_context).start()


async def _opensearch(pkg, fake, https=False):
    mod = pkg.module("opensearch")
    res = {"service": "opensearch", "host": "127.0.0.1", "port": fake.port,
           "index-name": "docs", "username": "elastic", "password": "pw"}
    if not https:
        res["https"] = False
    resource = {"configuration": res}
    mgr = mod.OpenSearchIndexAssetManager()
    asset = pkg.AssetDefinition(
        id="a", name="docs", asset_type="opensearch-index", creation_mode="create-if-not-exists",
        config={"index-name": "docs", "datasource": res, "settings": {"knn": True},
                "mappings": {"properties": {"embeddings": {"type": "knn_vector"}}}})
    out = [await mgr.asset_exists(asset)]
    await mgr.deploy_asset(asset)
    out.append(await mgr.asset_exists(asset))
    ds = mod.OpenSearchDataSource(resource)
    for item, vec, text in (("a", [1, 0, 0], "alpha"), ("b", [0, 1, 0], "beta"),
                            ("c", [0.9, 0.1, 0], "gamma")):
        await ds.upsert("docs", item, vec, {"text": text})
    out.append(await ds.fetch_data(
        '{"index": "docs", "query": {"knn": {"embeddings": {"vector": ?, "k": 2}}}}',
        [[1.0, 0.05, 0.0]]))
    await ds.execute_write('{"index": "docs", "id": "d", "text": "delta", "embeddings": ?}',
                           [[0.0, 0.0, 1.0]])
    await ds.execute_write('{"index": "docs", "id": "a", "delete": true}', [])
    await ds.delete_item("docs", "never-existed")
    out.append(await ds.fetch_data('{"query": {"match_all": {}}}', []))
    try:
        await ds._request("POST", "/docs/_unknown", {})
    except RuntimeError as e:
        out.append(str(e))
    await mgr.delete_asset(asset)
    out.append(await mgr.asset_exists(asset))
    await ds.close()
    return out


async def _pinecone(pkg, fake):
    mod = pkg.module("pinecone")
    ds = mod.PineconeDataSource({"configuration": {
        "service": "pinecone", "api-key": "pk-test", "index-name": "docs",
        "endpoint": f"http://127.0.0.1:{fake.port}/"}})
    await ds.upsert("default", "a", [1, 0, 0], {"text": "alpha", "genre": "x", "none": None})
    await ds.upsert("ns1", "b", [0, 1, 0], {"text": "beta", "genre": "y"})
    await ds.upsert("default", "c", [0.7, 0.7, 0], {"text": "gamma", "genre": "y"})
    out = [await ds.fetch_data('{"vector": ?, "topK": 2, "includeMetadata": true}', [[1, 0, 0]]),
           await ds.fetch_data('{"vector": ?, "topK": 2, "filter": {"genre": {"$eq": "y"}}, '
                               '"includeValues": true}', [[1, 0, 0]]),
           await ds.fetch_data('{"vector": ?, "top-k": 3, "namespace": "ns1"}', [[0, 1, 0]])]
    await ds.execute_write('{"id": "d", "vector": ?, "metadata": {"text": "delta"}}',
                           [[0, 0, 1]])
    await ds.execute_write('{"delete": true, "ids": ["c"]}', [])
    await ds.delete_item("ns1", "b")
    out.append(await ds.fetch_data('{"vector": ?, "topK": 5}', [[0, 0, 1]]))
    await ds.close()
    return out


async def _milvus(pkg, fake):
    mod = pkg.module("milvus")
    resource = {"configuration": {"service": "milvus", "url": f"http://127.0.0.1:{fake.port}",
                                  "user": "root", "password": "pw", "database-name": "db1"}}
    mgr = mod.MilvusCollectionAssetManager()
    asset = pkg.AssetDefinition(
        id="asset-1", name="docs", asset_type="milvus-collection",
        creation_mode="create-if-not-exists",
        config={"collection-name": "docs", "datasource": resource, "database-name": "db1",
                "create-statements": ['{"collectionName": "docs", "dimension": 3}']})
    out = [await mgr.asset_exists(asset)]
    await mgr.deploy_asset(asset)
    out.append(await mgr.asset_exists(asset))
    ds = mod.MilvusDataSource(resource)
    await ds.upsert("docs", 1, [1, 0, 0], {"text": "alpha"})
    await ds.upsert("docs", "two", [0, 1, 0], {"text": "beta"})
    out.append(await ds.fetch_data(
        '{"collection-name": "docs", "vectors": ?, "top-k": 2, "output-fields": ["text"]}',
        [[1, 0, 0]]))
    await ds.execute_write('{"collection-name": "docs", "data": [{"id": 3, "vector": ?, '
                           '"text": "gamma"}]}', [[0, 0, 1]])
    await ds.delete_item("docs", 1)
    await ds.delete_item("docs", "two")
    out.append(await ds.fetch_data('{"collectionName": "docs", "vector": ?, "limit": 5}',
                                   [[0, 0, 1]]))
    await ds.close()
    return out


async def _solr(pkg, fake):
    mod = pkg.module("solr")
    resource = {"configuration": {"service": "solr", "host": "127.0.0.1", "port": fake.port,
                                  "collection-name": "documents", "user": "solr",
                                  "password": "SolrRocks"}}
    mgr = mod.SolrCollectionAssetManager()
    asset = pkg.AssetDefinition(
        id="asset-1", name="documents", asset_type="solr-collection",
        creation_mode="create-if-not-exists",
        config={"datasource": resource, "create-statements": [
            {"api": "/api/collections", "body": '"name": "documents", "numShards": 1'},
            {"api": "/schema", "body": {"add-field-type": {
                "name": "knn_vector", "class": "solr.DenseVectorField",
                "vectorDimension": 3}}}]})
    out = [await mgr.asset_exists(asset)]
    await mgr.deploy_asset(asset)
    out.append(await mgr.asset_exists(asset))
    ds = mod.SolrDataSource(resource)
    await ds.upsert("documents", "a", [1, 0, 0], {"text": "alpha"})
    await ds.upsert("documents", "b", [0, 1, 0], {"text": "beta", "flag": True})
    out.append(await ds.fetch_data('{"q": "{!knn f=embeddings topK=1}?", "fl": "id,text"}',
                                   [[1.0, 0.0, 0.0]]))
    await ds.execute_write('{"docs": [{"id": "c", "text": "gamma"}]}', [])
    await ds.execute_write('{"delete": {"id": "b"}}', [])
    await ds.delete_item("documents", "a")
    out.append(await ds.fetch_data('{"q": "*:*", "rows": 10, "debug": false}', []))
    await ds.close()
    return out


async def _astra(pkg, fake):
    mod = pkg.module("astra")
    resource = {"configuration": {"service": "astra-vector-db", "token": "AstraCS:test",
                                  "endpoint": f"http://127.0.0.1:{fake.port}"}}
    mgr = mod.AstraCollectionAssetManager()
    asset = pkg.AssetDefinition(
        id="asset-1", name="docs", asset_type="astra-collection",
        creation_mode="create-if-not-exists",
        config={"collection-name": "docs", "vector-dimension": 3, "datasource": resource})
    out = [await mgr.asset_exists(asset)]
    await mgr.deploy_asset(asset)
    out.append(await mgr.asset_exists(asset))
    ds = mod.AstraVectorDataSource(resource)
    await ds.upsert("docs", "a", [1, 0, 0], {"text": "alpha", "genre": "x"})
    await ds.upsert("docs", "b", [0, 1, 0], {"text": "beta", "genre": "y"})
    out.append(await ds.fetch_data('{"collection-name": "docs", "vector": ?, "max": 2, '
                                   '"include-similarity": true}', [[1, 0, 0]]))
    out.append(await ds.fetch_data('{"collection-name": "docs", "filter": {"genre": "y"}, '
                                   '"select": ["text"]}', []))
    await ds.execute_write('{"collection-name": "docs", "action": "insertOne", '
                           '"document": {"_id": "c", "text": "gamma", "$vector": ?}}',
                           [[0, 0, 1]])
    await ds.execute_write('{"collection-name": "docs", "action": "findOneAndUpdate", '
                           '"filter": {"_id": "b"}, "update": {"$set": {"text": "beta2"}}}', [])
    await ds.execute_write('{"collection-name": "docs", "action": "deleteOne", '
                           '"filter": {"_id": "a"}}', [])
    out.append(await ds.fetch_data('{"collection-name": "docs", "vector": ?, "max": 5}',
                                   [[0, 0, 1]]))
    await ds.delete_item("docs", "c")
    out.append(await ds.fetch_data('{"collection-name": "docs", "max": 5}', []))
    await ds.close()
    return out


HTTP_STORES = {
    "opensearch": (STORES.FakeOpenSearch, _opensearch),
    "pinecone": (STORES_EXT.FakePinecone, _pinecone),
    "milvus": (STORES_EXT.FakeMilvus, _milvus),
    "solr": (STORES_EXT.FakeSolr, _solr),
    "astra": (STORES_EXT.FakeAstra, _astra),
}


@pytest.mark.parametrize("store", sorted(HTTP_STORES))
def test_http_store_equals_the_jax_store_and_its_requests(store):
    fake_cls, body = HTTP_STORES[store]
    (jax_out, jax_requests), (port_out, port_requests) = on_both(_fake_run(fake_cls, body))
    assert port_out == jax_out
    assert port_requests == jax_requests
    assert len(port_requests) >= 6


def test_opensearch_sink_query_asset_app_through_both_runners():
    """``tests/test_vector_stores.py``'s OpenSearch app through each
    package's planner, deployer (the ``opensearch-index`` asset) and runner."""
    docs = [{"id": "a", "embedding": [1.0, 0.0, 0.0], "text": "apples"},
            {"id": "b", "embedding": [0.0, 1.0, 0.0], "text": "bread"},
            {"id": "c", "embedding": [0.9, 0.1, 0.0], "text": "apricots"}]

    async def body(pkg, fake):
        runner = pkg.Runner(pkg.parse(STORES._opensearch_app(fake.port), _instance()))
        async with runner:
            for d in docs:
                await runner.produce("docs-in", d)
            for _ in range(200):
                if len(fake.indices.get("docs", {}).get("docs", {})) == 3:
                    break
                await asyncio.sleep(0.05)
            await runner.produce("query-in", {"embedding": [1.0, 0.05, 0.0]})
            (msg,) = await runner.wait_for_messages("query-out", 1)
        return msg.value["results"], fake.indices

    (jax_out, jax_requests), (port_out, port_requests) = on_both(
        _fake_run(STORES.FakeOpenSearch, body))
    assert port_out == jax_out
    # the sink's writes may land in any order; each request once
    assert sorted(map(json.dumps, port_requests)) == sorted(map(json.dumps, jax_requests))
    assert [r["id"] for r in port_out[0]] == ["a", "c"]


# ---------------------------------------------------------------------------
# Cassandra over CQL v4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", range(18))
def test_cql_codec_equals_the_jax_codec(case):
    from langstream_tpu.agents import cassandra_cql as jax_cql
    from langstream_tpu_torch.agents import cassandra_cql as port_cql

    mark = next(m for m in CQL.test_type_roundtrip.pytestmark if m.name == "parametrize")
    opt, value = mark.args[1][case]
    wire = port_cql.serialize_value(opt, value)
    assert wire == jax_cql.serialize_value(opt, value)
    assert port_cql.deserialize_value(opt, wire) == jax_cql.deserialize_value(opt, wire) == value
    assert port_cql.infer_type_option(value) == jax_cql.infer_type_option(value)
    body = CQL._w_type_option(opt)
    assert (port_cql.read_type_option(port_cql._Reader(body))
            == jax_cql.read_type_option(jax_cql._Reader(body)))


@pytest.mark.parametrize("auth", [False, True], ids=["no-auth", "password"])
def test_cassandra_datasource_and_assets_equal_the_jax_ones(auth):
    async def scenario(pkg):
        cql = pkg.module("cassandra_cql")
        fake = CQL.FakeCassandra(CQL.SCHEMA, require_auth=auth)
        await fake.start()
        extra = {"username": "cassandra", "password": "secret"} if auth else {}
        resource = CQL._resource(fake.port, **extra)
        ds = pkg.module("vector").resolve_datasource(
            "cql", {"cql": {"type": "datasource", "name": "cql", **resource}})
        out = [type(ds).__name__]
        try:
            for kind in ("cassandra-keyspace", "cassandra-table"):
                mgr = pkg.registry.get(kind)
                asset = pkg.AssetDefinition(
                    id=kind, name="docs", asset_type=kind,
                    config={"datasource": resource, "table-name": "docs", "keyspace": "ks",
                            "create-statements": [f"CREATE {kind} IF NOT EXISTS"],
                            "delete-statements": [f"DROP {kind} IF EXISTS"]})
                await mgr.deploy_asset(asset)
                await mgr.delete_asset(asset)
            await ds.upsert("docs", "k1", [0.5, 1.0, -2.0],
                            {"count": 7, "big": 1 << 40, "score": 2.5})
            await ds.upsert("docs", "k2", None, {"count": 1})
            out.append(await ds.fetch_data(
                "SELECT id, count, big, score, vector FROM ks.docs WHERE id = ?", ["k1"]))
            await ds.delete_item("docs", "k1")
            out.append(await ds.fetch_data("SELECT id FROM ks.docs WHERE id = ?", ["k1"]))
            await ds.execute_write("INSERT INTO ks.docs (id, count) VALUES (?, ?)", ["k3", 3])
            out.append(await ds.fetch_data("SELECT id, count FROM ks.docs WHERE id = ?",
                                           ["k3"]))
        finally:
            await ds.close()
            await fake.stop()
        return out, fake.rows, fake.ddl, sorted(fake.prepared.values()), fake.auth_token

    jax_out, port_out = on_both(scenario)
    assert port_out == jax_out
    assert port_out[0][0] == "CassandraCqlDataSource" and port_out[1]["k3"]["count"] == 3


# ---------------------------------------------------------------------------
# https and wss through the port's client
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tls_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("http_tls")
    cert, key = d / "cert.pem", d / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key),
         "-out", str(cert), "-days", "2", "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True)
    server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server_ctx.load_cert_chain(str(cert), str(key))
    return server_ctx, str(cert)


def test_https_and_wss_verify_the_certificate(tls_pair, monkeypatch):
    """The port's client over TLS: a refusal against the default trust
    store (the self-signed certificate is in none), then, with
    ``SSL_CERT_FILE`` naming the certificate, a request and a WebSocket echo
    over wss."""
    from aiohttp import web

    from langstream_tpu_torch.gateway.wire import ConnectError, WebSocketClient, http_request

    server_ctx, cafile = tls_pair

    async def echo(request):
        if request.headers.get("Upgrade", "").lower() == "websocket":
            ws = web.WebSocketResponse()
            await ws.prepare(request)
            async for msg in ws:
                await ws.send_str("echo " + msg.data)
                break
            await ws.close()
            return ws
        return web.json_response({"path": request.path, "body": await request.json()})

    async def main():
        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", echo)
        fake = types.SimpleNamespace(handle=echo)
        await _start_tls(fake, server_ctx)
        try:
            monkeypatch.delenv("SSL_CERT_FILE", raising=False)
            with pytest.raises(ConnectError, match="CERTIFICATE_VERIFY_FAILED"):
                await http_request("GET", f"https://127.0.0.1:{fake.port}/x")
            monkeypatch.setenv("SSL_CERT_FILE", cafile)
            status, _, _, body = await http_request(
                "POST", f"https://127.0.0.1:{fake.port}/x", json_body={"a": 1})
            ws = await WebSocketClient.connect(f"wss://127.0.0.1:{fake.port}/ws")
            await ws.send_str("hi")
            echoed = (await ws.receive(10)).data
            await ws.close()
        finally:
            await fake.app_runner.cleanup()
        return status, json.loads(body), echoed

    status, body, echoed = asyncio.run(main())
    assert status == 200 and body == {"path": "/x", "body": {"a": 1}}
    assert echoed == "echo hi"


def test_opensearch_over_https_equals_the_jax_store(tls_pair, monkeypatch):
    """OpenSearch's default ``https: true`` against the fake over TLS: the
    port's store and the JAX store (aiohttp) verify the certificate through
    the default trust store, here ``SSL_CERT_FILE`` (aiohttp made its
    context when it was imported, so its copy is swapped for one made
    now), and agree."""
    import aiohttp.connector

    server_ctx, cafile = tls_pair
    monkeypatch.setenv("SSL_CERT_FILE", cafile)
    monkeypatch.setattr(aiohttp.connector, "_SSL_CONTEXT_VERIFIED", ssl.create_default_context())

    async def body(pkg, fake):
        return await _opensearch(pkg, fake, https=True)

    (jax_out, jax_requests), (port_out, port_requests) = on_both(
        _fake_run(STORES.FakeOpenSearch, body, ssl_context=server_ctx))
    assert port_out == jax_out
    assert port_requests == jax_requests and port_out[1] is True

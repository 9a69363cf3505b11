"""Vector-database agents + datasource SPI.

Parity: ``langstream-vector-agents`` — ``vector-db-sink``
(``agents/vector/VectorDBSinkAgent.java`` + per-store writers),
``query-vector-db`` (+ per-store ``DataSource`` impls), and the asset
managers that provision tables/collections.

First-party store: an **in-process vector store** (NumPy brute-force cosine
/ dot-product search, optional JSONL persistence under the agent's state
dir) — the role HerdDB-with-vectors plays in the reference's dev mode.
External stores speak their native HTTP surfaces directly (no SDKs), through
the port's standard-library client (:func:`store_request` over
:func:`langstream_tpu_torch.gateway.wire.http_request`, http and https):
JDBC/SQLite (:mod:`.jdbc`), OpenSearch/Elasticsearch (:mod:`.opensearch`),
Pinecone (:mod:`.pinecone`), Milvus/Zilliz (:mod:`.milvus`), Solr
(:mod:`.solr`), and Astra/DataStax Data API (:mod:`.astra`); self-hosted
Cassandra speaks CQL (:mod:`.cassandra_cql`). Each store's module is
imported only when a resource names its service.

The port's copy of ``langstream_tpu/agents/vector.py``; it imports only the
port.

Query format for the in-memory store: a JSON object (the reference sends
store-native queries through the same string field, e.g. SQL for JDBC):

    {"collection": "docs", "vector": ?, "top-k": 5, "filter": {"k": "v"}}

``?`` placeholders bind positionally from the agent's ``fields`` config.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Any

import numpy as np

from langstream_tpu_torch.agents.assets import AssetManager, AssetManagerRegistry
from langstream_tpu_torch.api.agent import AgentSink, SingleRecordProcessor
from langstream_tpu_torch.api.application import AssetDefinition
from langstream_tpu_torch.api.record import MutableRecord, Record
from langstream_tpu_torch.core.expressions import evaluate, evaluate_accessor


def basic_auth(user: str, password: str) -> str:
    """An ``Authorization`` header's Basic value (``aiohttp.BasicAuth``'s
    encoding: latin-1)."""
    import base64

    return "Basic " + base64.b64encode(f"{user}:{password}".encode("latin1")).decode("ascii")


async def store_request(
    method: str,
    url: str,
    *,
    json_body: Any = None,
    data: Any = None,
    headers: dict[str, str] | None = None,
    timeout: float = 300.0,
) -> tuple[int, str]:
    """One HTTP(S) request of a vector store: ``(status, text)``.

    The JAX stores' aiohttp calls, on the port's client: ``json_body`` is
    sent as JSON, ``data`` as a form (a dict) or as it is (a string), and
    neither sends an empty body (what aiohttp sends for ``json=None``); an
    https URL verifies against the default trust store."""
    from urllib.parse import urlencode

    from langstream_tpu_torch.gateway.wire import http_request

    hdrs = dict(headers or {})
    body: bytes | None = b""
    if json_body is not None:
        body = json.dumps(json_body).encode()
        hdrs.setdefault("Content-Type", "application/json")
    elif isinstance(data, dict):
        body = urlencode(data).encode()
        hdrs.setdefault("Content-Type", "application/x-www-form-urlencoded")
    elif data is not None:
        body = str(data).encode()
    status, _, _, raw = await http_request(
        method, url, body=body, headers=hdrs, timeout=timeout, decompress=True)
    return status, raw.decode("utf-8", "replace")


def bind_json_query(query: str, params: list[Any]) -> dict[str, Any]:
    """Bind positional ``?`` placeholders into a JSON query (values, incl.
    arrays) — the store-agnostic half of the reference's
    ``InterpolationUtils.buildObjectFromJson``."""
    parts = query.split("?")
    if len(parts) - 1 != len(params) and len(parts) > 1:
        raise ValueError(
            f"query has {len(parts) - 1} placeholders, {len(params)} params given"
        )
    out = parts[0]
    for part, param in zip(parts[1:], params):
        out += json.dumps(param) + part
    return json.loads(out)


class DataSource:
    """Query SPI (parity: ``ai/agents/datasource/DataSourceProvider``).

    ``fetch_data``/``execute_write`` carry store-native query strings with
    positional ``?`` binding (SQL for JDBC, JSON DSL for the in-memory and
    OpenSearch stores). ``upsert``/``delete_item`` are the structured lane
    the ``vector-db-sink`` agent drives, so each store maps the common
    (collection, id, vector, payload) shape to its own write."""

    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        raise NotImplementedError

    async def execute_write(self, query: str, params: list[Any]) -> None:
        raise NotImplementedError

    async def upsert(
        self,
        collection: str,
        item_id: Any,
        vector: list[float] | None,
        payload: dict[str, Any],
    ) -> None:
        raise NotImplementedError

    async def delete_item(self, collection: str, item_id: Any) -> None:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class _Collection:
    """Rows are kept strictly aligned: ``ids[i]`` ↔ ``vectors[i]`` ↔
    ``payloads[i]`` — rows without a vector store ``None`` so mixed
    vectored/vectorless upserts can't misattribute search results."""

    def __init__(self) -> None:
        self.ids: list[Any] = []
        self.vectors: list[np.ndarray | None] = []  # each (d,) float32, unit norm
        self.payloads: list[dict[str, Any]] = []
        self.lock = threading.Lock()

    def upsert(self, item_id: Any, vector: list[float] | None, payload: dict[str, Any]) -> None:
        with self.lock:
            vec = None
            if vector is not None:
                vec = np.asarray(vector, dtype=np.float32)
                norm = float(np.linalg.norm(vec)) or 1.0
                vec = vec / norm
            if item_id in self.ids:
                idx = self.ids.index(item_id)
                self.payloads[idx] = payload
                self.vectors[idx] = vec
                return
            self.ids.append(item_id)
            self.payloads.append(payload)
            self.vectors.append(vec)

    def delete(self, item_id: Any) -> None:
        with self.lock:
            if item_id in self.ids:
                idx = self.ids.index(item_id)
                self.ids.pop(idx)
                self.payloads.pop(idx)
                self.vectors.pop(idx)

    def search(
        self,
        vector: list[float] | None,
        top_k: int,
        flt: dict[str, Any] | None,
    ) -> list[dict[str, Any]]:
        with self.lock:
            candidates = list(range(len(self.ids)))
            if flt:
                candidates = [
                    i
                    for i in candidates
                    if all(self.payloads[i].get(k) == v for k, v in flt.items())
                ]
            if vector is not None and candidates:
                scored = [i for i in candidates if self.vectors[i] is not None]
                if scored:
                    q = np.asarray(vector, dtype=np.float32)
                    q = q / (float(np.linalg.norm(q)) or 1.0)
                    matrix = np.stack([self.vectors[i] for i in scored])
                    sims = matrix @ q
                    order = np.argsort(-sims)[:top_k]
                    return [
                        {
                            **self.payloads[scored[i]],
                            "id": self.ids[scored[i]],
                            "similarity": float(sims[i]),
                        }
                        for i in order
                    ]
            return [
                {**self.payloads[i], "id": self.ids[i]} for i in candidates[:top_k]
            ]


class InMemoryVectorStore(DataSource):
    """Named, process-shared store instances."""

    _stores: dict[str, "InMemoryVectorStore"] = {}
    _stores_lock = threading.Lock()

    def __init__(self, persist_dir: Path | None = None):
        self.collections: dict[str, _Collection] = {}
        self.persist_dir = persist_dir
        if persist_dir is not None:
            self._load()

    @classmethod
    def get(cls, name: str, persist_dir: Path | None = None) -> "InMemoryVectorStore":
        with cls._stores_lock:
            if name not in cls._stores:
                cls._stores[name] = cls(persist_dir)
            return cls._stores[name]

    @classmethod
    def reset(cls) -> None:
        with cls._stores_lock:
            cls._stores.clear()

    def collection(self, name: str) -> _Collection:
        if name not in self.collections:
            self.collections[name] = _Collection()
        return self.collections[name]

    # -- DataSource ------------------------------------------------------

    _bind = staticmethod(bind_json_query)

    @staticmethod
    def _coll_name(q: dict[str, Any]) -> str:
        # "collection-name" accepted as an alias: the reference's sample
        # queries use it (e.g. its Astra JSON-API shape), and example apps
        # written against those YAMLs should hit the named collection, not
        # silently search an empty "default".
        return q.get("collection") or q.get("collection-name") or "default"

    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        q = self._bind(query, params)
        coll = self.collection(self._coll_name(q))
        return coll.search(
            q.get("vector"), int(q.get("top-k", q.get("topK", 10))), q.get("filter")
        )

    async def execute_write(self, query: str, params: list[Any]) -> None:
        q = self._bind(query, params)
        coll = self.collection(self._coll_name(q))
        if q.get("delete"):
            coll.delete(q.get("id"))
            return
        coll.upsert(q.get("id"), q.get("vector"), q.get("payload", {}))
        self._persist()

    async def upsert(self, collection, item_id, vector, payload) -> None:
        self.collection(collection).upsert(item_id, vector, payload)
        self._persist()

    async def delete_item(self, collection, item_id) -> None:
        self.collection(collection).delete(item_id)
        self._persist()

    # -- persistence -----------------------------------------------------

    def _persist(self) -> None:
        if self.persist_dir is None:
            return
        self.persist_dir.mkdir(parents=True, exist_ok=True)
        for name, coll in self.collections.items():
            with (self.persist_dir / f"{name}.jsonl").open("w") as f:
                with coll.lock:
                    for i, item_id in enumerate(coll.ids):
                        vec = (
                            coll.vectors[i].tolist()
                            if coll.vectors[i] is not None
                            else None
                        )
                        f.write(
                            json.dumps(
                                {"id": item_id, "vector": vec, "payload": coll.payloads[i]}
                            )
                            + "\n"
                        )

    def _load(self) -> None:
        if self.persist_dir is None or not self.persist_dir.exists():
            return
        for path in self.persist_dir.glob("*.jsonl"):
            coll = self.collection(path.stem)
            for line in path.read_text().splitlines():
                item = json.loads(line)
                coll.upsert(item["id"], item.get("vector"), item.get("payload", {}))


def resolve_datasource(
    name: str | None, resources: dict[str, dict[str, Any]]
) -> DataSource:
    """Find the named datasource resource and build its DataSource.

    Resource shape (parity: ``configuration.yaml`` datasource resources):
    ``{type: "datasource"|"vector-database", name, configuration: {service: ...}}``.
    """
    resource = None
    for rid, r in resources.items():
        if r.get("type") in ("datasource", "vector-database") and (
            name is None or r.get("name") == name or rid == name
        ):
            resource = r
            break
    if resource is None:
        # default: an anonymous in-memory store
        return InMemoryVectorStore.get(name or "default")
    cfg = resource.get("configuration", resource)
    service = cfg.get("service", resource.get("service", "in-memory"))
    if service in ("in-memory", "memory", "herddb"):
        # herddb is the reference's embedded dev-mode store; the in-memory
        # store plays that role here (auto-creating collections)
        return InMemoryVectorStore.get(resource.get("name") or name or "default")
    if service in ("jdbc", "sqlite", "postgres", "pgvector"):
        try:
            from langstream_tpu_torch.agents.jdbc import JdbcDataSource

            return JdbcDataSource.get(resource)
        except ImportError as e:  # postgres without psycopg
            raise RuntimeError(
                f"datasource service {service!r}: {e}"
            )
    if service in ("opensearch", "elasticsearch"):
        from langstream_tpu_torch.agents.opensearch import OpenSearchDataSource

        return OpenSearchDataSource(resource)
    if service == "pinecone":
        from langstream_tpu_torch.agents.pinecone import PineconeDataSource

        return PineconeDataSource(resource)
    if service == "milvus":
        from langstream_tpu_torch.agents.milvus import MilvusDataSource

        return MilvusDataSource(resource)
    if service == "solr":
        from langstream_tpu_torch.agents.solr import SolrDataSource

        return SolrDataSource(resource)
    if service in ("astra-vector-db", "astra"):
        from langstream_tpu_torch.agents.astra import AstraVectorDataSource

        return AstraVectorDataSource(resource)
    if service == "cassandra":
        # self-hosted clusters speak CQL, not the Astra JSON Data API
        from langstream_tpu_torch.agents.cassandra_cql import CassandraCqlDataSource

        return CassandraCqlDataSource(resource)
    raise RuntimeError(f"unsupported datasource service {service!r}")


class VectorDBSinkAgent(AgentSink):
    """``vector-db-sink``: upsert records into the configured store.

    Field mapping via expressions (parity: per-store writer configs):
    ``datasource``, ``collection-name``, ``fields: [{name, expression}]``
    with conventional names ``id``, ``vector``/``embeddings``, others →
    payload.
    """

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        self.datasource = resolve_datasource(
            configuration.get("datasource"),
            configuration.get("__resources__", {}),
        )
        self.collection = configuration.get(
            "collection-name", configuration.get("table-name", "default")
        )

    async def write(self, record: Record) -> None:
        mutable = MutableRecord.from_record(record)
        item_id: Any = None
        vector: list[float] | None = None
        payload: dict[str, Any] = {}
        for f in self.configuration.get("fields", []):
            fname = f["name"]
            value = evaluate(str(f["expression"]), mutable)
            if fname == "id":
                item_id = value
            elif fname in ("vector", "embeddings"):
                vector = list(map(float, value)) if value is not None else None
            else:
                payload[fname] = value
        if item_id is None:
            item_id = f"{record.origin}-{record.timestamp}-{hash(str(record.value)) & 0xFFFFFFFF}"
        await self.datasource.upsert(self.collection, item_id, vector, payload)


class QueryVectorDBAgent(SingleRecordProcessor):
    """``query-vector-db``: similarity query → ``output-field``."""

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        self.datasource = resolve_datasource(
            configuration.get("datasource"),
            configuration.get("__resources__", {}),
        )

    async def process_record(self, record: Record) -> list[Record]:
        cfg = self.configuration
        mutable = MutableRecord.from_record(record)
        params = [evaluate_accessor(f, mutable) for f in cfg.get("fields", [])]
        results = await self.datasource.fetch_data(cfg.get("query", "{}"), params)
        mutable.set_field(cfg.get("output-field", "value.query_results"), results)
        return [mutable.to_record()]


class _InMemoryCollectionAssetManager(AssetManager):
    """Asset type ``in-memory-collection`` — and the fallback target for
    table-like assets when their real store isn't configured locally."""

    async def asset_exists(self, asset: AssetDefinition) -> bool:
        cfg = asset.config
        store = InMemoryVectorStore.get(cfg.get("datasource", "default"))
        return cfg.get("collection-name", asset.name) in store.collections

    async def deploy_asset(self, asset: AssetDefinition) -> None:
        cfg = asset.config
        store = InMemoryVectorStore.get(cfg.get("datasource", "default"))
        store.collection(cfg.get("collection-name", asset.name))


AssetManagerRegistry.register("in-memory-collection", _InMemoryCollectionAssetManager())

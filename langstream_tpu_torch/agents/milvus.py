"""Milvus/Zilliz vector store over the RESTful v2 data plane.

Parity: ``langstream-vector-agents/.../milvus/MilvusDataSource.java`` +
``MilvusWriter.java`` + ``MilvusAssetsManagerProvider.java``. Config keys
match the reference (``MilvusDataSource.MilvusConfig``): ``user``,
``password``, ``host``, ``port``, ``url``, ``token``; writer keys
``collection-name`` / ``database-name``; asset type ``milvus-collection``
with ``create-statements``.

The reference uses the Milvus gRPC SDK; this speaks the Milvus v2 REST API
(``/v2/vectordb/...``) — one surface for Milvus standalone and Zilliz Cloud —
through the port's standard-library client
(:func:`~langstream_tpu_torch.agents.vector.store_request`, http and https).

Query lane (the reference interpolates into ``SearchSimpleParam`` with
kebab-case names; both spellings accepted here):

    {"collection-name": "docs", "vectors": ?, "top-k": 5,
     "filter": "id > 0", "output-fields": ["text"]}

The port's copy of ``langstream_tpu/agents/milvus.py``: the same requests,
paths and bodies.
"""

from __future__ import annotations

import json
from typing import Any

from langstream_tpu_torch.agents.assets import AssetManager, AssetManagerRegistry
from langstream_tpu_torch.agents.vector import DataSource, bind_json_query, store_request
from langstream_tpu_torch.api.application import AssetDefinition


def _pick(q: dict[str, Any], *names: str, default: Any = None) -> Any:
    for name in names:
        if q.get(name) is not None:
            return q[name]
    return default


class MilvusDataSource(DataSource):
    def __init__(self, resource: dict[str, Any]):
        cfg = resource.get("configuration", resource)
        url = cfg.get("url")
        if not url:
            host = cfg.get("host", "localhost")
            port = int(cfg.get("port", 19530))
            url = f"http://{host}:{port}"
        self.base = url.rstrip("/")
        token = cfg.get("token")
        if not token and cfg.get("user"):
            token = f"{cfg.get('user')}:{cfg.get('password', '')}"
        self.token = token
        self.database = cfg.get("database-name") or None
        self.headers: dict[str, str] = {}
        if self.token:
            self.headers["Authorization"] = f"Bearer {self.token}"

    async def _post(self, path: str, body: dict[str, Any]) -> Any:
        if self.database and "dbName" not in body:
            body["dbName"] = self.database
        status, text = await store_request(
            "POST", f"{self.base}{path}", json_body=body, headers=self.headers
        )
        if status != 200:
            raise RuntimeError(
                f"milvus POST {path}: {status} {text[:300]}"
            )
        data = json.loads(text) if text else {}
        # v2 REST wraps everything in {"code": 0, "data": ...}; non-zero
        # code is a server-side error even on HTTP 200
        if isinstance(data, dict) and data.get("code", 0) not in (0, 200):
            raise RuntimeError(f"milvus {path}: {data}")
        return data.get("data") if isinstance(data, dict) else data

    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        q = bind_json_query(query, params)
        vectors = _pick(q, "vectors", "vector")
        if vectors and not isinstance(vectors[0], (list, tuple)):
            vectors = [vectors]
        body: dict[str, Any] = {
            "collectionName": _pick(q, "collection-name", "collectionName"),
            "data": vectors,
            "limit": int(_pick(q, "top-k", "topK", "limit", default=10)),
        }
        flt = _pick(q, "filter", "expr")
        if flt:
            body["filter"] = flt
        fields = _pick(q, "output-fields", "outputFields")
        if fields:
            body["outputFields"] = fields
        db = _pick(q, "database-name", "databaseName")
        if db:
            body["dbName"] = db
        rows = await self._post("/v2/vectordb/entities/search", body) or []
        out = []
        for row in rows:
            row = dict(row)
            if "distance" in row:
                row["similarity"] = float(row.pop("distance"))
            out.append(row)
        return out

    async def execute_write(self, query: str, params: list[Any]) -> None:
        q = bind_json_query(query, params)
        collection = _pick(q, "collection-name", "collectionName")
        if q.get("delete"):
            await self._post(
                "/v2/vectordb/entities/delete",
                {"collectionName": collection, "filter": q.get("filter", "")},
            )
            return
        data = q.get("data") or [q.get("row") or {}]
        await self._post(
            "/v2/vectordb/entities/upsert",
            {"collectionName": collection, "data": data},
        )

    async def upsert(self, collection, item_id, vector, payload) -> None:
        row: dict[str, Any] = {"id": item_id, **(payload or {})}
        if vector is not None:
            row["vector"] = vector
        await self._post(
            "/v2/vectordb/entities/upsert",
            {"collectionName": collection, "data": [row]},
        )

    async def delete_item(self, collection, item_id) -> None:
        ident = json.dumps(item_id) if isinstance(item_id, str) else item_id
        await self._post(
            "/v2/vectordb/entities/delete",
            {"collectionName": collection, "filter": f"id in [{ident}]"},
        )

    async def has_collection(self, collection: str) -> bool:
        data = await self._post(
            "/v2/vectordb/collections/has", {"collectionName": collection}
        )
        return bool((data or {}).get("has"))

    async def create_collection(self, body: dict[str, Any]) -> None:
        await self._post("/v2/vectordb/collections/create", body)


class MilvusCollectionAssetManager(AssetManager):
    """Asset type ``milvus-collection`` (parity:
    ``MilvusAssetsManagerProvider.java:45``): ``create-statements`` is a
    list of create-collection bodies (JSON strings or objects)."""

    def _datasource(self, asset: AssetDefinition) -> MilvusDataSource:
        return MilvusDataSource(asset.config.get("datasource", {}))

    def _collection(self, asset: AssetDefinition) -> str:
        return asset.config.get("collection-name", asset.name)

    async def asset_exists(self, asset: AssetDefinition) -> bool:
        ds = self._datasource(asset)
        try:
            return await ds.has_collection(self._collection(asset))
        finally:
            await ds.close()

    async def deploy_asset(self, asset: AssetDefinition) -> None:
        ds = self._datasource(asset)
        try:
            statements = asset.config.get("create-statements", [])
            for statement in statements:
                body = (
                    json.loads(statement)
                    if isinstance(statement, str)
                    else dict(statement)
                )
                body.setdefault("collectionName", self._collection(asset))
                if asset.config.get("database-name"):
                    body.setdefault("dbName", asset.config["database-name"])
                await ds.create_collection(body)
            if not statements:
                await ds.create_collection(
                    {"collectionName": self._collection(asset)}
                )
        finally:
            await ds.close()


AssetManagerRegistry.register("milvus-collection", MilvusCollectionAssetManager())

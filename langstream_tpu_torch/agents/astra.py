"""Astra / DataStax vector store over the JSON Data API.

Parity: ``langstream-vector-agents/.../astra/AstraVectorDBDataSource.java``
+ ``AstraVectorDBWriter.java`` + ``AstraVectorDBAssetsManagerProvider.java``
(asset type ``astra-collection``). Config keys match the reference:
``token``, ``endpoint`` (plus optional ``keyspace``, default
``default_keyspace``). The reference drives the ``astra-db-client`` SDK;
this speaks the same JSON Data API (``/api/json/v1``) directly — which also
works against the self-hostable Data API (Stargate).

Query lane (same keys the reference pops from the interpolated map,
``AstraVectorDBDataSource.java:87-132``):

    {"collection-name": "docs", "vector": ?, "max": 5,
     "filter": {"genre": "doc"}, "include-similarity": true, "select": [..]}

Write lane: ``{"collection-name", "action": insertOne|findOneAndUpdate|
deleteOne|deleteMany, ...}``.

The port's copy of ``langstream_tpu/agents/astra.py``: the same requests,
paths and bodies, through the port's standard-library client
(:func:`~langstream_tpu_torch.agents.vector.store_request`, http and
https).
"""

from __future__ import annotations

import json
from typing import Any

from langstream_tpu_torch.agents.assets import AssetManager, AssetManagerRegistry
from langstream_tpu_torch.agents.vector import DataSource, bind_json_query, store_request
from langstream_tpu_torch.api.application import AssetDefinition


class AstraVectorDataSource(DataSource):
    def __init__(self, resource: dict[str, Any]):
        cfg = resource.get("configuration", resource)
        self.token = cfg.get("token", "")
        self.endpoint = cfg.get("endpoint", "").rstrip("/")
        self.keyspace = cfg.get("keyspace", "default_keyspace")

    async def _command(
        self, body: dict[str, Any], collection: str | None = None
    ) -> dict[str, Any]:
        path = f"/api/json/v1/{self.keyspace}"
        if collection:
            path += f"/{collection}"
        status, text = await store_request(
            "POST", f"{self.endpoint}{path}", json_body=body,
            headers={"Token": self.token, "Content-Type": "application/json"},
        )
        if status != 200:
            raise RuntimeError(
                f"astra POST {path}: {status} {text[:300]}"
            )
        data = json.loads(text) if text else {}
        if data.get("errors"):
            raise RuntimeError(f"astra {next(iter(body))}: {data['errors']}")
        return data

    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        q = bind_json_query(query, params)
        collection = q.pop("collection-name", None)
        if not collection:
            raise ValueError("collection-name is not defined")
        vector = q.pop("vector", None)
        find: dict[str, Any] = {}
        options: dict[str, Any] = {}
        if q.get("filter"):
            find["filter"] = q["filter"]
        if q.get("select"):
            find["projection"] = {f: 1 for f in q["select"]}
        if vector is not None:
            find["sort"] = {"$vector": vector}
            options["includeSimilarity"] = bool(
                q.get("include-similarity", True)
            )
        if q.get("max") is not None:
            options["limit"] = int(q["max"])
        if options:
            find["options"] = options
        data = await self._command({"find": find}, collection)
        rows = []
        for doc in data.get("data", {}).get("documents", []):
            row = dict(doc)
            if "_id" in row:
                row.setdefault("id", row.pop("_id"))
            if "$similarity" in row:
                row["similarity"] = float(row.pop("$similarity"))
            if "$vector" in row:
                row["vector"] = row.pop("$vector")
            rows.append(row)
        return rows

    async def execute_write(self, query: str, params: list[Any]) -> None:
        q = bind_json_query(query, params)
        collection = q.pop("collection-name", None)
        if not collection:
            raise ValueError("collection-name is not defined")
        action = q.pop("action", "findOneAndUpdate")
        if action == "insertOne":
            document = q.get("document") or q
            await self._command({"insertOne": {"document": document}}, collection)
        elif action == "findOneAndUpdate":
            body = {
                "findOneAndUpdate": {
                    "filter": q.get("filter", {}),
                    "update": q.get("update", {}),
                    "options": {"upsert": bool(q.get("upsert", True))},
                }
            }
            await self._command(body, collection)
        elif action == "deleteOne":
            await self._command(
                {"deleteOne": {"filter": q.get("filter", {})}}, collection
            )
        elif action == "deleteMany":
            await self._command(
                {"deleteMany": {"filter": q.get("filter", {})}}, collection
            )
        else:
            raise ValueError(f"unsupported astra action {action!r}")

    async def upsert(self, collection, item_id, vector, payload) -> None:
        update: dict[str, Any] = {"$set": dict(payload or {})}
        if vector is not None:
            update["$set"]["$vector"] = vector
        await self._command(
            {
                "findOneAndUpdate": {
                    "filter": {"_id": str(item_id)},
                    "update": update,
                    "options": {"upsert": True},
                }
            },
            collection,
        )

    async def delete_item(self, collection, item_id) -> None:
        await self._command(
            {"deleteOne": {"filter": {"_id": str(item_id)}}}, collection
        )

    async def create_collection(self, name: str, dimension: int) -> None:
        await self._command(
            {
                "createCollection": {
                    "name": name,
                    "options": {"vector": {"dimension": dimension}},
                }
            }
        )

    async def find_collections(self) -> list[str]:
        data = await self._command({"findCollections": {}})
        return data.get("status", {}).get("collections", [])


class AstraCollectionAssetManager(AssetManager):
    """Asset type ``astra-collection`` (parity:
    ``AstraVectorDBAssetsManagerProvider.java:30``): config
    ``collection-name`` + ``vector-dimension`` (default 1536, as the
    reference defaults)."""

    def _datasource(self, asset: AssetDefinition) -> AstraVectorDataSource:
        return AstraVectorDataSource(asset.config.get("datasource", {}))

    def _collection(self, asset: AssetDefinition) -> str:
        return asset.config.get("collection-name", asset.name)

    async def asset_exists(self, asset: AssetDefinition) -> bool:
        ds = self._datasource(asset)
        try:
            return self._collection(asset) in await ds.find_collections()
        finally:
            await ds.close()

    async def deploy_asset(self, asset: AssetDefinition) -> None:
        ds = self._datasource(asset)
        try:
            await ds.create_collection(
                self._collection(asset),
                int(asset.config.get("vector-dimension", 1536)),
            )
        finally:
            await ds.close()


AssetManagerRegistry.register("astra-collection", AstraCollectionAssetManager())

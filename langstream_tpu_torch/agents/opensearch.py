"""OpenSearch-compatible HTTP vector store.

Parity: ``langstream-vector-agents/.../opensearch/`` (writer, datasource,
index asset manager). Speaks the OpenSearch REST surface over the port's
standard-library client (:func:`~langstream_tpu_torch.agents.vector.store_request`,
http and https) — no client library required, so it works against real
OpenSearch/Elasticsearch deployments and against the in-tree fake used by
tests.

Resource shape (same keys the reference documents):

    resources:
      - type: "vector-database"
        name: "os"
        configuration:
          service: "opensearch"
          host: "localhost"
          port: 9200
          https: false
          index-name: "docs"
          username: "..."        # optional basic auth
          password: "..."

Query lane: ``query-vector-db`` carries an OpenSearch search body (JSON,
with positional ``?`` binding), e.g. a knn query:

    {"index": "docs", "query": {"knn": {"embeddings": {"vector": ?, "k": 5}}}}

Write lane: ``vector-db-sink`` maps (collection, id, vector, payload) to
``PUT /{index}/_doc/{id}`` with the vector in the ``embeddings`` field.

The port's copy of ``langstream_tpu/agents/opensearch.py``: the same
requests, paths and bodies, with basic auth as a plain ``Authorization``
header.
"""

from __future__ import annotations

import json
from typing import Any

from langstream_tpu_torch.agents.assets import AssetManager, AssetManagerRegistry
from langstream_tpu_torch.agents.vector import DataSource, basic_auth, store_request
from langstream_tpu_torch.api.application import AssetDefinition


class OpenSearchDataSource(DataSource):
    def __init__(self, resource: dict[str, Any]):
        cfg = resource.get("configuration", resource)
        scheme = "https" if cfg.get("https", True) else "http"
        host = cfg.get("host", "localhost")
        port = int(cfg.get("port", 9200))
        self.base = f"{scheme}://{host}:{port}"
        self.index = cfg.get("index-name", cfg.get("index", "default"))
        self.headers: dict[str, str] = {}
        if cfg.get("username"):
            self.headers["Authorization"] = basic_auth(
                cfg.get("username"), cfg.get("password", "")
            )

    async def _request(
        self, method: str, path: str, body: dict | None = None,
        ok_statuses: tuple[int, ...] = (200, 201),
    ) -> dict[str, Any]:
        status, text = await store_request(
            method, f"{self.base}{path}", json_body=body, headers=self.headers
        )
        if status not in ok_statuses:
            raise RuntimeError(
                f"opensearch {method} {path}: {status} {text[:300]}"
            )
        try:
            return json.loads(text) if text else {}
        except ValueError:
            return {}

    # -- DataSource ------------------------------------------------------

    @staticmethod
    def _bind(query: str, params: list[Any]) -> dict[str, Any]:
        parts = query.split("?")
        if len(parts) - 1 != len(params) and len(parts) > 1:
            raise ValueError(
                f"query has {len(parts) - 1} placeholders, {len(params)} params"
            )
        out = parts[0]
        for part, param in zip(parts[1:], params):
            out += json.dumps(param) + part
        return json.loads(out)

    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        body = self._bind(query, params)
        index = body.pop("index", self.index)
        data = await self._request("POST", f"/{index}/_search", body)
        hits = (data.get("hits") or {}).get("hits") or []
        return [
            {
                **(h.get("_source") or {}),
                "id": h.get("_id"),
                "similarity": h.get("_score"),
            }
            for h in hits
        ]

    async def execute_write(self, query: str, params: list[Any]) -> None:
        body = self._bind(query, params)
        index = body.pop("index", self.index)
        if body.pop("delete", False):
            await self._request(
                "DELETE", f"/{index}/_doc/{body['id']}", ok_statuses=(200, 404)
            )
            return
        doc_id = body.pop("id")
        await self._request("PUT", f"/{index}/_doc/{doc_id}", body)

    async def upsert(self, collection, item_id, vector, payload) -> None:
        doc = dict(payload)
        if vector is not None:
            doc["embeddings"] = vector
        await self._request(
            "PUT", f"/{collection or self.index}/_doc/{item_id}", doc
        )

    async def delete_item(self, collection, item_id) -> None:
        await self._request(
            "DELETE",
            f"/{collection or self.index}/_doc/{item_id}",
            ok_statuses=(200, 404),
        )

    async def index_exists(self, index: str) -> bool:
        status, _ = await store_request(
            "HEAD", f"{self.base}/{index}", headers=self.headers
        )
        return status == 200

    async def create_index(self, index: str, body: dict | None) -> None:
        await self._request("PUT", f"/{index}", body or {})

    async def delete_index(self, index: str) -> None:
        await self._request("DELETE", f"/{index}", ok_statuses=(200, 404))


class OpenSearchIndexAssetManager(AssetManager):
    """Asset type ``opensearch-index``: create the index with the configured
    settings/mappings when absent."""

    async def asset_exists(self, asset: AssetDefinition) -> bool:
        ds = _asset_datasource(asset)
        try:
            return await ds.index_exists(
                asset.config.get("index-name", asset.name)
            )
        finally:
            await ds.close()

    async def deploy_asset(self, asset: AssetDefinition) -> None:
        ds = _asset_datasource(asset)
        try:
            body = {}
            if asset.config.get("settings"):
                body["settings"] = asset.config["settings"]
            if asset.config.get("mappings"):
                body["mappings"] = asset.config["mappings"]
            await ds.create_index(
                asset.config.get("index-name", asset.name), body
            )
        finally:
            await ds.close()

    async def delete_asset(self, asset: AssetDefinition) -> None:
        ds = _asset_datasource(asset)
        try:
            await ds.delete_index(asset.config.get("index-name", asset.name))
        finally:
            await ds.close()


def _asset_datasource(asset: AssetDefinition) -> OpenSearchDataSource:
    ds = asset.config.get("datasource")
    return OpenSearchDataSource(ds if isinstance(ds, dict) else asset.config)


AssetManagerRegistry.register("opensearch-index", OpenSearchIndexAssetManager())

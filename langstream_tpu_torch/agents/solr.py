"""Apache Solr vector store over its JSON/HTTP API.

Parity: ``langstream-vector-agents/.../solr/SolrDataSource.java`` +
``SolrWriter.java`` + ``SolrAssetsManagerProvider.java``. Config keys match
the reference (``SolrDataSource.SolrConfig``): ``user``, ``password``,
``host``, ``port``, ``protocol``, ``collection-name``; writer key
``commit-within`` (ms); asset type ``solr-collection`` with
``create-statements`` of ``{api: "/api/collections"|"/schema", method,
body}`` exactly as the reference executes them.

Query lane: the query JSON is a flat map of Solr query params POSTed to
``/select`` (the reference posts for the same reason — embedding vectors
blow past GET header limits), e.g.

    {"q": "{!knn f=embeddings topK=10}?", "fl": "id,text,score"}

The port's copy of ``langstream_tpu/agents/solr.py``: the same requests,
paths and bodies, through the port's standard-library client
(:func:`~langstream_tpu_torch.agents.vector.store_request`, http and
https), with basic auth as a plain ``Authorization`` header.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any

from langstream_tpu_torch.agents.assets import AssetManager, AssetManagerRegistry
from langstream_tpu_torch.agents.vector import (
    DataSource,
    basic_auth,
    bind_json_query,
    store_request,
)
from langstream_tpu_torch.api.application import AssetDefinition


class SolrDataSource(DataSource):
    def __init__(self, resource: dict[str, Any]):
        cfg = resource.get("configuration", resource)
        protocol = cfg.get("protocol", "http")
        host = cfg.get("host", "localhost")
        port = int(cfg.get("port", 8983))
        self.base_url = f"{protocol}://{host}:{port}"
        self.collection = cfg.get("collection-name", "documents")
        self.commit_within = int(cfg.get("commit-within", 1000))
        self.user = cfg.get("user")
        self.password = cfg.get("password", "")
        self.headers: dict[str, str] = {}
        if self.user:
            self.headers["Authorization"] = basic_auth(self.user, self.password)

    @property
    def collection_url(self) -> str:
        return f"{self.base_url}/solr/{self.collection}"

    async def _post(
        self, url: str, *, data: Any = None, json_body: Any = None
    ) -> dict[str, Any]:
        status, text = await store_request(
            "POST", url, data=data, json_body=json_body, headers=self.headers
        )
        if status != 200:
            raise RuntimeError(f"solr POST {url}: {status} {text[:300]}")
        try:
            return json.loads(text) if text else {}
        except ValueError:
            return {"raw": text}

    @staticmethod
    def _param_str(value: Any) -> str:
        """Solr param stringification: lists render as ``[1.0, 2.0]`` — the
        shape the ``{!knn}`` parser expects (the reference gets this from
        Java's ``List.toString``)."""
        if isinstance(value, (list, tuple)):
            return "[" + ", ".join(str(v) for v in value) + "]"
        if isinstance(value, bool):
            return "true" if value else "false"
        return str(value)

    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        q = bind_json_query(query, params)
        form = {k: self._param_str(v) for k, v in q.items()}
        form.setdefault("wt", "json")
        data = await self._post(f"{self.collection_url}/select", data=form)
        return [dict(doc) for doc in data.get("response", {}).get("docs", [])]

    async def execute_write(self, query: str, params: list[Any]) -> None:
        q = bind_json_query(query, params)
        if q.get("delete"):
            await self._post(
                f"{self.collection_url}/update?commitWithin={self.commit_within}",
                json_body={"delete": q["delete"]},
            )
            return
        docs = q.get("docs") or [q.get("doc") or {}]
        await self._post(
            f"{self.collection_url}/update?commitWithin={self.commit_within}",
            json_body=docs,
        )

    async def upsert(self, collection, item_id, vector, payload) -> None:
        doc: dict[str, Any] = {"id": str(item_id), **(payload or {})}
        if vector is not None:
            doc.setdefault("embeddings", vector)
        await self._post(
            f"{self.collection_url}/update?commitWithin={self.commit_within}",
            json_body=[doc],
        )

    async def delete_item(self, collection, item_id) -> None:
        await self._post(
            f"{self.collection_url}/update?commitWithin={self.commit_within}",
            json_body={"delete": {"id": str(item_id)}},
        )


class SolrCollectionAssetManager(AssetManager):
    """Asset type ``solr-collection`` (parity:
    ``SolrAssetsManagerProvider.java:36``): existence = the collection URL
    answers; deploy executes ``create-statements`` against the collections
    or schema API."""

    def _datasource(self, asset: AssetDefinition) -> SolrDataSource:
        return SolrDataSource(asset.config.get("datasource", {}))

    async def asset_exists(self, asset: AssetDefinition) -> bool:
        from urllib.parse import urlencode

        ds = self._datasource(asset)
        query = urlencode({"q": "*:*", "rows": "0"})
        try:
            status, _ = await store_request(
                "GET", f"{ds.collection_url}/select?{query}", headers=ds.headers
            )
            return status == 200
        except (OSError, asyncio.IncompleteReadError):  # aiohttp.ClientError's cases
            return False
        finally:
            await ds.close()

    async def deploy_asset(self, asset: AssetDefinition) -> None:
        ds = self._datasource(asset)
        try:
            for statement in asset.config.get("create-statements", []):
                api = statement.get("api")
                method = statement.get("method", "POST")
                body = statement.get("body", "")
                if isinstance(body, (dict, list)):
                    payload = json.dumps(body)
                else:
                    payload = body if str(body).startswith("{") else "{" + str(body) + "}"
                if api == "/api/collections":
                    url = f"{ds.base_url}/api/collections"
                elif api == "/schema":
                    url = f"{ds.collection_url}/schema"
                else:
                    raise ValueError(f"unexpected api value: {api!r}")
                status, text = await store_request(
                    method, url, data=payload,
                    headers={**ds.headers, "Content-Type": "application/json"},
                )
                if status not in (200, 201):
                    raise RuntimeError(
                        f"solr asset {method} {url}: {status} {text[:300]}"
                    )
        finally:
            await ds.close()


AssetManagerRegistry.register("solr-collection", SolrCollectionAssetManager())

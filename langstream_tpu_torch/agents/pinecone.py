"""Pinecone vector store over its REST data plane.

Parity: ``langstream-vector-agents/.../pinecone/PineconeDataSource.java`` +
``PineconeWriter.java``. Config keys match the reference
(``PineconeDataSource.PineconeConfig``): ``api-key``, ``environment``,
``project-name``, ``index-name``, ``endpoint`` (direct URL override, the
reference uses it the same way), ``server-side-timeout-sec``.

The reference drives Pinecone through its gRPC SDK; the REST data plane
(``/query``, ``/vectors/upsert``, ``/vectors/delete``) is the same surface
and also matches Pinecone serverless, so this speaks REST through the
port's standard-library client
(:func:`~langstream_tpu_torch.agents.vector.store_request`, https).

Query lane (same JSON the reference interpolates into ``QueryRequest``):

    {"vector": ?, "topK": 5, "filter": {"genre": {"$eq": "doc"}},
     "includeMetadata": true, "namespace": "..."}

Write lane: the ``vector-db-sink`` structured (collection, id, vector,
payload) shape maps to upsert with the payload as metadata; ``collection``
maps to the Pinecone namespace.

The port's copy of ``langstream_tpu/agents/pinecone.py``: the same
requests, paths and bodies.
"""

from __future__ import annotations

import json
from typing import Any

from langstream_tpu_torch.agents.vector import DataSource, bind_json_query, store_request


class PineconeDataSource(DataSource):
    def __init__(self, resource: dict[str, Any]):
        cfg = resource.get("configuration", resource)
        self.api_key = cfg.get("api-key", "")
        index = cfg.get("index-name", "index")
        project = cfg.get("project-name", "project")
        environment = cfg.get("environment", "default")
        self.base = (
            cfg.get("endpoint")
            or f"https://{index}-{project}.svc.{environment}.pinecone.io"
        ).rstrip("/")
        self.timeout = float(cfg.get("server-side-timeout-sec", 10))

    async def _post(self, path: str, body: dict[str, Any]) -> dict[str, Any]:
        status, text = await store_request(
            "POST", f"{self.base}{path}", json_body=body,
            headers={"Api-Key": self.api_key}, timeout=self.timeout,
        )
        if status not in (200, 201):
            raise RuntimeError(
                f"pinecone POST {path}: {status} {text[:300]}"
            )
        return json.loads(text) if text else {}

    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        q = bind_json_query(query, params)
        body: dict[str, Any] = {
            "vector": q.get("vector"),
            "topK": int(q.get("topK", q.get("top-k", 10))),
            "includeMetadata": bool(q.get("includeMetadata", True)),
            "includeValues": bool(q.get("includeValues", False)),
        }
        for key in ("filter", "namespace", "id"):
            if q.get(key) is not None:
                body[key] = q[key]
        data = await self._post("/query", body)
        rows: list[dict[str, Any]] = []
        for match in data.get("matches", []):
            row = dict(match.get("metadata") or {})
            row["id"] = match.get("id")
            if match.get("score") is not None:
                row["similarity"] = float(match["score"])
            if match.get("values"):
                row["vector"] = match["values"]
            rows.append(row)
        return rows

    async def execute_write(self, query: str, params: list[Any]) -> None:
        q = bind_json_query(query, params)
        if q.get("delete"):
            body = {"ids": q.get("ids") or [q.get("id")]}
            if q.get("namespace"):
                body["namespace"] = q["namespace"]
            await self._post("/vectors/delete", body)
            return
        vectors = q.get("vectors") or [
            {"id": q.get("id"), "values": q.get("vector"),
             "metadata": q.get("metadata") or {}}
        ]
        body = {"vectors": vectors}
        if q.get("namespace"):
            body["namespace"] = q["namespace"]
        await self._post("/vectors/upsert", body)

    async def upsert(self, collection, item_id, vector, payload) -> None:
        metadata = {
            k: v for k, v in (payload or {}).items() if v is not None
        }
        body: dict[str, Any] = {
            "vectors": [
                {"id": str(item_id), "values": vector, "metadata": metadata}
            ]
        }
        if collection and collection != "default":
            body["namespace"] = collection
        await self._post("/vectors/upsert", body)

    async def delete_item(self, collection, item_id) -> None:
        body: dict[str, Any] = {"ids": [str(item_id)]}
        if collection and collection != "default":
            body["namespace"] = collection
        await self._post("/vectors/delete", body)

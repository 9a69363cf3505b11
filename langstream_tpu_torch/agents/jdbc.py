"""JDBC-style SQL vector store: SQLite in-process, PGVector-compatible SQL.

Parity: ``langstream-vector-agents/.../jdbc/JdbcWriter.java`` (writer),
``.../datasource/impl/JdbcDataSourceProvider`` (query datasource), and the
``jdbc-table`` asset manager (create-statements provisioning).

TPU-stack rationale: the reference bundles HerdDB as its in-cluster SQL
store; here SQLite (stdlib, zero deps) plays that role, with the same SQL
surface a PGVector deployment would use. Database selection:

    resources:
      - type: "datasource"
        name: "db"
        configuration:
          service: "jdbc"
          driver: "sqlite"          # "postgres" is refused by name
          url: "/path/app.db"       # ":memory:" for tests/dev

Vectors are stored as JSON arrays in a TEXT column; similarity is exposed
to SQL as ``cosine_similarity(vec_column, ?)`` — a registered SQLite
function (PGVector's ``1 - (col <=> ?)`` maps onto it 1:1, so pipelines
port between the two by swapping the query string, exactly like the
reference's per-store query dialects).

Blocking DB calls run on a dedicated thread so the agent event loop stays
live (the role the reference's JDBC connection pool plays).

The port's copy of ``langstream_tpu/agents/jdbc.py``; it imports only the
port. As in the JAX package, ``driver: postgres`` is refused by name and no
postgres client library is imported.
"""

from __future__ import annotations

import asyncio
import json
import sqlite3
import threading
from typing import Any

from langstream_tpu_torch.agents.assets import AssetManager, AssetManagerRegistry
from langstream_tpu_torch.agents.vector import DataSource
from langstream_tpu_torch.api.application import AssetDefinition


def _cosine_similarity(a_json: str, b_json: str) -> float | None:
    try:
        a = json.loads(a_json)
        b = json.loads(b_json)
    except (TypeError, ValueError):
        return None
    if not a or not b or len(a) != len(b):
        return None
    dot = sum(x * y for x, y in zip(a, b))
    na = sum(x * x for x in a) ** 0.5
    nb = sum(y * y for y in b) ** 0.5
    if na == 0 or nb == 0:
        return None
    return dot / (na * nb)


class JdbcDataSource(DataSource):
    """SQL datasource + vector writer over sqlite3; the ``postgres`` and
    ``pgvector`` drivers are refused by name, as in the JAX package.

    Instances are shared per (database kind, url) via :meth:`get` so asset
    provisioning and agents see one database — essential for ``:memory:``
    (a fresh connection would be a fresh empty DB).
    """

    _shared: dict[tuple[str, str], "JdbcDataSource"] = {}
    _shared_lock = threading.Lock()

    @classmethod
    def get(cls, resource: dict[str, Any]) -> "JdbcDataSource":
        cfg = resource.get("configuration", resource)
        key = (cfg.get("driver", "sqlite"), cfg.get("url", ":memory:"))
        with cls._shared_lock:
            if key not in cls._shared:
                cls._shared[key] = cls(resource)
            return cls._shared[key]

    @classmethod
    def reset_shared(cls) -> None:
        with cls._shared_lock:
            cls._shared.clear()

    def __init__(self, resource: dict[str, Any]):
        cfg = resource.get("configuration", resource)
        # the service name implies the database kind when none is set
        # explicitly (service: pgvector alone must NOT silently open sqlite)
        service = cfg.get("service", "jdbc")
        default_driver = (
            "postgres" if service in ("postgres", "pgvector") else "sqlite"
        )
        self.driver = cfg.get("driver", default_driver)
        self.url = cfg.get("url", ":memory:")
        # one connection guarded by the executor thread; sqlite3 objects
        # must be used from the thread that created them
        self._local_conn: sqlite3.Connection | None = None
        if self.driver in ("postgres", "pgvector"):
            # the port carries no postgres client library; refuse loudly
            # instead of writing into a local sqlite junk file
            raise ImportError(
                "postgres/pgvector driver needs a postgres client library "
                "(psycopg), which the port does not load; use "
                "driver: sqlite (same SQL surface via cosine_similarity)"
            )
        if self.driver not in ("sqlite",):
            raise ValueError(f"unknown jdbc driver {self.driver!r}")
        self._executor_lock = threading.Lock()
        self._loop_executor = None  # created lazily per loop

    # -- connection handling -------------------------------------------

    def _conn(self) -> sqlite3.Connection:
        if self._local_conn is None:
            conn = sqlite3.connect(self.url)
            conn.row_factory = sqlite3.Row
            conn.create_function(
                "cosine_similarity", 2, _cosine_similarity, deterministic=True
            )
            self._local_conn = conn
        return self._local_conn

    async def _run(self, fn):
        from concurrent.futures import ThreadPoolExecutor

        with self._executor_lock:
            if self._loop_executor is None:
                self._loop_executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="jdbc"
                )
        return await asyncio.get_running_loop().run_in_executor(
            self._loop_executor, fn
        )

    # -- DataSource ------------------------------------------------------

    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        def go():
            cur = self._conn().execute(query, [self._to_sql(p) for p in params])
            rows = [dict(r) for r in cur.fetchall()]
            cur.close()
            return rows

        rows = await self._run(go)
        # JSON-decode vector-looking TEXT columns back to lists
        for row in rows:
            for k, v in list(row.items()):
                if isinstance(v, str) and v.startswith("[") and v.endswith("]"):
                    try:
                        row[k] = json.loads(v)
                    except ValueError:
                        pass
        return rows

    async def execute_write(self, query: str, params: list[Any]) -> int:
        """Run a DML statement, commit, return the affected-row count."""

        def go():
            conn = self._conn()
            cur = conn.execute(query, [self._to_sql(p) for p in params])
            conn.commit()
            return cur.rowcount

        return await self._run(go)

    async def executemany(self, query: str, rows: list[list[Any]]) -> None:
        def go():
            conn = self._conn()
            conn.executemany(
                query, [[self._to_sql(p) for p in row] for row in rows]
            )
            conn.commit()

        await self._run(go)

    @staticmethod
    def _to_sql(value: Any) -> Any:
        if isinstance(value, (list, tuple)):
            return json.dumps(list(value))
        if isinstance(value, dict):
            return json.dumps(value)
        return value

    # -- structured writer lane (vector-db-sink) -------------------------

    async def upsert(self, collection, item_id, vector, payload) -> None:
        cols = ["id", "embeddings"] + sorted(payload)
        placeholders = ", ".join("?" for _ in cols)
        sql = (
            f"INSERT OR REPLACE INTO {collection} ({', '.join(cols)}) "
            f"VALUES ({placeholders})"
        )
        values = [item_id, self._to_sql(vector)] + [
            self._to_sql(payload[k]) for k in sorted(payload)
        ]
        await self.execute_write(sql, values)

    async def delete_item(self, collection, item_id) -> None:
        await self.execute_write(
            f"DELETE FROM {collection} WHERE id = ?", [item_id]
        )

    async def table_exists(self, name: str) -> bool:
        rows = await self.fetch_data(
            "SELECT name FROM sqlite_master WHERE type='table' AND name = ?",
            [name],
        )
        return bool(rows)

    async def close(self) -> None:
        def go():
            if self._local_conn is not None:
                self._local_conn.close()
                self._local_conn = None

        await self._run(go)
        if self._loop_executor is not None:
            self._loop_executor.shutdown(wait=False)
            self._loop_executor = None


class JdbcTableAssetManager(AssetManager):
    """Asset type ``jdbc-table``: run the configured ``create-statements``
    when the table is absent (parity: JDBC assets in
    ``langstream-core/.../assets/``). Uses the shared per-url instance so
    the provisioned table is visible to the agents' datasource."""

    async def asset_exists(self, asset: AssetDefinition) -> bool:
        ds = _asset_datasource(asset)
        return await ds.table_exists(asset.config.get("table-name", asset.name))

    async def deploy_asset(self, asset: AssetDefinition) -> None:
        ds = _asset_datasource(asset)
        for stmt in asset.config.get("create-statements", []):
            await ds.execute_write(stmt, [])

    async def delete_asset(self, asset: AssetDefinition) -> None:
        ds = _asset_datasource(asset)
        for stmt in asset.config.get("delete-statements", []):
            await ds.execute_write(stmt, [])


def _asset_datasource(asset: AssetDefinition) -> JdbcDataSource:
    ds = asset.config.get("datasource")
    if isinstance(ds, dict):
        return JdbcDataSource.get(ds)
    return JdbcDataSource.get(
        {"configuration": {"url": asset.config.get("url", ":memory:")}}
    )


AssetManagerRegistry.register("jdbc-table", JdbcTableAssetManager())

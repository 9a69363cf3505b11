"""Self-hosted Cassandra datasource over the CQL native protocol v4.

The reference speaks CQL to plain Cassandra clusters through the DataStax
Java client (``langstream-agents/langstream-vector-agents/.../cassandra/
CassandraWriter.java``, ``CassandraDataSource.java``). Without that client,
aliasing ``service: cassandra`` to the Astra JSON Data API would send HTTP
requests to CQL-only clusters, so this module is a minimal, SDK-free
implementation of the v4 native protocol — STARTUP (+ SASL PLAIN auth),
QUERY, PREPARE/EXECUTE — enough for ``vector-db-sink`` /
``query-vector-db`` / table assets against a stock cluster.

Why PREPARE instead of plain QUERY-with-values: Cassandra requires bound
values serialized in the column's exact wire type (an ``int`` column wants
4 bytes, ``bigint`` 8); the PREPARED response carries bind-variable type
metadata, so serialization is type-directed instead of guessed from Python
types.

Wire format (v4): 9-byte frame header ``version | flags | stream(i16) |
opcode | length(i32)``; all integers big-endian. Types cover the practical
subset incl. ``list<float>`` embeddings and Cassandra 5's ``vector<float,
n>`` custom type.

The port's copy of ``langstream_tpu/agents/cassandra_cql.py``; it imports only the port.
"""

from __future__ import annotations

import asyncio
import io
import struct
import uuid as uuid_mod
from typing import Any

# opcodes
OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_AUTHENTICATE = 0x03
OP_QUERY = 0x07
OP_RESULT = 0x08
OP_PREPARE = 0x09
OP_EXECUTE = 0x0A
OP_AUTH_RESPONSE = 0x0F
OP_AUTH_SUCCESS = 0x10

# result kinds
RESULT_VOID = 0x0001
RESULT_ROWS = 0x0002
RESULT_SET_KEYSPACE = 0x0003
RESULT_PREPARED = 0x0004
RESULT_SCHEMA_CHANGE = 0x0005

CONSISTENCY = {
    "any": 0x0000, "one": 0x0001, "two": 0x0002, "three": 0x0003,
    "quorum": 0x0004, "all": 0x0005, "local-quorum": 0x0006,
    "each-quorum": 0x0007, "serial": 0x0008, "local-serial": 0x0009,
    "local-one": 0x000A,
}

_VECTOR_CLASS = "org.apache.cassandra.db.marshal.VectorType"
_FLOAT_CLASS = "org.apache.cassandra.db.marshal.FloatType"


# ---------------------------------------------------------------------------
# primitive readers/writers
# ---------------------------------------------------------------------------


def _w_short(n: int) -> bytes:
    return struct.pack(">H", n)


def _w_int(n: int) -> bytes:
    return struct.pack(">i", n)


def _w_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return _w_short(len(b)) + b


def _w_long_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return _w_int(len(b)) + b


def _w_bytes(b: bytes | None) -> bytes:
    if b is None:
        return _w_int(-1)
    return _w_int(len(b)) + b


def _w_short_bytes(b: bytes) -> bytes:
    return _w_short(len(b)) + b


def _w_string_map(d: dict[str, str]) -> bytes:
    out = _w_short(len(d))
    for k, v in d.items():
        out += _w_string(k) + _w_string(v)
    return out


class _Reader:
    def __init__(self, data: bytes):
        self._io = io.BytesIO(data)

    def read(self, n: int) -> bytes:
        b = self._io.read(n)
        if len(b) != n:
            raise EOFError(f"truncated CQL frame (wanted {n}, got {len(b)})")
        return b

    def u8(self) -> int:
        return self.read(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self.read(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.read(4))[0]

    def string(self) -> str:
        return self.read(self.u16()).decode("utf-8")

    def long_string(self) -> str:
        return self.read(self.i32()).decode("utf-8")

    def bytes_(self) -> bytes | None:
        n = self.i32()
        return None if n < 0 else self.read(n)

    def short_bytes(self) -> bytes:
        return self.read(self.u16())


# ---------------------------------------------------------------------------
# type options: parse + (de)serialize
# ---------------------------------------------------------------------------

# scalar option ids → (name, struct fmt | None)
_SCALARS = {
    0x0001: "ascii", 0x0002: "bigint", 0x0003: "blob", 0x0004: "boolean",
    0x0005: "counter", 0x0006: "decimal", 0x0007: "double", 0x0008: "float",
    0x0009: "int", 0x000B: "timestamp", 0x000C: "uuid", 0x000D: "varchar",
    0x000E: "varint", 0x000F: "timeuuid", 0x0010: "inet", 0x0011: "date",
    0x0012: "time", 0x0013: "smallint", 0x0014: "tinyint",
}


def read_type_option(r: _Reader) -> tuple:
    """→ ("int",) | ("list", elem) | ("map", k, v) | ("set", e) |
    ("vector", elem, dim) | ("custom", class) | ("tuple", (..)) ..."""
    tid = r.u16()
    if tid in _SCALARS:
        return (_SCALARS[tid],)
    if tid == 0x0000:  # custom — Cassandra 5 vectors arrive this way
        cls = r.string()
        if cls.startswith(_VECTOR_CLASS):
            inner = cls[len(_VECTOR_CLASS) + 1 : -1]  # "(Elem, n)"
            elem_cls, _, dim = inner.rpartition(",")
            elem = ("float",) if _FLOAT_CLASS in elem_cls else ("custom", elem_cls.strip())
            return ("vector", elem, int(dim.strip()))
        return ("custom", cls)
    if tid == 0x0020:
        return ("list", read_type_option(r))
    if tid == 0x0021:
        return ("map", read_type_option(r), read_type_option(r))
    if tid == 0x0022:
        return ("set", read_type_option(r))
    if tid == 0x0031:
        n = r.u16()
        return ("tuple", tuple(read_type_option(r) for _ in range(n)))
    if tid == 0x0030:  # UDT: ks, name, fields
        ks, name = r.string(), r.string()
        n = r.u16()
        fields = tuple((r.string(), read_type_option(r)) for _ in range(n))
        return ("udt", ks, name, fields)
    raise ValueError(f"unsupported CQL type option 0x{tid:04x}")


def serialize_value(opt: tuple, value: Any) -> bytes | None:
    """Python value → CQL binary for the given type option; None → null."""
    if value is None:
        return None
    kind = opt[0]
    if kind in ("ascii", "varchar"):
        return str(value).encode("utf-8")
    if kind == "blob":
        return bytes(value)
    if kind == "boolean":
        return b"\x01" if value else b"\x00"
    if kind in ("bigint", "counter", "timestamp", "time"):
        return struct.pack(">q", int(value))
    if kind == "int":
        return struct.pack(">i", int(value))
    if kind == "smallint":
        return struct.pack(">h", int(value))
    if kind == "tinyint":
        return struct.pack(">b", int(value))
    if kind == "date":  # days since epoch, unsigned-centered
        return struct.pack(">I", int(value) + (1 << 31))
    if kind == "double":
        return struct.pack(">d", float(value))
    if kind == "float":
        return struct.pack(">f", float(value))
    if kind == "varint":
        n = int(value)
        length = max(1, (n.bit_length() + 8) // 8)
        return n.to_bytes(length, "big", signed=True)
    if kind in ("uuid", "timeuuid"):
        return uuid_mod.UUID(str(value)).bytes
    if kind == "vector":
        _, elem, dim = opt
        if len(value) != dim:
            raise ValueError(f"vector<_, {dim}> got {len(value)} elements")
        # fixed-size elements are written back to back (no per-item length)
        return b"".join(serialize_value(elem, v) for v in value)
    if kind in ("list", "set"):
        elem = opt[1]
        out = _w_int(len(value))
        for v in value:
            out += _w_bytes(serialize_value(elem, v))
        return out
    if kind == "map":
        _, kopt, vopt = opt
        out = _w_int(len(value))
        for k, v in value.items():
            out += _w_bytes(serialize_value(kopt, k))
            out += _w_bytes(serialize_value(vopt, v))
        return out
    raise ValueError(f"cannot serialize to CQL type {opt!r}")


def deserialize_value(opt: tuple, data: bytes | None) -> Any:
    if data is None:
        return None
    kind = opt[0]
    if kind in ("ascii", "varchar"):
        return data.decode("utf-8")
    if kind == "blob" or kind == "custom":
        return data
    if kind == "boolean":
        return data != b"\x00"
    if kind in ("bigint", "counter", "timestamp", "time"):
        return struct.unpack(">q", data)[0]
    if kind == "int":
        return struct.unpack(">i", data)[0]
    if kind == "smallint":
        return struct.unpack(">h", data)[0]
    if kind == "tinyint":
        return struct.unpack(">b", data)[0]
    if kind == "date":
        return struct.unpack(">I", data)[0] - (1 << 31)
    if kind == "double":
        return struct.unpack(">d", data)[0]
    if kind == "float":
        return struct.unpack(">f", data)[0]
    if kind == "varint":
        return int.from_bytes(data, "big", signed=True)
    if kind in ("uuid", "timeuuid"):
        return str(uuid_mod.UUID(bytes=data))
    if kind == "inet":
        import socket as _socket

        fam = _socket.AF_INET if len(data) == 4 else _socket.AF_INET6
        return _socket.inet_ntop(fam, data)
    if kind == "vector":
        _, elem, dim = opt
        size = len(data) // dim if dim else 0
        return [
            deserialize_value(elem, data[i * size : (i + 1) * size])
            for i in range(dim)
        ]
    if kind in ("list", "set"):
        r = _Reader(data)
        n = r.i32()
        return [deserialize_value(opt[1], r.bytes_()) for _ in range(n)]
    if kind == "map":
        r = _Reader(data)
        n = r.i32()
        out = {}
        for _ in range(n):
            k = deserialize_value(opt[1], r.bytes_())
            out[k] = deserialize_value(opt[2], r.bytes_())
        return out
    raise ValueError(f"cannot deserialize CQL type {opt!r}")


def infer_type_option(value: Any) -> tuple:
    """Fallback typing for unprepared binds (DDL params, fresh columns)."""
    if isinstance(value, bool):
        return ("boolean",)
    if isinstance(value, int):
        return ("bigint",)
    if isinstance(value, float):
        return ("double",)
    if isinstance(value, bytes):
        return ("blob",)
    if isinstance(value, (list, tuple)):
        elem = infer_type_option(value[0]) if value else ("varchar",)
        if elem == ("double",):
            elem = ("float",)  # embeddings: list<float> by convention
        return ("list", elem)
    if isinstance(value, dict):
        k = infer_type_option(next(iter(value))) if value else ("varchar",)
        v = infer_type_option(next(iter(value.values()))) if value else ("varchar",)
        return ("map", k, v)
    return ("varchar",)


# ---------------------------------------------------------------------------
# error surface
# ---------------------------------------------------------------------------


class CqlError(RuntimeError):
    def __init__(self, code: int, message: str):
        super().__init__(f"CQL error 0x{code:04x}: {message}")
        self.code = code
        self.msg = message


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class CqlClient:
    """One connection speaking protocol v4. Single in-flight request
    (stream id 0) — the agents' access pattern is strictly sequential per
    datasource, and one stream keeps the client ~200 lines."""

    VERSION_REQ = 0x04
    VERSION_RESP = 0x84

    def __init__(self, host: str, port: int = 9042,
                 username: str | None = None, password: str | None = None,
                 connect_timeout: float = 10.0,
                 request_timeout: float = 30.0):
        self.host, self.port = host, port
        self.username, self.password = username, password
        self.connect_timeout = connect_timeout
        self.request_timeout = request_timeout
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._prepared: dict[str, tuple[bytes, list[tuple]]] = {}
        self._lock = asyncio.Lock()

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port),
            timeout=self.connect_timeout,
        )
        op, body = await self._request(
            OP_STARTUP, _w_string_map({"CQL_VERSION": "3.0.0"})
        )
        if op == OP_AUTHENTICATE:
            token = (
                b"\x00" + (self.username or "").encode()
                + b"\x00" + (self.password or "").encode()
            )
            op, body = await self._request(OP_AUTH_RESPONSE, _w_bytes(token))
            if op != OP_AUTH_SUCCESS:
                raise CqlError(-1, f"authentication failed (opcode {op})")
        elif op != OP_READY:
            raise CqlError(-1, f"unexpected startup response opcode {op}")

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (OSError, ConnectionError):
                pass
            self._writer = self._reader = None

    # -- framing -----------------------------------------------------------

    async def _request(self, opcode: int, body: bytes) -> tuple[int, bytes]:
        if self._writer is None:
            raise ConnectionError("CQL client is not connected")
        frame = struct.pack(
            ">BBhBi", self.VERSION_REQ, 0, 0, opcode, len(body)
        ) + body
        self._writer.write(frame)
        await self._writer.drain()
        header = await asyncio.wait_for(
            self._reader.readexactly(9), timeout=self.request_timeout
        )
        _ver, _flags, _stream, op, length = struct.unpack(">BBhBi", header)
        payload = (
            await asyncio.wait_for(
                self._reader.readexactly(length), timeout=self.request_timeout
            )
            if length
            else b""
        )
        if op == OP_ERROR:
            r = _Reader(payload)
            raise CqlError(r.i32(), r.string())
        return op, payload

    # -- queries -----------------------------------------------------------

    @staticmethod
    def _query_params(values: list[bytes | None] | None,
                      consistency: int) -> bytes:
        flags = 0x01 if values else 0x00
        out = _w_short(consistency) + bytes([flags])
        if values:
            out += _w_short(len(values))
            for v in values:
                out += _w_bytes(v)
        return out

    async def query(self, cql: str, consistency: int = CONSISTENCY["local-quorum"],
                    values: list[bytes | None] | None = None):
        """Unprepared QUERY (DDL, parameterless statements, or pre-serialized
        values)."""
        async with self._lock:
            op, body = await self._request(
                OP_QUERY,
                _w_long_string(cql) + self._query_params(values, consistency),
            )
        return self._parse_result(body)

    async def prepare(self, cql: str) -> tuple[bytes, list[tuple]]:
        """→ (statement id, bind-variable type options); cached per text."""
        if cql in self._prepared:
            return self._prepared[cql]
        async with self._lock:
            if cql in self._prepared:
                return self._prepared[cql]
            op, body = await self._request(OP_PREPARE, _w_long_string(cql))
            r = _Reader(body)
            kind = r.i32()
            if kind != RESULT_PREPARED:
                raise CqlError(-1, f"PREPARE returned result kind {kind}")
            stmt_id = r.short_bytes()
            bind_types = [c[1] for c in self._read_metadata(r, prepared=True)]
            self._prepared[cql] = (stmt_id, bind_types)
            return self._prepared[cql]

    async def execute(self, cql: str, params: list[Any] | None = None,
                      consistency: int = CONSISTENCY["local-quorum"]):
        """PREPARE (cached) + EXECUTE with type-directed serialization.
        → list[dict] for Rows results, [] otherwise."""
        params = params or []
        stmt_id, bind_types = await self.prepare(cql)
        if len(bind_types) != len(params):
            raise ValueError(
                f"query binds {len(bind_types)} values, got {len(params)}"
            )
        values = [
            serialize_value(t, v) for t, v in zip(bind_types, params)
        ]
        async with self._lock:
            try:
                op, body = await self._request(
                    OP_EXECUTE,
                    _w_short_bytes(stmt_id)
                    + self._query_params(values, consistency),
                )
            except CqlError as e:
                if e.code == 0x2500:  # unprepared (server restarted): re-prepare
                    self._prepared.pop(cql, None)
                    raise
                raise
        return self._parse_result(body)

    # -- result parsing ----------------------------------------------------

    @staticmethod
    def _read_metadata(r: _Reader, prepared: bool = False) -> list[tuple[str, tuple]]:
        flags = r.i32()
        col_count = r.i32()
        if prepared:  # v4: pk_count + pk indices precede the specs
            pk_count = r.i32()
            for _ in range(pk_count):
                r.u16()
        if flags & 0x0002:  # has_more_pages
            r.bytes_()  # paging state (unused: agents read full pages)
        if flags & 0x0004:  # no_metadata
            return [("", ()) for _ in range(col_count)]
        global_spec = bool(flags & 0x0001)
        if global_spec:
            r.string(), r.string()  # keyspace, table
        cols = []
        for _ in range(col_count):
            if not global_spec:
                r.string(), r.string()
            name = r.string()
            cols.append((name, read_type_option(r)))
        return cols

    def _parse_result(self, body: bytes) -> list[dict[str, Any]]:
        r = _Reader(body)
        kind = r.i32()
        if kind in (RESULT_VOID, RESULT_SET_KEYSPACE, RESULT_SCHEMA_CHANGE):
            return []
        if kind != RESULT_ROWS:
            raise CqlError(-1, f"unexpected result kind {kind}")
        cols = self._read_metadata(r)
        rows_count = r.i32()
        out = []
        for _ in range(rows_count):
            row = {}
            for name, opt in cols:
                row[name] = deserialize_value(opt, r.bytes_())
            out.append(row)
        return out


# ---------------------------------------------------------------------------
# datasource (the SPI the agents drive)
# ---------------------------------------------------------------------------


class CassandraCqlDataSource:
    """``service: cassandra`` — CQL to a self-hosted cluster.

    Config (parity: ``CassandraDataSource.java`` resource config):
    ``contact-points`` (str or list), ``port`` (9042), ``username`` /
    ``password`` (or ``secret``), ``keyspace`` (unqualified collection
    names resolve against it), ``consistency`` (``local-quorum``).
    """

    def __init__(self, resource: dict[str, Any]):
        cfg = resource.get("configuration", resource)
        points = cfg.get("contact-points") or cfg.get("host") or "127.0.0.1"
        if isinstance(points, str):
            points = [p.strip() for p in points.split(",") if p.strip()]
        self.hosts = points
        self.port = int(cfg.get("port", 9042))
        self.keyspace = cfg.get("keyspace")
        self.consistency = CONSISTENCY[
            str(cfg.get("consistency", "local-quorum")).lower()
        ]
        self.id_column = cfg.get("id-column", "id")
        self.vector_column = cfg.get("vector-column", "vector")
        self._client = CqlClient(
            self.hosts[0], self.port,
            username=cfg.get("username"),
            password=cfg.get("password", cfg.get("secret")),
        )
        self._connected = False
        self._connect_lock = asyncio.Lock()

    async def _ensure(self) -> CqlClient:
        async with self._connect_lock:
            if not self._connected:
                last: Exception | None = None
                for host in self.hosts:
                    self._client.host = host
                    try:
                        await self._client.connect()
                        self._connected = True
                        break
                    except (OSError, asyncio.TimeoutError, CqlError) as e:
                        last = e
                else:
                    raise ConnectionError(
                        f"no Cassandra contact point reachable "
                        f"({', '.join(self.hosts)}:{self.port}): {last}"
                    )
        return self._client

    def _table(self, collection: str) -> str:
        if "." in collection or not self.keyspace:
            return collection
        return f"{self.keyspace}.{collection}"

    # -- DataSource SPI ----------------------------------------------------

    async def fetch_data(self, query: str, params: list[Any]) -> list[dict[str, Any]]:
        client = await self._ensure()
        return await client.execute(query, params, self.consistency)

    async def execute_write(self, query: str, params: list[Any]) -> None:
        client = await self._ensure()
        await client.execute(query, params, self.consistency)

    async def upsert(self, collection: str, item_id: Any,
                     vector: list[float] | None,
                     payload: dict[str, Any]) -> None:
        client = await self._ensure()
        cols = [self.id_column] + sorted(payload)
        vals: list[Any] = [item_id] + [payload[k] for k in sorted(payload)]
        if vector is not None:
            cols.append(self.vector_column)
            vals.append(vector)
        cql = (
            f"INSERT INTO {self._table(collection)} "
            f"({', '.join(cols)}) VALUES ({', '.join('?' * len(cols))})"
        )
        await client.execute(cql, vals, self.consistency)

    async def delete_item(self, collection: str, item_id: Any) -> None:
        client = await self._ensure()
        await client.execute(
            f"DELETE FROM {self._table(collection)} WHERE {self.id_column} = ?",
            [item_id], self.consistency,
        )

    async def close(self) -> None:
        await self._client.close()


# ---------------------------------------------------------------------------
# assets (parity: CassandraAssetsManagerProvider — cassandra-table /
# cassandra-keyspace with create-statements / delete-statements)
# ---------------------------------------------------------------------------


from langstream_tpu_torch.agents.assets import AssetManager, AssetManagerRegistry  # noqa: E402
from langstream_tpu_torch.api.application import AssetDefinition  # noqa: E402


class _CassandraAssetBase(AssetManager):
    def _datasource(self, asset: AssetDefinition) -> CassandraCqlDataSource:
        return CassandraCqlDataSource(asset.config.get("datasource", {}))

    async def _run_statements(self, asset: AssetDefinition, key: str) -> None:
        ds = self._datasource(asset)
        try:
            client = await ds._ensure()
            for stmt in asset.config.get(key, []):
                await client.query(stmt, ds.consistency)
        finally:
            await ds.close()

    async def deploy_asset(self, asset: AssetDefinition) -> None:
        await self._run_statements(asset, "create-statements")

    async def delete_asset(self, asset: AssetDefinition) -> None:
        await self._run_statements(asset, "delete-statements")


class CassandraTableAssetManager(_CassandraAssetBase):
    """``cassandra-table``: config ``table-name``, ``keyspace``,
    ``create-statements`` / ``delete-statements`` (raw CQL DDL, like the
    reference's)."""

    async def asset_exists(self, asset: AssetDefinition) -> bool:
        ds = self._datasource(asset)
        try:
            client = await ds._ensure()
            rows = await client.execute(
                "SELECT table_name FROM system_schema.tables "
                "WHERE keyspace_name = ? AND table_name = ?",
                [
                    asset.config.get("keyspace", ds.keyspace),
                    asset.config.get("table-name", asset.name),
                ],
                ds.consistency,
            )
            return bool(rows)
        finally:
            await ds.close()


class CassandraKeyspaceAssetManager(_CassandraAssetBase):
    """``cassandra-keyspace``: config ``keyspace`` +
    ``create-statements`` / ``delete-statements``."""

    async def asset_exists(self, asset: AssetDefinition) -> bool:
        ds = self._datasource(asset)
        try:
            client = await ds._ensure()
            rows = await client.execute(
                "SELECT keyspace_name FROM system_schema.keyspaces "
                "WHERE keyspace_name = ?",
                [asset.config.get("keyspace", asset.name)],
                ds.consistency,
            )
            return bool(rows)
        finally:
            await ds.close()


AssetManagerRegistry.register("cassandra-table", CassandraTableAssetManager())
AssetManagerRegistry.register("cassandra-keyspace", CassandraKeyspaceAssetManager())

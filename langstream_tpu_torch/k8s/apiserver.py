"""An embedded conformance-grade Kubernetes API server (HTTP, in-process;
the port's copy of ``langstream_tpu/k8s/apiserver.py``).

Two roles:
1. **Test double** (born as ``tests/fake_kube.py``): the operator/
   deployer/stores are proven against real API-machinery semantics instead
   of an object dict (the reference proves its stack against
   K3s-in-docker, ``LocalK3sContainer.java``; no container runtime exists
   in this image).
2. **The mini-cluster's API server** (``cli mini up``): the process-kubelet
   (:mod:`langstream_tpu_torch.k8s.kubelet`) runs pods as subprocesses that
   reach this server over real HTTP (``LS_KUBE_API_URL``) — the embedded
   role k3s's API server plays in ``mini-langstream``.

This server implements the API-machinery semantics those layers depend on,
independently of the client code under test:

- resource paths (``/api/v1``, ``/apis/<group>/<version>``, namespaced and
  cluster-scoped) for every kind in ``KIND_ROUTES``;
- a single monotonically increasing ``resourceVersion`` assigned on every
  write; **update with a stale resourceVersion → 409 Conflict**; create of
  an existing object → 409 AlreadyExists; missing object → 404 with a
  ``Status`` body;
- creates of namespaced objects **require the namespace object to exist**
  (404 NotFound otherwise) — the store's tenant-namespace lifecycle is real
  behavior, not convention;
- the ``/status`` subresource: status PUTs never touch spec, spec PUTs
  never touch status (the CRDs declare the subresource);
- ``?watch=true`` with chunked transfer: ADDED/MODIFIED/DELETED events in
  write order, starting after the client's ``resourceVersion``;
- ``labelSelector`` equality filtering on lists.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from langstream_tpu_torch.k8s.client import KIND_ROUTES

# (prefix, plural) -> kind
_ROUTE_INDEX = {
    (prefix, plural): kind
    for kind, (prefix, plural, _ns) in KIND_ROUTES.items()
}


def _status_body(code: int, reason: str, message: str) -> bytes:
    return json.dumps({
        "kind": "Status", "apiVersion": "v1", "status": "Failure",
        "message": message, "reason": reason, "code": code,
    }).encode()


class _State:
    def __init__(self) -> None:
        self.lock = threading.Condition()
        self.objects: dict[tuple[str, str | None, str], dict] = {}
        self.rv = 0
        # (rv, event type, kind, snapshot) in write order, for watches
        self.events: list[tuple[int, str, str, dict]] = []

    def next_rv(self) -> int:
        self.rv += 1
        return self.rv

    def record(self, event: str, kind: str, obj: dict) -> None:
        self.events.append((int(obj["metadata"]["resourceVersion"]),
                            event, kind, json.loads(json.dumps(obj))))
        self.lock.notify_all()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "FakeKube/1.0"

    # -- plumbing ----------------------------------------------------------

    def log_message(self, *args):  # quiet
        pass

    @property
    def state(self) -> _State:
        return self.server.state  # type: ignore[attr-defined]

    def _send_json(self, code: int, payload: dict | bytes) -> None:
        body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _err(self, code: int, reason: str, message: str) -> None:
        self._send_json(code, _status_body(code, reason, message))

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length", "0"))
        return json.loads(self.rfile.read(length)) if length else {}

    def _route(self):
        """path → (kind, namespace, name, subresource) or None."""
        parsed = urllib.parse.urlparse(self.path)
        parts = [p for p in parsed.path.split("/") if p]
        query = urllib.parse.parse_qs(parsed.query)
        # /api/v1/... or /apis/<group>/<version>/...
        if parts[:2] == ["api", "v1"]:
            prefix, rest = "/api/v1", parts[2:]
        elif parts[0] == "apis" and len(parts) >= 3:
            prefix, rest = f"/apis/{parts[1]}/{parts[2]}", parts[3:]
        else:
            return None
        namespace = None
        # "/namespaces/<ns>/<plural>/..." is a namespaced path ONLY when a
        # known plural follows the namespace — otherwise the path IS the
        # cluster-scoped Namespace collection (/api/v1/namespaces[/name])
        if (
            len(rest) >= 3
            and rest[0] == "namespaces"
            and (prefix, rest[2]) in _ROUTE_INDEX
        ):
            namespace, rest = rest[1], rest[2:]
        if not rest:
            return None
        kind = _ROUTE_INDEX.get((prefix, rest[0]))
        if kind is None:
            return None
        name = rest[1] if len(rest) >= 2 else None
        sub = rest[2] if len(rest) >= 3 else None
        return kind, namespace, name, sub, query

    def _key(self, kind: str, namespace: str | None, name: str):
        namespaced = KIND_ROUTES[kind][2]
        return (kind, namespace if namespaced else None, name)

    # -- verbs -------------------------------------------------------------

    def do_GET(self):  # noqa: N802
        route = self._route()
        if route is None:
            return self._err(404, "NotFound", f"no route for {self.path}")
        kind, ns, name, _sub, query = route
        if name is None:
            if query.get("watch", ["false"])[0] == "true":
                return self._watch(kind, ns, query)
            return self._list(kind, ns, query)
        with self.state.lock:
            obj = self.state.objects.get(self._key(kind, ns, name))
        if obj is None:
            return self._err(404, "NotFound", f"{kind} {name!r} not found")
        self._send_json(200, obj)

    def _list(self, kind: str, ns: str | None, query) -> None:
        selector = {}
        for part in query.get("labelSelector", [""])[0].split(","):
            if "=" in part:
                k, _, v = part.partition("=")
                selector[k] = v
        items = []
        with self.state.lock:
            for (k, ons, _n), obj in self.state.objects.items():
                if k != kind:
                    continue
                if ns is not None and ons != ns:
                    continue
                labels = (obj.get("metadata") or {}).get("labels") or {}
                if all(labels.get(sk) == sv for sk, sv in selector.items()):
                    items.append(obj)
            rv = self.state.rv
        self._send_json(200, {
            "kind": f"{kind}List", "apiVersion": "v1",
            "metadata": {"resourceVersion": str(rv)}, "items": items,
        })

    def _watch(self, kind: str, ns: str | None, query) -> None:
        since = int(query.get("resourceVersion", ["0"])[0] or 0)
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def _chunk(data: bytes) -> None:
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        sent = since
        deadline = time.monotonic() + float(
            query.get("timeoutSeconds", ["30"])[0]
        )
        try:
            while time.monotonic() < deadline:
                with self.state.lock:
                    pending = [
                        (rv, ev, obj)
                        for rv, ev, k, obj in self.state.events
                        if rv > sent and k == kind
                        and (ns is None or (obj["metadata"].get("namespace") == ns))
                    ]
                    if not pending:
                        self.state.lock.wait(timeout=0.2)
                        continue
                for rv, ev, obj in pending:
                    _chunk(json.dumps({"type": ev, "object": obj}).encode() + b"\n")
                    sent = rv
            _chunk(b"")  # terminating chunk
        except (BrokenPipeError, ConnectionResetError):
            pass

    def do_POST(self):  # noqa: N802
        route = self._route()
        if route is None:
            return self._err(404, "NotFound", f"no route for {self.path}")
        kind, ns, name, _sub, _q = route
        if name is not None:
            return self._err(405, "MethodNotAllowed", "POST to an item")
        obj = self._read_body()
        meta = obj.setdefault("metadata", {})
        if KIND_ROUTES[kind][2]:
            meta.setdefault("namespace", ns)
        with self.state.lock:
            if KIND_ROUTES[kind][2]:
                ns_key = ("Namespace", None, meta.get("namespace") or "")
                if ns_key not in self.state.objects:
                    return self._err(
                        404, "NotFound",
                        f"namespace {meta.get('namespace')!r} not found",
                    )
            key = self._key(kind, meta.get("namespace"), meta["name"])
            if key in self.state.objects:
                return self._err(
                    409, "AlreadyExists", f"{kind} {meta['name']!r} exists"
                )
            meta["resourceVersion"] = str(self.state.next_rv())
            meta.setdefault("uid", str(uuid.uuid4()))
            meta.setdefault("creationTimestamp", "2026-01-01T00:00:00Z")
            self.state.objects[key] = json.loads(json.dumps(obj))
            self.state.record("ADDED", kind, self.state.objects[key])
            self._send_json(201, self.state.objects[key])

    def do_PUT(self):  # noqa: N802
        route = self._route()
        if route is None:
            return self._err(404, "NotFound", f"no route for {self.path}")
        kind, ns, name, sub, _q = route
        if name is None:
            return self._err(405, "MethodNotAllowed", "PUT needs a name")
        obj = self._read_body()
        with self.state.lock:
            key = self._key(kind, ns, name)
            existing = self.state.objects.get(key)
            if existing is None:
                return self._err(404, "NotFound", f"{kind} {name!r} not found")
            claimed = (obj.get("metadata") or {}).get("resourceVersion")
            current = existing["metadata"]["resourceVersion"]
            if claimed is not None and str(claimed) != str(current):
                # the heart of optimistic concurrency: a stale writer loses
                return self._err(
                    409, "Conflict",
                    f"Operation cannot be fulfilled on {kind} {name!r}: "
                    f"object was modified (have {current}, got {claimed})",
                )
            merged = json.loads(json.dumps(obj))
            merged.setdefault("metadata", {})["namespace"] = existing[
                "metadata"].get("namespace")
            merged["metadata"]["uid"] = existing["metadata"]["uid"]
            if sub == "status":
                # status subresource: ONLY status moves
                merged = json.loads(json.dumps(existing))
                merged["status"] = obj.get("status") or {}
            else:
                # main resource: status is owned by the subresource
                if "status" in existing:
                    merged["status"] = existing["status"]
                merged.setdefault("kind", kind)
            merged["metadata"]["resourceVersion"] = str(self.state.next_rv())
            self.state.objects[key] = merged
            self.state.record("MODIFIED", kind, merged)
            self._send_json(200, merged)

    def do_DELETE(self):  # noqa: N802
        route = self._route()
        if route is None:
            return self._err(404, "NotFound", f"no route for {self.path}")
        kind, ns, name, _sub, _q = route
        if name is None:
            return self._err(405, "MethodNotAllowed", "collection delete unsupported")
        with self.state.lock:
            key = self._key(kind, ns, name)
            existing = self.state.objects.pop(key, None)
            if existing is None:
                return self._err(404, "NotFound", f"{kind} {name!r} not found")
            existing["metadata"]["resourceVersion"] = str(self.state.next_rv())
            self.state.record("DELETED", kind, existing)
            self._cascade(existing["metadata"].get("uid"))
            self._send_json(200, existing)

    def _cascade(self, owner_uid: str | None) -> None:
        """Server-side garbage collection: objects owner-referencing a
        deleted uid go too (what the real GC controller does; the operator
        stamps StatefulSets/Services with their Agent CR as owner).
        Caller holds the state lock."""
        if not owner_uid:
            return
        doomed = [
            (key, obj) for key, obj in self.state.objects.items()
            if any(
                ref.get("uid") == owner_uid
                for ref in (obj.get("metadata") or {}).get("ownerReferences", [])
            )
        ]
        for key, obj in doomed:
            del self.state.objects[key]
            obj["metadata"]["resourceVersion"] = str(self.state.next_rv())
            self.state.record("DELETED", key[0], obj)
            self._cascade(obj["metadata"].get("uid"))


class FakeKubeApiServer:
    """Run the fake API server on an ephemeral localhost port."""

    def __init__(self) -> None:
        self.state = _State()
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.port = 0

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "FakeKubeApiServer":
        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        self._httpd.state = self.state  # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def __enter__(self) -> "FakeKubeApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

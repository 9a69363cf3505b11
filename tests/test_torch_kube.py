"""The port's kube API client, embedded API server and spec differ against
the JAX package's: one sequence of creates, replaces, status writes,
deletes (with the owner-reference cascade) and watches gives the same
objects and events in both packages' ``InMemoryKubeApi``; through
``HttpKubeApi`` it gives the same objects, resource versions, 404s, 409s
and watch events with every pairing of client and server (the port's client
on the JAX server, the JAX client on the port's, each on its own); and
``diff.specs_equal``/``diff_paths`` answer alike."""

import json
import threading

import pytest

import langstream_tpu.k8s.apiserver as jax_apiserver
import langstream_tpu.k8s.client as jax_client
import langstream_tpu.k8s.diff as jax_diff
import langstream_tpu_torch.k8s.apiserver as port_apiserver
import langstream_tpu_torch.k8s.client as port_client
import langstream_tpu_torch.k8s.diff as port_diff

CLIENTS = {"jax": jax_client, "port": port_client}
SERVERS = {"jax": jax_apiserver, "port": port_apiserver}


def _ns(name):
    return {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": name}}


def _agent(name, spec):
    return {"apiVersion": "langstream.tpu/v1alpha1", "kind": "Agent",
            "metadata": {"name": name, "namespace": "langstream-t1",
                         "labels": {"langstream-application": "app"}},
            "spec": spec}


def _sts(name, owner=None):
    meta = {"name": name, "namespace": "langstream-t1",
            "labels": {"langstream-application": "app", "langstream-agent": name}}
    if owner is not None:
        meta["ownerReferences"] = [{"kind": "Agent", "name": owner["metadata"]["name"],
                                    "uid": owner["metadata"]["uid"], "controller": True}]
    return {"apiVersion": "apps/v1", "kind": "StatefulSet", "metadata": meta,
            "spec": {"replicas": 1, "template": {"spec": {"containers": []}}}}


def _strip(obj):
    """An object without what the server makes up per run (uids, times)."""
    if not isinstance(obj, dict):
        return obj
    obj = json.loads(json.dumps(obj))
    meta = obj.get("metadata") or {}
    meta.pop("uid", None)
    meta.pop("creationTimestamp", None)
    for ref in meta.get("ownerReferences", []):
        ref.pop("uid", None)
    return obj


def _sequence(api, http: bool):
    """The same calls on any ``KubeApi``; what each answered, in order."""
    out = []

    def note(label, fn):
        try:
            result = fn()
        except Exception as e:  # the class's name is what both packages share
            out.append((label, "raises", type(e).__name__))
            return None
        out.append((label, _strip(result) if isinstance(result, dict) else
                    [_strip(o) for o in result] if isinstance(result, list) else result))
        return result

    if http:  # a namespaced create needs its namespace (404 before)
        note("create in a missing namespace", lambda: api.apply(_agent("early", {"a": 1})))
    note("namespace", lambda: api.apply(_ns("langstream-t1")))
    agent = note("agent", lambda: api.apply(_agent("chat", {"agentId": "chat", "n": 1})))
    note("replace", lambda: api.apply(_agent("chat", {"agentId": "chat", "n": 2})))
    note("status", lambda: api.update_status({**agent, "status": {"status": "DEPLOYING"}}))
    note("replace keeps status", lambda: api.apply(_agent("chat", {"agentId": "chat", "n": 3})))
    agent = api.get("Agent", "langstream-t1", "chat")
    note("owned sts", lambda: api.apply(_sts("chat", owner=agent)))
    note("free sts", lambda: api.apply(_sts("other")))
    note("list by label", lambda: api.list("StatefulSet", "langstream-t1",
                                           label_selector={"langstream-agent": "chat"}))
    note("get missing", lambda: api.get("Agent", "langstream-t1", "nope"))
    note("status of missing", lambda: api.update_status(
        {**_agent("nope", {}), "status": {"status": "X"}}))
    note("delete cascades", lambda: api.delete("Agent", "langstream-t1", "chat"))
    note("owned sts gone", lambda: api.get("StatefulSet", "langstream-t1", "chat"))
    note("delete missing", lambda: api.delete("Agent", "langstream-t1", "chat"))
    note("left", lambda: sorted(o["metadata"]["name"]
                                for o in api.list("StatefulSet", "langstream-t1")))
    return out


@pytest.mark.parametrize("side", sorted(CLIENTS))
def test_in_memory_apis_answer_alike(side):
    jax_api = jax_client.InMemoryKubeApi()
    api = CLIENTS[side].InMemoryKubeApi()
    assert _sequence(api, http=False) == _sequence(jax_api, http=False)
    assert api.events == jax_api.events
    assert api.applied("Agent") == ["chat", "chat", "chat"]


def _served(server_side):
    return SERVERS[server_side].FakeKubeApiServer().start()


PAIRS = [(c, s) for c in sorted(CLIENTS) for s in sorted(SERVERS)]


@pytest.mark.parametrize("client_side,server_side", PAIRS)
def test_http_clients_and_servers_interoperate(client_side, server_side):
    """Each client against each server: the sequence's answers (resource
    versions included) equal the JAX client's on the JAX server; a stale
    replace is a 409 and a create in a missing namespace a 404 through
    both clients' error classes."""
    reference = _served("jax")
    server = _served(server_side)
    try:
        want = _sequence(jax_client.HttpKubeApi(reference.url), http=True)
        api = CLIENTS[client_side].HttpKubeApi(server.url)
        assert _sequence(api, http=True) == want
        assert want[0] == ("create in a missing namespace", "raises", "KubeNotFoundError")
        stale = api.get("StatefulSet", "langstream-t1", "other")
        api.apply(_sts("other"))  # bumps the resource version
        client = CLIENTS[client_side]
        with pytest.raises(client.KubeConflictError):
            api._request("PUT", api._url("StatefulSet", "langstream-t1", "other"), stale)
        with pytest.raises(client.KubeConflictError):
            api._request("POST", api._url("StatefulSet", "langstream-t1"), _sts("other"))
    finally:
        server.stop()
        reference.stop()


@pytest.mark.parametrize("client_side,server_side", PAIRS)
def test_watches_stream_the_writes_in_order(client_side, server_side):
    server = _served(server_side)
    try:
        api = CLIENTS[client_side].HttpKubeApi(server.url)
        api.apply(_ns("langstream-t1"))
        start = api.get("Namespace", None, "langstream-t1")["metadata"]["resourceVersion"]
        events = []

        def watch():
            for event, obj in api.watch("Agent", "langstream-t1", resource_version=start,
                                        timeout_s=3):
                events.append((event, obj["metadata"]["name"], obj["spec"].get("n"),
                               obj["metadata"]["resourceVersion"]))
                if event == "DELETED":
                    return

        thread = threading.Thread(target=watch)
        thread.start()
        api.apply(_agent("w", {"n": 1}))
        api.apply(_agent("w", {"n": 2}))
        api.delete("Agent", "langstream-t1", "w")
        thread.join(10)
        assert [e[:3] for e in events] == [("ADDED", "w", 1), ("MODIFIED", "w", 2),
                                           ("DELETED", "w", 2)]
        versions = [int(e[3]) for e in events]
        assert versions == sorted(versions) and versions[0] > int(start)
    finally:
        server.stop()


SPECS = [
    ({}, None), ({"a": None}, {}), ({"a": {}}, {"a": None}), ({"a": [1, {}]}, {"a": [1, None]}),
    ({"a": 1}, {"a": 2}), ({"a": [1]}, {"a": [1, 2]}), ({"a": {"b": 1}}, {"a": {"b": 1, "c": 2}}),
    ({"x": {"y": [{"z": 1}]}}, {"x": {"y": [{"z": 1}]}}), ("s", "s"), (1, 1.0),
]


@pytest.mark.parametrize("a,b", SPECS)
def test_spec_diffs_answer_alike(a, b):
    assert port_diff.specs_equal(a, b) == jax_diff.specs_equal(a, b)
    assert port_diff.diff_paths(a, b) == jax_diff.diff_paths(a, b)
    old, new = {"image": "i", "resources": a}, {"image": "i", "resources": b}
    assert port_diff.agent_needs_restart(old, new) == jax_diff.agent_needs_restart(old, new)


def test_resource_limits_answer_alike():
    agents = {"app-1": [{"resources": {"parallelism": 2, "size": 2}}],
              "app-2": [{"resources": {}}]}
    for cls in (port_diff.ResourceLimitsChecker, jax_diff.ResourceLimitsChecker):
        cls(10).check(agents, "app-3", [{"resources": {"parallelism": 5}}])
        with pytest.raises(ValueError, match="tenant quota exceeded: 5 units in use"):
            cls(6).check(agents, "app-3", [{"resources": {"parallelism": 2}}])

"""The port's sidecar lane (``langstream_tpu_torch/grpc``: the ``grpc-*``
agents, the sidecar server, the port's HTTP/2 transport) against the JAX
package's on grpcio:

- every case of ``tests/test_grpc_agents.py`` run against the port (its
  imports pointed at ``langstream_tpu_torch``): the processor, source and
  sink over an in-process server, structured values, the topic-producer
  acks and a failed publish, a real sidecar subprocess in a pipeline, and
  the sidecar killed and restarted;
- an interop matrix: for each of the five RPCs (``agent_info``,
  ``process`` with a 1 MiB record, ``read`` with commits, ``write`` with a
  refusal, ``topic_producer_records`` acked and failed) the port's client
  against the JAX server (grpcio) and the JAX client against the port's
  server give what the JAX client gives against the JAX server;
- grpcio's ``-bin`` metadata, which it writes in Huffman code, reaching a
  port server and a port client's reaching a grpcio server, values intact,
  and a grpcio status with a percent-encoded message read by the port;
- a sidecar source into a sidecar sink through each package's runner:
  the port's commits every record read, the JAX runner none (its trait).
"""

import asyncio
import inspect
import textwrap
import types
from pathlib import Path

import grpc
import pytest

import langstream_tpu.grpc.client as jax_client
import langstream_tpu.grpc.server as jax_server
import langstream_tpu_torch.grpc.client as port_client
import langstream_tpu_torch.grpc.server as port_server
from langstream_tpu.api.record import make_record as jax_make_record
from langstream_tpu_torch.api.record import make_record as port_make_record
from langstream_tpu_torch.grpc import h2, hpack

REPO = Path(__file__).resolve().parents[1]


def _port_cases() -> types.ModuleType:
    """``tests/test_grpc_agents.py`` with every ``langstream_tpu`` import
    pointed at the port."""
    path = REPO / "tests" / "test_grpc_agents.py"
    source = path.read_text().replace("langstream_tpu.", "langstream_tpu_torch.")
    module = types.ModuleType("_port_grpc_agent_cases")
    module.__file__ = str(path)
    exec(compile(source, str(path), "exec"), module.__dict__)
    return module


CASES = _port_cases()
user_module = CASES.user_module          # the cases' fixtures
producer_module = CASES.producer_module


@pytest.mark.parametrize("name", sorted(n for n in dir(CASES) if n.startswith("test_")))
def test_the_jax_grpc_cases_pass_on_the_port(name, request):
    case = getattr(CASES, name)
    kwargs = {p: asyncio.run if p == "run_async" else request.getfixturevalue(p)
              for p in inspect.signature(case).parameters}
    case(**kwargs)


# ---------------------------------------------------------------------------
# the interop matrix
# ---------------------------------------------------------------------------

AGENTS = '''
class Exclaim:
    def init(self, config):
        self.suffix = config.get("suffix", "!")

    def process(self, record):
        if record.value == "boom":
            raise ValueError("kaboom")
        return [(record.value + self.suffix, record.key, {"seen": True, "n": len(record.value)})]

    def agent_info(self):
        return {"kind": "exclaimer", "sizes": [1, 2]}


class Counter:
    def init(self, config):
        self.n = 0
        self.committed = []

    def read(self):
        import time
        if self.n >= 3:
            time.sleep(0.05)
            return []
        self.n += 1
        return [({"item": self.n}, b"k%d" % self.n, {"h": self.n})]

    def commit(self, records):
        self.committed.extend(r.value["item"] for r in records)


class Collector:
    sunk = []

    def write(self, record):
        if record.value == "reject":
            raise RuntimeError("rejected")
        Collector.sunk.append((record.value, record.key))


class SideWriter:
    def set_context(self, ctx):
        self.ctx = ctx

    async def process(self, record):
        producer = self.ctx.get_topic_producer("side")
        await producer.write((record.value + "-side", None, {"from": "sidecar"}))
        return [(record.value + "-done", None, None)]
'''


@pytest.fixture()
def interop_dir(tmp_path):
    (tmp_path / "python").mkdir()
    (tmp_path / "python" / "interopagents.py").write_text(textwrap.dedent(AGENTS))
    return tmp_path


SIDES = {"port": (port_client, port_server.AgentServer, port_make_record),
         "jax": (jax_client, jax_server.AgentServer, jax_make_record)}


class _Sink:
    def __init__(self):
        self.results, self.errors = [], []

    def emit(self, result):
        self.results.append(result)

    def emit_error(self, source, error):
        self.errors.append((source, error))


class _Context:
    def __init__(self, fail: bool = False):
        self.written, self.fail = [], fail

    def get_topic_producer(self, topic):
        ctx = self

        class _Handle:
            async def write(self, record):
                if ctx.fail:
                    raise RuntimeError("broker down")
                ctx.written.append((topic, record.value, list(record.headers)))

        return _Handle()

    def critical_failure(self, error):
        pass


async def _until(predicate, tries: int = 200):
    for _ in range(tries):
        if predicate():
            return
        await asyncio.sleep(0.05)


async def _rpc_agent_info(client, make, endpoint, server):
    agent = client.GrpcAgentProcessor()
    await agent.init({"endpoint": endpoint})
    await agent.start()
    info = await agent.fetch_agent_info()
    await agent.close()
    return info


async def _rpc_process(client, make, endpoint, server):
    agent = client.GrpcAgentProcessor()
    await agent.init({"endpoint": endpoint})
    await agent.start()
    sink = _Sink()
    big = "x" * (1 << 20)
    agent.process([make(value="hello", key="k"), make(value="boom"), make(value=big)], sink)
    await _until(lambda: len(sink.results) >= 2 and sink.errors)
    await agent.close()
    results = sorted(
        (r.source_record.value[:8],
         [(o.value[:8], len(o.value), o.key, dict(o.headers)) for o in r.results])
        for r in sink.results)
    return results, [(s.value, str(e)) for s, e in sink.errors]


async def _rpc_read(client, make, endpoint, server):
    agent = client.GrpcAgentSource()
    await agent.init({"endpoint": endpoint})
    await agent.start()
    got = []
    for _ in range(50):
        got.extend(await agent.read())
        if len(got) >= 3:
            break
    await agent.commit(got[:2])
    await _until(lambda: len(server.service.delegate.committed) >= 2)
    await agent.close()
    return [(r.value, r.key, dict(r.headers)) for r in got], server.service.delegate.committed


async def _rpc_write(client, make, endpoint, server):
    agent = client.GrpcAgentSink()
    await agent.init({"endpoint": endpoint})
    await agent.start()
    await agent.write(make(value="ok-1", key=b"\x00\x01"))
    await agent.write(make(value={"q": "hi", "n": [1, 2.5, None]}, headers={"meta": {"a": 1}}))
    try:
        await agent.write(make(value="reject"))
        refused = None
    except RuntimeError as e:
        refused = str(e)
    await agent.close()
    return list(server.service.delegate.sunk), refused


async def _rpc_topic_producer_records(client, make, endpoint, server):
    out = []
    for fail in (False, True):
        agent = client.GrpcAgentProcessor()
        await agent.init({"endpoint": endpoint})
        await agent.setup(_Context(fail))
        await agent.start()
        sink = _Sink()
        agent.process([make(value="a")], sink)
        await _until(lambda: sink.results or sink.errors)
        out.append(([[o.value for o in r.results] for r in sink.results],
                    [str(e) for _, e in sink.errors], agent.context.written))
        await agent.close()
    return out


RPCS = {"agent_info": ("Exclaim", _rpc_agent_info), "process": ("Exclaim", _rpc_process),
        "read": ("Counter", _rpc_read), "write": ("Collector", _rpc_write),
        "topic_producer_records": ("SideWriter", _rpc_topic_producer_records)}


def _run_pair(client_side: str, server_side: str, rpc: str, app_dir: Path):
    class_name, scenario = RPCS[rpc]
    client = SIDES[client_side][0]
    server_cls = SIDES[server_side][1]
    make = SIDES[client_side][2]
    config = {"className": f"interopagents.{class_name}", "suffix": "?!",
              "__application_directory__": str(app_dir)}

    async def main():
        server = server_cls(config)
        port = await server.start()
        try:
            return await asyncio.wait_for(
                scenario(client, make, f"127.0.0.1:{port}", server), 60)
        finally:
            await server.stop(1)

    return asyncio.run(main())


@pytest.mark.parametrize("pair", [("port", "jax"), ("jax", "port")],
                         ids=["port-client-jax-server", "jax-client-port-server"])
@pytest.mark.parametrize("rpc", list(RPCS))
def test_each_rpc_interoperates_with_grpcio_as_jax_with_jax(rpc, pair, interop_dir):
    want = _run_pair("jax", "jax", rpc, interop_dir)
    got = _run_pair(*pair, rpc, interop_dir)
    assert got == want
    assert want  # the scenario ran


def test_grpcio_bin_metadata_in_huffman_code_crosses_to_the_port_and_back(monkeypatch):
    decoded = []
    huffman_decode = hpack.huffman_decode

    def counting(data):
        decoded.append(len(data))
        return huffman_decode(data)

    monkeypatch.setattr(hpack, "huffman_decode", counting)
    blob = bytes(range(64))

    async def main():
        async def echo(request, context):
            metadata = dict(context.invocation_metadata())
            return metadata["trace-bin"] + metadata["x-user"].encode() + request

        server = h2.Server({"/t.S/echo": h2.rpc_method_handler("unary_unary", echo)})
        port = await server.start()
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as channel:
            to_port = await channel.unary_unary("/t.S/echo")(
                b"!", metadata=[("trace-bin", blob), ("x-user", "hello world")])
        await server.stop(1)

        async def echo2(request, context):
            metadata = dict(context.invocation_metadata())
            context.set_trailing_metadata((("trail-bin", b"\x03\x04"),))
            return metadata["trace-bin"] + request

        async def fail(request, context):
            await context.abort(grpc.StatusCode.NOT_FOUND, "gone: 100% ünicode")

        grpc_server = grpc.aio.server()
        grpc_server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler("t.S", {
            "echo": grpc.unary_unary_rpc_method_handler(echo2),
            "fail": grpc.unary_unary_rpc_method_handler(fail)}),))
        grpc_port = grpc_server.add_insecure_port("127.0.0.1:0")
        await grpc_server.start()
        channel = h2.insecure_channel(f"127.0.0.1:{grpc_port}")
        to_grpc = await channel.unary_unary("/t.S/echo")(b"?", metadata=[("trace-bin", blob)])
        try:
            await channel.unary_unary("/t.S/fail")(b"")
            status = None
        except h2.RpcError as e:
            status = (e.code(), e.details())
        await channel.close()
        await grpc_server.stop(0)
        return to_port, to_grpc, status

    to_port, to_grpc, status = asyncio.run(main())
    assert to_port == blob + b"hello world!"
    assert to_grpc == blob + b"?"
    assert status == (h2.StatusCode.NOT_FOUND, "gone: 100% ünicode")
    assert decoded, "grpcio sent no Huffman-coded string"



SOURCE_SINK = '''
import time


class Numbers:
    def init(self, config):
        self.left, self.out, self.n = int(config["count"]), config["out"], 0

    def read(self):
        if not self.left:
            time.sleep(0.05)
            return []
        self.left -= 1
        self.n += 1
        return [({"n": self.n}, None, None)]

    def commit(self, records):
        with open(self.out + ".committed", "a") as f:
            f.writelines(f"{r.value['n']}\\n" for r in records)


class Store:
    def init(self, config):
        self.out = config["out"]

    def write(self, record):
        with open(self.out + ".sunk", "a") as f:
            f.write(f"{record.value['n']}\\n")
'''
SOURCE_SINK_PIPELINE = """
topics:
  - name: "numbers"
    creation-mode: create-if-not-exists
pipeline:
  - name: "source"
    type: "grpc-python-source"
    output: "numbers"
    configuration: {className: "sourcesink.Numbers", count: 12, out: "%s"}
  - name: "sink"
    type: "grpc-python-sink"
    input: "numbers"
    configuration: {className: "sourcesink.Store", out: "%s"}
"""


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_sidecar_source_s_reads_are_committed_through_the_runner(package, tmp_path):
    """A ``grpc-python-source`` into a ``grpc-python-sink``, both sidecar
    subprocesses: through the port's runner every record read is written
    and committed; the JAX runner commits the trace-stamped copies, which
    the source does not know, so its sidecar sees no commit (a kept JAX
    trait, ROADMAP Queue 3 item 28)."""
    import time

    import yaml

    if package == "port":
        from langstream_tpu_torch.runtime.local_runner import LocalApplicationRunner
    else:
        from langstream_tpu.runtime.local_runner import LocalApplicationRunner
    app = tmp_path / "app"
    (app / "python").mkdir(parents=True)
    (app / "python" / "sourcesink.py").write_text(SOURCE_SINK)
    out = tmp_path / "out"
    (app / "pipeline.yaml").write_text(SOURCE_SINK_PIPELINE % (out, out))
    instance = yaml.safe_dump({"instance": {"streamingCluster": {
        "type": "memory", "configuration": {"cluster": f"sourcesink-{package}"}}}})
    sunk, committed = Path(f"{out}.sunk"), Path(f"{out}.committed")

    async def main():
        async with LocalApplicationRunner.from_directory(app, instance=instance):
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if sunk.exists() and len(sunk.read_text().split()) == 12 and (
                        package == "jax" or committed.exists()
                        and len(committed.read_text().split()) == 12):
                    break
                await asyncio.sleep(0.1)
            await asyncio.sleep(0.5)  # a late commit would land by now

    asyncio.run(main())
    assert sorted(int(n) for n in sunk.read_text().split()) == list(range(1, 13))
    if package == "port":
        assert sorted(int(n) for n in committed.read_text().split()) == list(range(1, 13))
    else:
        assert not committed.exists()

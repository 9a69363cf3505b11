"""The slice end to end, each package under its own runner:

- ``long-context-summarizer``, its ``mesh`` removed in both packages and its
  resource at the tiny model (the in-repo HF fixture, both engines load the
  same weights) in f32 with greedy decoding, everything else as the example
  has it (paged KV, 8 slots, ``speculative-drafts: 4``, ``max-tokens:
  256``): a PDF, a compressed PDF, a docx, HTML and plain text produced as
  bytes to ``documents-in``; the summaries on ``summaries-out`` are equal;
- ``s3-document-ingestion`` against the JAX tests' ``FakeS3`` (loaded by
  path): equal chunks on ``chunks-topic`` and the bucket emptied on commit;
- ``flare-controller``: equal routing of confident and uncertain records.

Partitions are picked by ``hash(key)``, which Python salts per process, so
records are compared by their key, never by the partition they landed in."""

import asyncio
import importlib.util
import itertools
import math
from pathlib import Path

import pytest
import yaml

import langstream_tpu.agents  # noqa: F401  (registers the JAX types)
import langstream_tpu.runtime.local_runner as jax_local
import langstream_tpu_torch.agents  # noqa: F401  (registers the port's types)
import langstream_tpu_torch.runtime.local_runner as port_local
from langstream_tpu.agents import ai as jax_ai
from langstream_tpu.api.record import make_record as jax_make_record
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.agents import ai as port_ai
from langstream_tpu_torch.api.record import make_record
from langstream_tpu_torch.serving.engine import TorchServingEngine

REPO = Path(__file__).resolve().parents[1]
APPS = REPO / "examples" / "applications"
FIXTURE = str(REPO / "tests" / "fixtures" / "llama_tiny_golden")
#: headers that differ by run: the broker's offset objects and trace ids
VARYING = ("__offset", "langstream-trace")
RUNNERS = {"jax": jax_local.LocalApplicationRunner, "port": port_local.LocalApplicationRunner}
_CLUSTERS = itertools.count()


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", REPO / "tests" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PDF = _load("test_pdftext")


def _instance(cluster: str) -> str:
    text = (REPO / "examples" / "instances" / "memory.yaml").read_text()
    return text.replace('type: "memory"', f'type: "memory"\n    configuration: {{cluster: "{cluster}"}}')


def summarizer_at_tiny(target: Path) -> Path:
    """A copy of ``long-context-summarizer``: its resource without ``mesh``,
    at the tiny fixture in f32 (no ``quantize``); the pipeline as it is."""
    source = APPS / "long-context-summarizer"
    target.mkdir(parents=True)
    (target / "pipeline.yaml").write_text((source / "pipeline.yaml").read_text())
    config = yaml.safe_load((source / "configuration.yaml").read_text())
    resource = config["configuration"]["resources"][0]["configuration"]
    del resource["mesh"], resource["quantize"]
    resource.update({"model": "tiny", "model-dtype": "float32", "checkpoint": FIXTURE,
                     "seed": 0})
    (target / "configuration.yaml").write_text(yaml.safe_dump(config))
    return target


def _documents() -> dict[str, bytes]:
    words = "alpha beta gamma delta epsilon zeta eta theta iota kappa".split()
    texts = [" ".join(words[(i * 3 + j) % len(words)] for j in range(40 + 9 * i))
             for i in range(5)]
    pdf = (b"BT /F1 12 Tf 72 700 Td (" + texts[0].encode() + b") Tj T* "
           b"[(kerned ) -120 (line)] TJ ET\n")
    ns = "http://schemas.openxmlformats.org/wordprocessingml/2006/main"
    docx = PDF._ooxml("docx", {"word/document.xml": (
        f'<w:document xmlns:w="{ns}"><w:body><w:p><w:r><w:t>{texts[2]}</w:t></w:r></w:p>'
        "<w:p><w:r><w:t>Second paragraph.</w:t></w:r></w:p></w:body></w:document>")})
    return {
        "doc-pdf": PDF._pdf_with_stream(pdf, False),
        "doc-pdf-flate": PDF._pdf_with_stream(pdf.replace(b"alpha", b"ALPHA"), True),
        "doc-docx": docx,
        "doc-html": f"<html><head><style>x{{}}</style></head><body><h1>Title</h1><p>{texts[3]}"
                    f"</p><script>no()</script></body></html>".encode(),
        "doc-text": texts[4].encode(),
    }


async def _close_engines():
    for cls in (TorchServingEngine, TpuServingEngine):
        engines = list(cls._instances.values())
        cls.reset_instances()
        for engine in engines:
            await engine.close()


def test_long_context_summarizer_equals_the_jax_runner(tmp_path, monkeypatch):
    from langstream_tpu_torch.agents import services as port_services

    monkeypatch.setattr(port_services, "SERVING_DEVICE", "cpu")
    app = summarizer_at_tiny(tmp_path / "app")
    documents = _documents()

    async def run(name):
        runner = RUNNERS[name].from_directory(
            app, instance=_instance(f"summarize-{name}-{next(_CLUSTERS)}"))
        try:
            async with runner:
                for key, data in documents.items():
                    await runner.produce("documents-in", data, key=key)
                out = await runner.wait_for_messages("summaries-out", len(documents), timeout=600)
        finally:
            await _close_engines()
        return {r.key: r.value for r in out}

    jax, port = asyncio.run(run("jax")), asyncio.run(run("port"))
    assert port == jax
    assert set(port) == set(documents)
    # the completion replaces the extracted text (a string value) with
    # ``{"summary": ...}``, as in the JAX package
    assert all(set(v) == {"summary"} and isinstance(v["summary"], str) for v in port.values())
    assert any(v["summary"] for v in port.values())


@pytest.mark.parametrize("files", [2, 5])
def test_s3_document_ingestion_equals_the_jax_runner(tmp_path, files):
    storage = _load("test_object_storage")
    documents = _documents()
    names = sorted(documents)[:files]

    async def run(name):
        fake = await storage.FakeS3().start()
        try:
            fake.buckets["docs"] = {f"{n}.{'pdf' if 'pdf' in n else 'txt'}": documents[n]
                                    for n in names}
            secrets = yaml.safe_dump({"secrets": [{"id": "s3", "name": "s3", "data": {
                "bucket": "docs", "endpoint": f"http://127.0.0.1:{fake.port}",
                "access-key": "ak", "secret": "sk"}}]})
            runner = RUNNERS[name].from_directory(
                APPS / "s3-document-ingestion",
                instance=_instance(f"s3-{name}-{next(_CLUSTERS)}"), secrets=secrets)
            async with runner:
                chunks = []
                for _ in range(200):
                    chunks = await runner.wait_for_messages("chunks-topic", 1, timeout=5)
                    keys = {c.key for c in chunks}
                    if len(keys) == files and not fake.buckets["docs"]:
                        break
                    await asyncio.sleep(0.05)
            return (sorted((c.key, c.value, sorted((k, v) for k, v in c.headers
                                                   if k not in VARYING)) for c in chunks),
                    fake.buckets["docs"], sorted(set(fake.requests)))
        finally:
            await fake.stop()

    jax, port = asyncio.run(run("jax")), asyncio.run(run("port"))
    assert port == jax
    chunks, left, _ = port
    assert {key for key, *_ in chunks} == {f"{n}.{'pdf' if 'pdf' in n else 'txt'}"
                                          for n in names}
    assert left == {}
    assert all(value == value.lower() for _, value, _ in chunks)


FLARE_CASES = [
    {"tokens": ["a", "b", "c"], "logprobs": [-0.1, -0.2, -0.05]},
    {"tokens": ["a", "b", "c"], "logprobs": [-0.1, math.log(0.1), -3.0]},
    {"tokens": ["x"], "logprobs": [-1.0]},
    {"tokens": [], "logprobs": []},
    {"question": "no tokens at all"},
]


@pytest.mark.parametrize("config", [{}, {"min-prob": 0.5, "loop-topic": "again",
                                         "tokens-field": "value.t", "logprobs-field": "value.l"}])
def test_flare_controller_routes_as_the_jax_agent(config):
    def process(module, make, value):
        agent = module.FlareControllerAgent()

        async def main():
            await agent.init(config)
            out = await agent.process_record(make(value=value, key="k", headers={"s": "1"}))
            return [(r.value, r.key, list(r.headers)) for r in out]

        return asyncio.run(main())

    for case in FLARE_CASES:
        value = dict(case)
        if config:
            value = {("t" if k == "tokens" else "l" if k == "logprobs" else k): v
                     for k, v in case.items()}
        port = process(port_ai, make_record, dict(value))
        assert port == process(jax_ai, jax_make_record, dict(value))
        routed = any(k == "langstream-destination-topic" for k, _ in port[0][2])
        assert routed == ("flare_uncertain_spans" in port[0][0])

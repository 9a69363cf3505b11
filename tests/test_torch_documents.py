"""The port's document agents and ``camel-source`` against the JAX package's,
on the same inputs:

- ``pdftext``: PDF content streams (raw and compressed), a PDF without
  text, docx, pptx and xlsx, built by ``tests/test_pdftext.py``'s helpers
  (loaded by path, unedited): equal text and equal kinds;
- ``text-extractor`` and ``text-normaliser`` on bytes, strings, HTML and
  JSON values, and under each normaliser option: equal records (whichever
  PDF branch runs, ``pypdf`` or ``pdftext``, it is the same in both);
- ``camel-source``: every case of ``tests/test_camel.py`` run against the
  port's module, and equal records from both packages' ``file:`` and
  ``timer:`` routes;
- the planners: a bad camel URI is refused at planning by both, with the
  same message, and a good one plans equally."""

import asyncio
import importlib.util
import inspect
import json
import os
from pathlib import Path

import pytest

import langstream_tpu.agents  # noqa: F401  (registers the JAX types)
import langstream_tpu_torch.agents  # noqa: F401  (registers the port's types)
from langstream_tpu.agents import camel as jax_camel
from langstream_tpu.agents import pdftext as jax_pdftext
from langstream_tpu.agents import text as jax_text
from langstream_tpu.api.record import make_record as jax_make_record
from langstream_tpu.core.deployer import ApplicationDeployer as JaxDeployer
from langstream_tpu.core.parser import build_application_from_files as jax_parse
from langstream_tpu.core.planner import PlanningError as JaxPlanningError
from langstream_tpu_torch.agents import camel, pdftext, text
from langstream_tpu_torch.api.record import make_record
from langstream_tpu_torch.core.deployer import ApplicationDeployer
from langstream_tpu_torch.core.parser import build_application_from_files as parse
from langstream_tpu_torch.core.planner import PlanningError

REPO = Path(__file__).resolve().parents[1]


def _load(name: str, **rebind):
    """``tests/<name>.py`` as a module of its own, with ``rebind``'s names
    pointed elsewhere (its functions read them from its globals)."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}_{len(rebind)}",
                                                  REPO / "tests" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for key, value in rebind.items():
        setattr(module, key, value)
    return module


PDF = _load("test_pdftext")
WORD = "http://schemas.openxmlformats.org/wordprocessingml/2006/main"
DRAWING = "http://schemas.openxmlformats.org/drawingml/2006/main"
SHEET = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"


def _docx(*paragraphs: str) -> bytes:
    body = "".join(f"<w:p><w:r><w:t xml:space=\"preserve\">{p}</w:t></w:r></w:p>"
                   for p in paragraphs)
    return PDF._ooxml("docx", {"word/document.xml":
                               f'<w:document xmlns:w="{WORD}"><w:body>{body}</w:body></w:document>'})


DOCUMENTS = {
    "pdf": PDF._pdf_with_stream(PDF.CONTENT, False),
    "pdf-flate": PDF._pdf_with_stream(PDF.CONTENT, True),
    "pdf-image": PDF._pdf_with_stream(b"\x00\x01\x02 binary image bytes \xff", False),
    "docx": _docx("First paragraph", " continues.", "Second <b>paragraph</b>."),
    "pptx": PDF._ooxml("pptx", {
        "ppt/slides/slide1.xml": f'<p:sld xmlns:a="{DRAWING}" xmlns:p="urn:p"><p:txBody>'
                                 "<a:p><a:r><a:t>Slide title</a:t></a:r></a:p></p:txBody></p:sld>",
        "ppt/slides/slide2.xml": f'<p:sld xmlns:a="{DRAWING}" xmlns:p="urn:p"><p:txBody>'
                                 "<a:p><a:r><a:t>Bullet one</a:t></a:r></a:p></p:txBody></p:sld>"}),
    "xlsx": PDF._ooxml("xlsx", {"xl/sharedStrings.xml": f'<sst xmlns="{SHEET}"><si><t>cell a</t>'
                                                         "</si><si><t>cell b</t></si></sst>"}),
    "zip-not-ooxml": PDF._ooxml("docx", {"other.xml": "<x/>"}),
    "html-bytes": b"<html><head><title>t</title><style>p{}</style></head><body><h1>Head</h1>"
                  b"<p>Para <b>bold</b> one.</p><script>var x;</script></body></html>",
    "plain-bytes": "Plain café text\nsecond line".encode(),
    "bad-utf8": b"caf\xe9 \xff\xfe bytes",
}
VALUES = {
    "html-str": "<HTML><body><p>Upper</p>  <div>case tags</div></body></HTML>",
    "body-only": "<body>just a body</body>",
    "plain-str": "  nothing to extract  ",
    "dict": {"a": 1, "b": [1, 2]},
    "none": None,
}


@pytest.mark.parametrize("name", sorted(DOCUMENTS))
def test_pdftext_equals_the_jax_module(name):
    raw = DOCUMENTS[name]
    assert pdftext.sniff_ooxml_kind(raw) == jax_pdftext.sniff_ooxml_kind(raw)
    assert pdftext.extract_pdf_text(raw) == jax_pdftext.extract_pdf_text(raw)
    kind = jax_pdftext.sniff_ooxml_kind(raw)
    if kind is not None:
        assert pdftext.extract_ooxml_text(raw, kind) == jax_pdftext.extract_ooxml_text(raw, kind)


@pytest.mark.parametrize("name", [n for n in dir(PDF) if n.startswith("test_")
                                  and n != "test_text_extractor_agent_routes_binary_formats"])
def test_the_jax_pdftext_cases_pass_on_the_port(name):
    module = _load("test_pdftext", extract_pdf_text=pdftext.extract_pdf_text,
                   extract_ooxml_text=pdftext.extract_ooxml_text,
                   sniff_ooxml_kind=pdftext.sniff_ooxml_kind)
    fn = getattr(module, name)
    marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
    for args in (marks[0].args[1] if marks else [None]):
        fn(args) if marks else fn()


def _process(module, make, cls: str, config: dict, value):
    agent = getattr(module, cls)()
    asyncio.run(agent.init(config)) if inspect.iscoroutinefunction(agent.init) else (
        agent.init(config))
    record = make(value=value, key="k", headers={"h": "1"})
    out = asyncio.run(agent.process_record(record))
    return [(r.value, r.key, tuple(r.headers)) for r in out]


@pytest.mark.parametrize("name", sorted(DOCUMENTS) + sorted(VALUES))
def test_text_extractor_equals_the_jax_agent(name):
    value = DOCUMENTS.get(name, VALUES.get(name))
    got = _process(text, make_record, "TextExtractorAgent", {}, value)
    assert got == _process(jax_text, jax_make_record, "TextExtractorAgent", {}, value)
    assert isinstance(got[0][0], str)


NORMALISER_CONFIGS = [{}, {"make-lowercase": False}, {"trim-spaces": False},
                      {"unicode-normalisation": "NFKC"},
                      {"make-lowercase": False, "trim-spaces": False,
                       "unicode-normalisation": "NFD"}]
NORMALISER_TEXTS = ["  Hello   WORLD \t tabs\n\n  Second\tLine  ", "ﬁne Été ①",
                    b"Bytes  VALUE", {"k": "V  W"}]


@pytest.mark.parametrize("config", NORMALISER_CONFIGS, ids=json.dumps)
def test_text_normaliser_equals_the_jax_agent(config):
    for value in NORMALISER_TEXTS:
        assert (_process(text, make_record, "TextNormaliserAgent", config, value)
                == _process(jax_text, jax_make_record, "TextNormaliserAgent", config, value))


# ---------------------------------------------------------------------------
# camel-source
# ---------------------------------------------------------------------------

CAMEL = _load("test_camel")


@pytest.mark.parametrize("name", [n for n in dir(CAMEL) if n.startswith("test_")])
def test_the_jax_camel_cases_pass_on_the_port(name, tmp_path):
    module = _load("test_camel", CamelSource=camel.CamelSource,
                   merge_component_options=camel.merge_component_options,
                   parse_camel_uri=camel.parse_camel_uri,
                   validate_camel_config=camel.validate_camel_config)
    fn = getattr(module, name)
    kwargs = {"tmp_path": tmp_path, "run_async": asyncio.run}
    fn(**{p: kwargs[p] for p in inspect.signature(fn).parameters})


def _camel_records(module, config: dict, n: int, commit: bool) -> list:
    async def main():
        source = module.CamelSource()
        await source.init(config)
        await source.start()
        out = []
        try:
            while len(out) < n:
                out += await source.read()
            if commit:
                await source.commit(out)
        finally:
            await source.close()
        return out

    records = asyncio.run(main())
    varying = {"CamelTimerFiredTime"}
    return [(r.value, r.key, r.origin,
             [(k, v) for k, v in r.headers if k not in varying]) for r in records]


@pytest.mark.parametrize("mode", ["delete", "noop", "move"])
def test_camel_file_route_gives_the_jax_records(tmp_path, mode):
    results = {}
    for name, module in (("jax", jax_camel), ("port", camel)):
        root = tmp_path / name
        (root / "sub").mkdir(parents=True)
        (root / "a.txt").write_text("alpha")
        (root / "b.bin").write_bytes(b"\xff\xfe")
        (root / "sub" / "c.txt").write_text("gamma")
        for p in root.rglob("*"):
            if p.is_file():
                os.utime(p, (1_700_000_000, 1_700_000_000))
        options = {"delete": {"delete": "true"}, "noop": {"noop": "true"}, "move": {}}[mode]
        config = {"component-uri": f"file:{root}", "key-header": "CamelFileNameOnly",
                  "component-options": {"recursive": "true", "delay": 10, **options}}
        records = _camel_records(module, config, 3, commit=True)
        results[name] = (json.loads(json.dumps(records, default=repr).replace(str(root), "ROOT")),
                         sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()))
    assert results["port"] == results["jax"]


def test_camel_timer_route_gives_the_jax_records():
    config = {"component-uri": "timer:tick", "key-header": "CamelTimerName",
              "component-options": {"period": 5, "repeatCount": 3}}
    assert (_camel_records(camel, config, 3, commit=False)
            == _camel_records(jax_camel, config, 3, commit=False))


CAMEL_APP = """
topics:
  - name: "out"
    creation-mode: create-if-not-exists
pipeline:
  - name: "read"
    type: "camel-source"
    output: "out"
    configuration:
      component-uri: %s
      component-options: %s
"""


@pytest.mark.parametrize("uri,options", [
    ("jms:queue:foo", "{}"), ("''", "{}"), ("timer:t", "{period: -1}"),
    ("timer:t", "{repeatCount: '2.5'}"), ("file:/tmp/x", "{include: '['}"),
    ("file:/tmp/x", "not-a-map"), ("timer:t", "{period: 50}")])
def test_camel_uris_are_checked_at_planning_by_both(uri, options):
    files = {"pipeline.yaml": CAMEL_APP % (uri, options)}
    outcomes = []
    for parse_, deployer, error in ((jax_parse, JaxDeployer, JaxPlanningError),
                                    (parse, ApplicationDeployer, PlanningError)):
        try:
            plan = deployer().create_implementation("app", parse_(files))
            outcomes.append(("planned", sorted(plan.agents)))
        except error as e:
            outcomes.append(("refused", str(e)))
    assert outcomes[1] == outcomes[0]
    assert outcomes[0][0] == ("planned" if options == "{period: 50}" else "refused")

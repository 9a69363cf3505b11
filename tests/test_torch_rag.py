"""The retrieval slice end to end, under each package's runner and engines
at the tiny model in f32 (greedy):

- an ingestion app (``text-splitter`` → ``document-to-json`` →
  ``compute-ai-embeddings`` → ``vector-db-sink``) fills the ``vector-db``
  in-memory store, then the ``rag-pipeline`` example's pipeline (unchanged,
  its resource at the tiny model) answers three questions: the stored rows,
  each answer's ``related`` ids and ``context``, the answer and its stream
  chunks must be equal;
- the ``chatbot-rag-memory`` example (its SQLite file in a temporary
  directory, the ``history`` table made by the ``jdbc-table`` asset) over
  two sessions of two turns: the answers, the history each second turn
  read, and the table's rows must be equal.

In the RAG run both encoders load one sentence-transformers checkpoint
written here (random numpy tensors under the BERT names), so the vectors,
and the retrieval, are the same model's; float vectors and similarities are
compared within 1e-6 relative, everything else exactly. The memory app's
prompt prints the retrieved rows' similarities as text, so a last-bit
difference between the two packages' f32 encoders would change the prompt:
there both encoders' ``embed`` give one numpy bag-of-words embedding
(:func:`bag_of_words`), and everything is compared exactly."""

import asyncio
import itertools
import re
import sqlite3
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
import yaml

import langstream_tpu.agents.jdbc as jax_jdbc
import langstream_tpu.agents.text as jax_text
import langstream_tpu.agents.vector as jax_vector
import langstream_tpu.runtime.local_runner as jax_local
import langstream_tpu.runtime.memory_broker as jax_broker
import langstream_tpu_torch.agents.jdbc as port_jdbc
import langstream_tpu_torch.agents.text as port_text
import langstream_tpu_torch.agents.vector as port_vector
import langstream_tpu_torch.runtime.local_runner as port_local
import langstream_tpu_torch.runtime.memory_broker as port_broker
from langstream_tpu.serving.engine import EmbeddingEngine as JaxEmbeddingEngine
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.serving.embeddings import EmbeddingEngine
from langstream_tpu_torch.serving.engine import TorchServingEngine

REPO = Path(__file__).resolve().parents[1]
APPS = REPO / "examples" / "applications"
FIXTURE = str(REPO / "tests" / "fixtures" / "llama_tiny_golden")
SESSION = "langstream-client-session-id"
CHUNK_SIZE = 120

PACKAGES = {
    "jax": types.SimpleNamespace(Runner=jax_local.LocalApplicationRunner, vector=jax_vector,
                                 jdbc=jax_jdbc, text=jax_text, Broker=jax_broker.MemoryBroker),
    "port": types.SimpleNamespace(Runner=port_local.LocalApplicationRunner, vector=port_vector,
                                  jdbc=port_jdbc, text=port_text, Broker=port_broker.MemoryBroker),
}
_CLUSTERS = itertools.count()

INGEST_PIPELINE = f"""
topics:
  - name: "documents-topic"
    creation-mode: create-if-not-exists
pipeline:
  - name: "split"
    type: "text-splitter"
    input: "documents-topic"
    configuration:
      chunk-size: {CHUNK_SIZE}
      chunk-overlap: 12
  - name: "to-json"
    type: "document-to-json"
    configuration:
      text-field: "text"
  - name: "embed"
    type: "compute-ai-embeddings"
    configuration:
      model: "minilm-l6"
      embeddings-field: "value.embeddings"
      text: "{{{{ value.text }}}}"
      batch-size: 8
      flush-interval: 5
  - name: "write"
    type: "vector-db-sink"
    configuration:
      datasource: "vector-db"
      collection-name: "docs"
      fields:
        - name: "id"
          expression: "fn:concat(key, '-', properties.chunk_id)"
        - name: "vector"
          expression: "value.embeddings"
        - name: "text"
          expression: "value.text"
"""
WORDS = ("river mountain engine signal harbor garden lantern copper meadow orbit "
         "violin glacier pepper canyon marble falcon ember quartz willow thunder").split()
QUESTIONS = {"s1": "what is the copper lantern?", "s2": "tell me about the glacier",
             "s3": "why does the falcon orbit?"}
TURNS = {"m1": ["where is the harbor?", "and the garden?"],
         "m2": ["what of the violin?", "is it marble?"]}


def documents(n: int = 6, seed: int = 0) -> list[tuple[str, str]]:
    rng = np.random.default_rng(seed)
    return [(f"doc{i}", " ".join(rng.choice(WORDS, 50)) + ".") for i in range(n)]


def write_encoder_checkpoint(path: Path) -> str:
    """A minilm-l6-shaped ``pytorch_model.bin`` of seeded random tensors
    (a 512-row word table keeps the file small)."""
    import torch

    rng = np.random.default_rng(0)
    H, I, layers, positions = 384, 1536, 6, 512
    shapes = {"embeddings.word_embeddings.weight": (512, H),
              "embeddings.position_embeddings.weight": (positions, H),
              "embeddings.LayerNorm.weight": (H,), "embeddings.LayerNorm.bias": (H,)}
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            shapes[f"{p}attention.self.{name}.weight"] = (H, H)
            shapes[f"{p}attention.self.{name}.bias"] = (H,)
        shapes.update({
            f"{p}attention.output.dense.weight": (H, H), f"{p}attention.output.dense.bias": (H,),
            f"{p}attention.output.LayerNorm.weight": (H,),
            f"{p}attention.output.LayerNorm.bias": (H,),
            f"{p}intermediate.dense.weight": (I, H), f"{p}intermediate.dense.bias": (I,),
            f"{p}output.dense.weight": (H, I), f"{p}output.dense.bias": (H,),
            f"{p}output.LayerNorm.weight": (H,), f"{p}output.LayerNorm.bias": (H,)})
    path.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.from_numpy((0.05 * rng.standard_normal(s)).astype(np.float32)
                                    + (1.0 if k.endswith("LayerNorm.weight") else 0.0))
                for k, s in shapes.items()}, path / "pytorch_model.bin")
    return str(path)


@pytest.fixture(scope="module")
def resource(tmp_path_factory):
    checkpoint = write_encoder_checkpoint(tmp_path_factory.mktemp("encoder"))
    return {"model": "tiny", "model-dtype": "float32", "slots": 3, "max-seq-len": 1024,
            "checkpoint": FIXTURE, "decode-chunk": 4, "decode-chunk-light": 2,
            "max-tokens": 12, "embeddings-checkpoint": checkpoint}


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    from langstream_tpu_torch.agents import services as port_services

    monkeypatch.setattr(port_services, "SERVING_DEVICE", "cpu")
    for pkg in PACKAGES.values():
        pkg.vector.InMemoryVectorStore.reset()
        pkg.jdbc.JdbcDataSource.reset_shared()
    yield
    for pkg in PACKAGES.values():
        pkg.vector.InMemoryVectorStore.reset()
        pkg.jdbc.JdbcDataSource.reset_shared()


def _app(target: Path, example: str | None, resources: list[dict], pipeline: str | None = None,
         db: Path | None = None) -> Path:
    """An example's pipeline (or ``pipeline``) with ``resources`` as its
    configuration; ``db`` replaces the example's SQLite path."""
    target.mkdir(parents=True, exist_ok=True)
    text = pipeline if pipeline is not None else (APPS / example / "pipeline.yaml").read_text()
    if db is not None:
        text = text.replace("/tmp/chat-history.db", str(db))
    (target / "pipeline.yaml").write_text(text)
    (target / "configuration.yaml").write_text(
        yaml.safe_dump({"configuration": {"resources": resources}}))
    return target


def _resources(tiny: dict, db: Path | None = None) -> list[dict]:
    out = [{"type": "datasource", "name": "vector-db", "configuration": {"service": "in-memory"}},
           {"type": "tpu-serving-configuration", "name": "tpu", "configuration": tiny}]
    if db is not None:
        out.insert(1, {"type": "datasource", "name": "history-db", "configuration": {
            "service": "jdbc", "driver": "sqlite", "url": str(db)}})
    return out


def _instance(cluster: str) -> str:
    text = (REPO / "examples" / "instances" / "memory.yaml").read_text()
    return text.replace('type: "memory"', f'type: "memory"\n    configuration: {{cluster: "{cluster}"}}', 1)


async def _close_engines():
    for cls in (TorchServingEngine, TpuServingEngine):
        engines = list(cls._instances.values())
        cls.reset_instances()
        for engine in engines:
            await engine.close()
    EmbeddingEngine.reset_instances()
    JaxEmbeddingEngine.reset_instances()


async def _ingest(pkg, app_dir: Path, cluster: str) -> dict:
    splitter = pkg.text.RecursiveCharacterTextSplitter(chunk_size=CHUNK_SIZE, chunk_overlap=12)
    docs = documents()
    expected = sum(len(splitter.split_text(text)) for _, text in docs)
    runner = pkg.Runner.from_directory(app_dir, instance=_instance(cluster),
                                       application_id="ingest")
    async with runner:
        for key, text in docs:
            await runner.produce("documents-topic", text, key=key)
        coll = pkg.vector.InMemoryVectorStore.get("vector-db").collection("docs")
        for _ in range(2400):
            if len(coll.ids) >= expected:
                break
            await asyncio.sleep(0.05)
    assert len(coll.ids) == expected
    order = sorted(range(len(coll.ids)), key=lambda i: coll.ids[i])
    return {"ids": [coll.ids[i] for i in order], "payloads": [coll.payloads[i] for i in order],
            "vectors": np.stack([coll.vectors[i] for i in order])}


async def _rag(pkg, ingest_dir: Path, rag_dir: Path, cluster: str):
    try:
        stored = await _ingest(pkg, ingest_dir, cluster)
        runner = pkg.Runner.from_directory(rag_dir, instance=_instance(cluster),
                                           application_id="rag")
        async with runner:
            for session, question in QUESTIONS.items():
                await runner.produce("questions-topic", question, headers={SESSION: session})
            answers = await runner.wait_for_messages("answers-topic", len(QUESTIONS),
                                                     timeout=300)
            chunks = []
            for _ in range(1200):
                chunks = await runner.wait_for_messages("stream-topic", 1)
                if sum(c.header("stream-last-message") == "true" for c in chunks) == len(QUESTIONS):
                    break
                await asyncio.sleep(0.05)
    finally:
        await _close_engines()
    streams: dict = {}
    for c in chunks:
        streams.setdefault(c.header(SESSION), []).append((int(c.header("stream-index")), c.value))
    return stored, {a.header(SESSION): a.value for a in answers}, {
        k: "".join(v for _, v in sorted(s)) for k, s in streams.items()}


def _close(a, b) -> bool:
    return np.allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=1e-6, atol=1e-7)


def test_ingestion_and_rag_pipeline_equal_the_jax_runner(tmp_path, resource):
    out = {}
    for name, pkg in PACKAGES.items():
        ingest = _app(tmp_path / name / "ingest", None, _resources(resource),
                      pipeline=INGEST_PIPELINE)
        rag = _app(tmp_path / name / "rag", "rag-pipeline", _resources(resource))
        cluster = f"rag-{name}-{next(_CLUSTERS)}"
        try:
            out[name] = asyncio.run(_rag(pkg, ingest, rag, cluster))
        finally:
            pkg.Broker.reset(cluster)
    (jax_stored, jax_answers, jax_streams), (stored, answers, streams) = out["jax"], out["port"]
    assert stored["ids"] == jax_stored["ids"] and stored["payloads"] == jax_stored["payloads"]
    assert _close(stored["vectors"], jax_stored["vectors"])
    assert set(answers) == set(jax_answers) == set(QUESTIONS)
    for session, value in answers.items():
        want = jax_answers[session]
        assert [r["id"] for r in value["related"]] == [r["id"] for r in want["related"]]
        assert _close([r["similarity"] for r in value["related"]],
                      [r["similarity"] for r in want["related"]])
        assert [r["id"] for r in value["context"]] == [r["id"] for r in want["context"]]
        assert _close(value["question_embeddings"], want["question_embeddings"])
        assert value["answer"] == want["answer"] and value["answer"]
        assert streams[session] == jax_streams[session] == value["answer"]
        # the store's own rows, ranked by numpy: the related ids, ties within 1e-6
        q = np.asarray(value["question_embeddings"], np.float32)
        sims = stored["vectors"] @ (q / np.linalg.norm(q))
        top = np.sort(sims)[::-1][:20]
        got = {r["id"]: r["similarity"] for r in value["related"]}
        assert len(got) == min(20, len(stored["ids"])) and _close(sorted(got.values())[::-1], top)
        assert len(value["context"]) == 5 and {r["id"] for r in value["context"]} <= set(got)


async def _memory(pkg, ingest_dir: Path, app_dir: Path, db: Path, cluster: str):
    try:
        await _ingest(pkg, ingest_dir, cluster)
        runner = pkg.Runner.from_directory(app_dir, instance=_instance(cluster),
                                           application_id="memory")
        created = None
        async with runner:
            created = sqlite3.connect(db).execute(
                "SELECT name FROM sqlite_master WHERE type='table'").fetchall()
            saved = []
            for turn in range(2):
                for session, turns in TURNS.items():
                    await runner.produce("mem-questions", turns[turn],
                                         headers={SESSION: session})
                want = (turn + 1) * len(TURNS)
                for _ in range(2400):
                    records = await runner.wait_for_messages("mem-answers", 1)
                    saved = [r for r in records if isinstance(r.value, dict)]
                    if len(saved) >= want:
                        break
                    await asyncio.sleep(0.05)
            records = await runner.wait_for_messages("mem-answers", 1)
    finally:
        await _close_engines()
    rows = sqlite3.connect(db).execute(
        "SELECT session_id, question, answer FROM history ORDER BY session_id, rowid").fetchall()
    streams: dict = {}
    for r in records:
        if not isinstance(r.value, dict):
            streams.setdefault(r.header(SESSION), []).append(r.value)
    turns = {(r.header(SESSION), r.value["question"]): (r.value["answer"], r.value["history"],
                                                       r.value["inserted"]) for r in saved}
    return created, rows, turns, {k: "".join(v) for k, v in streams.items()}


def bag_of_words(texts: list[str], dim: int = 384) -> list[list[float]]:
    """Unit vectors: the sum of a seeded random vector per word."""
    out = []
    for text in texts:
        v = np.zeros(dim, np.float32)
        for word in re.findall(r"[a-z]+", text.lower()):
            v += np.random.default_rng(zlib.crc32(word.encode())).standard_normal(dim).astype(
                np.float32)
        v /= float(np.linalg.norm(v)) or 1.0
        out.append([float(x) for x in v])
    return out


def test_chatbot_rag_memory_equals_the_jax_runner(tmp_path, resource, monkeypatch):
    async def embed(self, texts):
        return bag_of_words(texts)

    monkeypatch.setattr(EmbeddingEngine, "embed", embed)
    monkeypatch.setattr(JaxEmbeddingEngine, "embed", embed)
    out = {}
    for name, pkg in PACKAGES.items():
        db = tmp_path / name / "chat-history.db"
        ingest = _app(tmp_path / name / "ingest", None, _resources(resource),
                      pipeline=INGEST_PIPELINE)
        app = _app(tmp_path / name / "memory", "chatbot-rag-memory",
                   _resources(resource, db), db=db)
        cluster = f"mem-{name}-{next(_CLUSTERS)}"
        try:
            out[name] = asyncio.run(_memory(pkg, ingest, app, db, cluster))
        finally:
            pkg.Broker.reset(cluster)
    assert out["port"] == out["jax"]
    created, rows, turns, streams = out["port"]
    assert created == [("history",)]
    assert len(rows) == 4 and len(turns) == 4
    for session, (first, second) in TURNS.items():
        answer, history, inserted = turns[(session, second)]
        first_answer = turns[(session, first)][0]
        assert {"question": first, "answer": first_answer} in history
        assert inserted == {"count": 1} and answer
    assert sorted(r[2] for r in rows) == sorted(t[0] for t in turns.values())

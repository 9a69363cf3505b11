"""AI agents: completions, embeddings, re-rank, FLARE, datasource query (the
port's copy of ``langstream_tpu/agents/ai.py``).

Parity: ``langstream-ai-agents`` --
``ChatCompletionsStep.java:42`` (Mustache prompt templating, token streaming
to a topic with growing chunk batches up to ``min-chunks-per-message``,
``completion-field``/``log-field``), ``TextCompletionsStep.java``,
``ComputeAIEmbeddingsStep.java:46`` (batched via ``OrderedAsyncBatchExecutor``
-- batch-size / flush-interval / concurrency config), ``QueryStep.java``,
``ReRankAgent.java`` (MMR), ``FlareControllerAgent.java``.

The backing :class:`ServiceProvider` for a ``tpu-serving-configuration``
resource is the port's engine, so "call the model" means "enqueue into the
continuous-batching decode loop on this process's card".
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import uuid
from typing import Any

from langstream_tpu_torch.api.agent import (
    AgentProcessor,
    RecordSink,
    SingleRecordProcessor,
    SourceRecordAndResult,
)
from langstream_tpu_torch.api.batching import OrderedAsyncBatchExecutor
from langstream_tpu_torch.api.record import MutableRecord, Record, make_record
from langstream_tpu_torch.agents.services import (
    Chunk,
    ServiceProvider,
    resolve_service_provider,
)
from langstream_tpu_torch.core.expressions import evaluate_accessor, render_template

log = logging.getLogger(__name__)


class _AIAgentBase(SingleRecordProcessor):
    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        self.provider: ServiceProvider = resolve_service_provider(
            configuration.get("__resources__", {})
        )

    def _options(self, record: Record | None = None) -> dict[str, Any]:
        keys = (
            "model",
            "max-tokens",
            "temperature",
            "top-p",
            "top-k",
            "stop",
            "presence-penalty",
            "frequency-penalty",
            "logprobs",
            # pipeline-wide QoS defaults (the record headers below
            # override per request)
            "priority",
            "qos-tenant",
        )
        options = {
            k: self.configuration[k] for k in keys if k in self.configuration
        }
        if record is not None:
            # the gateway stamped the client's QoS identity onto the
            # record; forward it so the engine's scheduler sees the same
            # tenant/priority the gateway throttled on
            headers = record.header_map()
            qos_tenant = headers.get("langstream-qos-tenant")
            if qos_tenant:
                options["qos-tenant"] = qos_tenant
            priority = headers.get("langstream-qos-priority")
            if priority:
                options["priority"] = priority
            deadline = headers.get("langstream-deadline")
            if deadline:
                # the gateway's end-to-end budget (serving/handoff.py):
                # the engine's admission gate enforces it 504-shaped, so
                # the same deadline the client saw bounds the device work
                options["deadline"] = deadline
            stream_id = headers.get("langstream-stream-id")
            if stream_id:
                # the gateway's per-message stream identity: the engine
                # registers the request future under this key so a client
                # disconnect at the gateway cancels the decode and frees
                # the slot (serving/streaming.py)
                options["stream-key"] = stream_id
            adapter = headers.get("langstream-adapter")
            if adapter:
                # the LoRA adapter the gateway resolved from QoS tenant
                # config (serving/adapters.py): the engine's admission
                # gate hydrates it through the tier store and the decode
                # program applies it per-slot (docs/ADAPTERS.md)
                options["adapter"] = adapter
        return options

    @staticmethod
    def _stream_cancelled(record: Record | None) -> bool:
        """Classify a ``CancelledError`` out of the completion call:
        True means the client disconnected and the gateway cancelled this
        record's stream-key (serving/streaming.py) — the record is
        TERMINAL (the engine already reclaimed the slot and logged
        ``stream-cancel``), so the agent commits it with zero results
        instead of letting the cancel fall through ``composite._done``'s
        cancelled branch, which would leak the record as forever-inflight.
        False means shutdown (or an unrelated cancel): keep propagating.
        """
        if record is None:
            return False
        key = record.header_map().get("langstream-stream-id")
        if not key:
            return False
        from langstream_tpu_torch.serving.streaming import STREAMS

        return STREAMS.consume_cancelled(str(key))


class _StreamWriter:
    """Streams completion chunks to a topic with growing batch sizes.

    Parity: ``ChatCompletionsStep.java:65,151`` — the first message carries 1
    chunk, the second 2, … up to ``min-chunks-per-message``, so TTFT stays low
    while steady-state per-message overhead amortises. Each streamed record
    carries the source record's headers (session filters keep working) plus
    ``stream-id`` / ``stream-index`` / ``stream-last-message``.
    """

    def __init__(
        self,
        producer,
        source_record: Record,
        completion_field: str,
        min_chunks_per_message: int,
    ):
        self.producer = producer
        self.source_record = source_record
        self.completion_field = completion_field
        self.min_chunks = max(1, min_chunks_per_message)
        self.stream_id = str(uuid.uuid4())
        self.buffer: list[str] = []
        self.next_batch = 1
        self.index = 0

    async def on_chunk(self, chunk: Chunk) -> None:
        self.buffer.append(chunk.text)
        if chunk.last or len(self.buffer) >= self.next_batch:
            await self._flush(last=chunk.last)
            self.next_batch = min(self.next_batch * 2, self.min_chunks)

    async def _flush(self, last: bool) -> None:
        if not self.buffer and not last:
            return
        text = "".join(self.buffer)
        self.buffer = []
        if self.completion_field == "value":
            value: Any = text
        else:
            mutable = MutableRecord(value={})
            mutable.set_field(self.completion_field, text)
            value = mutable.value
        record = make_record(
            value=value,
            key=self.source_record.key,
            headers=dict(self.source_record.headers)
            | {
                "stream-id": self.stream_id,
                "stream-index": str(self.index),
                "stream-last-message": str(last).lower(),
            },
        )
        self.index += 1
        await self.producer.write(record)


async def _build_at_start(provider: ServiceProvider, configuration: dict[str, Any]) -> None:
    """Build the agent's completions service when the agent starts (for a
    serving resource: the shared engine) and, on a ``warmup-on-start``
    engine, run its warmup inside the start, so the first record finds a
    warm engine."""
    service = provider.get_completions_service(configuration)
    engine = getattr(service, "engine", None)
    if engine is not None and engine.config.warmup_on_start:
        await engine.warmup()


class ChatCompletionsAgent(_AIAgentBase):
    """``ai-chat-completions``."""

    async def start(self) -> None:
        await _build_at_start(self.provider, self.configuration)

    async def setup(self, context) -> None:
        await super().setup(context)
        self._stream_producer = None
        stream_topic = self.configuration.get("stream-to-topic")
        if stream_topic:
            self._stream_producer = context.get_topic_producer(stream_topic)

    async def process_record(self, record: Record) -> list[Record]:
        mutable = MutableRecord.from_record(record)
        messages = [
            {
                "role": m.get("role", "user"),
                "content": render_template(m.get("content", ""), mutable),
            }
            for m in self.configuration.get("messages", [])
        ]
        writer = None
        consumer = None
        if self._stream_producer is not None:
            writer = _StreamWriter(
                self._stream_producer,
                record,
                self.configuration.get("stream-response-completion-field", "value"),
                int(self.configuration.get("min-chunks-per-message", 20)),
            )
            consumer = writer.on_chunk
        try:
            result = await self.provider.get_completions_service(
                self.configuration
            ).chat_completions(messages, self._options(record), consumer)
        except asyncio.CancelledError:
            if self._stream_cancelled(record):
                return []  # client disconnect: terminal, commit quietly
            raise

        completion_field = self.configuration.get("completion-field")
        if completion_field:
            if completion_field == "value":
                mutable.value = result.text
            else:
                mutable.set_field(completion_field, result.text)
        log_field = self.configuration.get("log-field")
        if log_field:
            mutable.set_field(log_field, json.dumps(messages))
        for header_name, attr in (
            ("prompt-tokens", "num_prompt_tokens"),
            ("completion-tokens", "num_completion_tokens"),
        ):
            mutable.properties[f"langstream-{header_name}"] = str(
                getattr(result, attr)
            )
        if result.ttft_s > 0:
            # engine-measured decomposition: client TTFT minus this is the
            # gateway/broker transport share
            for header_name, attr in (
                ("ttft-ms", "ttft_s"),
                ("queue-wait-ms", "queue_wait_s"),
                ("prefill-ms", "prefill_s"),
            ):
                mutable.properties[f"langstream-{header_name}"] = str(
                    round(getattr(result, attr) * 1000, 3)
                )
        return [mutable.to_record()]


class TextCompletionsAgent(_AIAgentBase):
    """``ai-text-completions``."""

    async def start(self) -> None:
        await _build_at_start(self.provider, self.configuration)

    async def setup(self, context) -> None:
        await super().setup(context)
        self._stream_producer = None
        stream_topic = self.configuration.get("stream-to-topic")
        if stream_topic:
            self._stream_producer = context.get_topic_producer(stream_topic)

    async def process_record(self, record: Record) -> list[Record]:
        mutable = MutableRecord.from_record(record)
        prompt_cfg = self.configuration.get("prompt", [])
        if isinstance(prompt_cfg, str):
            prompt_cfg = [prompt_cfg]
        prompt = "\n".join(render_template(p, mutable) for p in prompt_cfg)
        consumer = None
        if self._stream_producer is not None:
            writer = _StreamWriter(
                self._stream_producer,
                record,
                self.configuration.get("stream-response-completion-field", "value"),
                int(self.configuration.get("min-chunks-per-message", 20)),
            )
            consumer = writer.on_chunk
        try:
            result = await self.provider.get_completions_service(
                self.configuration
            ).text_completions(prompt, self._options(record), consumer)
        except asyncio.CancelledError:
            if self._stream_cancelled(record):
                return []  # client disconnect: terminal, commit quietly
            raise
        completion_field = self.configuration.get("completion-field", "value")
        if completion_field == "value":
            mutable.value = result.text
        else:
            mutable.set_field(completion_field, result.text)
        log_field = self.configuration.get("log-field")
        if log_field:
            mutable.set_field(log_field, prompt)
        return [mutable.to_record()]


class ComputeAIEmbeddingsAgent(AgentProcessor):
    """``compute-ai-embeddings``: batched, ordered, async.

    The batch executor keeps the TPU matmuls fat (batch dimension) while
    preserving per-key ordering — the exact role ``OrderedAsyncBatchExecutor``
    plays in the reference (``ComputeAIEmbeddingsStep.java:97-99``).
    """

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        self.provider = resolve_service_provider(
            configuration.get("__resources__", {})
        )
        self.service = self.provider.get_embeddings_service(configuration)
        self.text_template = configuration.get("text", "{{ value }}")
        self.embeddings_field = configuration.get(
            "embeddings-field", "value.embeddings"
        )
        # flush-interval default 100 ms keeps batches filling (flush-interval
        # 0 means flush-per-add, matching the reference's semantics when an
        # app explicitly opts out of batching latency)
        self.executor: OrderedAsyncBatchExecutor = OrderedAsyncBatchExecutor(
            batch_size=int(configuration.get("batch-size", 10)),
            processor=self._process_batch,
            flush_interval=float(configuration.get("flush-interval", 100)) / 1000.0,
            num_buckets=int(configuration.get("concurrency", 4)),
            key_fn=lambda item: item[0].key,
        )
        self._add_tasks: set = set()

    def process(self, records: list[Record], sink: RecordSink) -> None:
        from langstream_tpu_torch.core.asyncutil import spawn_retained

        for record in records:
            # an add() that raises (bucket closed mid-shutdown) must surface
            spawn_retained(
                self.executor.add((record, sink)),
                self._add_tasks,
                log,
                "embeddings batch submit failed",
            )

    async def _process_batch(self, items: list[tuple[Record, RecordSink]]) -> None:
        mutables = [MutableRecord.from_record(r) for r, _ in items]
        texts = [render_template(self.text_template, m) for m in mutables]
        try:
            embeddings = await self.service.compute_embeddings(texts)
        except Exception as e:
            for (record, sink), _ in zip(items, mutables):
                sink.emit(SourceRecordAndResult(record, [], e))
            return
        for (record, sink), mutable, emb in zip(items, mutables, embeddings):
            mutable.set_field(self.embeddings_field, list(map(float, emb)))
            sink.emit(SourceRecordAndResult(record, [mutable.to_record()], None))

    async def close(self) -> None:
        await self.executor.close()

    def component_type(self):
        from langstream_tpu_torch.api.agent import ComponentType

        return ComponentType.PROCESSOR


# ---------------------------------------------------------------------------
# re-rank (MMR) — parity: ai/agents/rerank/ReRankAgent.java
# ---------------------------------------------------------------------------


def _cosine(a: list[float], b: list[float]) -> float:
    num = sum(x * y for x, y in zip(a, b))
    da = math.sqrt(sum(x * x for x in a)) or 1.0
    db = math.sqrt(sum(y * y for y in b)) or 1.0
    return num / (da * db)


def _bm25_scores(query: str, docs: list[str], k1: float, b: float) -> list[float]:
    q_terms = query.lower().split()
    tokenised = [d.lower().split() for d in docs]
    if not docs:
        return []
    avgdl = sum(len(t) for t in tokenised) / len(tokenised) or 1.0
    n = len(docs)
    scores = []
    for terms in tokenised:
        score = 0.0
        dl = len(terms) or 1
        for q in set(q_terms):
            tf = terms.count(q)
            if tf == 0:
                continue
            df = sum(1 for t in tokenised if q in t)
            idf = math.log(1 + (n - df + 0.5) / (df + 0.5))
            score += idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avgdl))
        scores.append(score)
    return scores


class ReRankAgent(SingleRecordProcessor):
    """``re-rank``: MMR re-ranking of retrieved documents by a blend of
    embedding similarity and BM25 text relevance."""

    async def process_record(self, record: Record) -> list[Record]:
        cfg = self.configuration
        mutable = MutableRecord.from_record(record)
        docs = evaluate_accessor(cfg.get("field", "value.documents"), mutable) or []
        if not isinstance(docs, list):
            docs = []
        query_text = evaluate_accessor(cfg.get("query-text", ""), mutable) or ""
        query_emb = evaluate_accessor(cfg.get("query-embeddings", ""), mutable)
        text_field = cfg.get("text-field", "record.text").removeprefix("record.")
        emb_field = cfg.get("embeddings-field", "record.embeddings").removeprefix(
            "record."
        )
        max_out = int(cfg.get("max", 5))
        lam = float(cfg.get("lambda", 0.5))
        k1, b = float(cfg.get("k1", 1.2)), float(cfg.get("b", 0.75))

        texts = [str((d or {}).get(text_field, "")) if isinstance(d, dict) else str(d) for d in docs]
        bm25 = _bm25_scores(str(query_text), texts, k1, b)
        max_bm25 = max(bm25) if bm25 else 1.0

        def relevance(i: int) -> float:
            score = 0.0
            if query_emb is not None and isinstance(docs[i], dict):
                emb = docs[i].get(emb_field)
                if emb:
                    score += _cosine(list(map(float, query_emb)), list(map(float, emb)))
            if max_bm25 > 0:
                score += bm25[i] / max_bm25
            return score

        selected: list[int] = []
        candidates = list(range(len(docs)))
        while candidates and len(selected) < max_out:
            def mmr(i: int) -> float:
                redundancy = 0.0
                if selected and isinstance(docs[i], dict):
                    emb_i = docs[i].get(emb_field)
                    if emb_i:
                        sims = [
                            _cosine(list(map(float, emb_i)), list(map(float, docs[j].get(emb_field) or [])))
                            for j in selected
                            if isinstance(docs[j], dict) and docs[j].get(emb_field)
                        ]
                        redundancy = max(sims) if sims else 0.0
                return lam * relevance(i) - (1 - lam) * redundancy

            best = max(candidates, key=mmr)
            selected.append(best)
            candidates.remove(best)

        mutable.set_field(
            cfg.get("output-field", cfg.get("field", "value.documents")),
            [docs[i] for i in selected],
        )
        return [mutable.to_record()]


class FlareControllerAgent(SingleRecordProcessor):
    """``flare-controller``: FLARE active-retrieval loop control — if the
    completion carries low-confidence tokens, route the record back to the
    retrieval loop topic, else pass through."""

    async def process_record(self, record: Record) -> list[Record]:
        from langstream_tpu_torch.runtime.runner import DESTINATION_TOPIC_HEADER

        cfg = self.configuration
        mutable = MutableRecord.from_record(record)
        tokens_field = cfg.get("tokens-field", "value.tokens")
        logprobs_field = cfg.get("logprobs-field", "value.logprobs")
        loop_topic = cfg.get("loop-topic", "flare-loop")
        min_prob = float(cfg.get("min-prob", 0.2))
        tokens = evaluate_accessor(tokens_field, mutable) or []
        logprobs = evaluate_accessor(logprobs_field, mutable) or []
        uncertain = [
            t
            for t, lp in zip(tokens, logprobs)
            if math.exp(float(lp)) < min_prob
        ]
        if uncertain:
            mutable.set_field("value.flare_uncertain_spans", uncertain)
            out = mutable.to_record()
            return [out.with_headers({DESTINATION_TOPIC_HEADER: loop_topic})]
        return [mutable.to_record()]


class QueryAgent(SingleRecordProcessor):
    """``query``: run a datasource query with ``?`` bindings from record
    fields into ``output-field`` (parity: ``QueryStep.java``)."""

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        from langstream_tpu_torch.agents.vector import resolve_datasource

        self.datasource = resolve_datasource(
            configuration.get("datasource"),
            configuration.get("__resources__", {}),
        )

    async def process_record(self, record: Record) -> list[Record]:
        cfg = self.configuration
        mutable = MutableRecord.from_record(record)
        params = [
            evaluate_accessor(f, mutable) for f in cfg.get("fields", [])
        ]
        out_field = cfg.get("output-field", "value.query_results")
        if cfg.get("mode") == "execute":
            # writes go through execute_write so the datasource COMMITS
            # (fetch_data on JDBC leaves an open deferred transaction that
            # both loses the write on restart and locks the database file);
            # parity: QueryStep.java's executeStatement mode
            execute = getattr(self.datasource, "execute_write", None)
            if execute is not None:
                affected = await execute(cfg.get("query", ""), params)
                # datasources that can't report affected rows return None
                mutable.set_field(
                    out_field,
                    {"count": affected if isinstance(affected, int) and affected >= 0 else 1},
                )
            else:
                results = await self.datasource.fetch_data(
                    cfg.get("query", ""), params
                )
                mutable.set_field(out_field, {"count": len(results)})
            return [mutable.to_record()]
        results = await self.datasource.fetch_data(cfg.get("query", ""), params)
        if cfg.get("only-first"):
            results = results[:1]
        mutable.set_field(out_field, results)
        return [mutable.to_record()]

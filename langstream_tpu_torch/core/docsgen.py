"""Agent-type documentation generator (the port's copy of
``langstream_tpu/core/docsgen.py``: it documents the agent types the
port's registry carries, with the JAX package's descriptors for them).

Parity: the reference's annotation-driven config docs
(``impl/uti/ClassConfigValidator.java`` + webservice
``doc/DocumentationGenerator.java``) — here generated from the agent
registry plus per-type config descriptors, emitted as JSON or Markdown
(CLI: ``docs agents``).
"""

from __future__ import annotations

import json
from typing import Any

from langstream_tpu_torch.api.registry import AgentCodeRegistry
from langstream_tpu_torch.core.planner import AGENT_TYPE_METADATA

# Documented configuration keys per agent type. Types absent here still
# appear in the docs with their component metadata (config passthrough).
CONFIG_DOCS: dict[str, dict[str, str]] = {
    "ai-chat-completions": {
        "model": "model name served by the TPU engine (or mock provider)",
        "messages": "chat template; {{ value.x }} placeholders render per record",
        "completion-field": "record field that receives the completion",
        "log-field": "optional field recording the rendered prompt",
        "stream-to-topic": "topic receiving streamed chunks as they decode",
        "stream-response-completion-field": "field for streamed chunk text",
        "min-chunks-per-message": "chunk batching: 1, then N, then 2N tokens…",
        "max-tokens / temperature / top-k / top-p": "sampling controls",
        "stop": "stop sequences: generation halts when any appears; the "
                "match is excluded from text and stream",
        "presence-penalty / frequency-penalty": "OpenAI-style penalties "
                "over output tokens (in-jit, counts ride the decode chunk)",
    },
    "ai-text-completions": {
        "model": "model name",
        "prompt": "list of template strings joined into the prompt",
        "completion-field": "destination field",
        "logprobs / logprobs-field / tokens-field": "per-token outputs (FLARE)",
        "stop": "stop sequences (as in ai-chat-completions)",
    },
    "compute-ai-embeddings": {
        "model": "encoder model (minilm-l6, tiny-encoder)",
        "text": "template producing the text to embed",
        "embeddings-field": "destination field for the vector",
        "batch-size": "max texts per batched forward",
        "flush-interval": "ms before a partial batch flushes",
        "concurrency": "parallel in-flight batches",
    },
    "text-splitter": {
        "chunk-size": "max tokens per chunk",
        "chunk-overlap": "tokens shared between neighbours",
        "length-function": "'length' (chars) or 'cl100k_base' (tokenizer)",
        "separators": "split hierarchy (recursive character splitting)",
    },
    "text-extractor": {},
    "text-normaliser": {
        "make-lowercase": "lowercase the text (default true)",
        "trim-spaces": "collapse whitespace (default true)",
    },
    "language-detector": {
        "property": "header receiving the detected language",
        "allowedLanguages": "drop records outside this list",
    },
    "document-to-json": {"text-field": "field name for the raw text"},
    "compute": {"fields": "list of {name, expression, type} computed fields"},
    "drop-fields": {"fields": "field names to remove"},
    "drop": {"when": "expression; matching records are dropped"},
    "cast": {"schema-type": "target type for value/key"},
    "flatten": {"delimiter": "nested-key join character"},
    "merge-key-value": {},
    "unwrap-key-value": {"unwrapKey": "emit the key instead of the value"},
    "query": {
        "datasource": "datasource resource name",
        "query": "query with ? placeholders",
        "fields": "record fields bound to the placeholders",
        "output-field": "field receiving the result rows",
    },
    "query-vector-db": {
        "datasource": "vector datasource resource name",
        "query": "store-specific query (JSON for the in-memory store)",
        "fields": "bound parameters",
        "output-field": "result field",
    },
    "vector-db-sink": {
        "datasource": "vector datasource resource name",
        "collection-name": "target collection/table",
        "fields": "list of {name, expression} columns to write",
    },
    "re-rank": {
        "field": "candidate list field",
        "output-field": "destination for the re-ranked list",
        "algorithm": "'MMR' (maximal marginal relevance) or 'none'",
        "query-text / query-embeddings": "query accessors",
        "text-field / embeddings-field": "per-candidate accessors",
        "max": "results kept",
        "lambda / b / k1": "MMR + BM25 hyper-parameters",
    },
    "flare-controller": {
        "tokens-field": "completion tokens accessor",
        "logprobs-field": "per-token logprob accessor",
        "loop-topic": "topic feeding retrieval iterations",
        "retrieve-documents-field": "field listing low-confidence spans",
    },
    "dispatch": {"routes": "list of {when, destination} (destination 'drop' discards)"},
    "timer-source": {
        "period-seconds": "tick interval",
        "fields": "computed fields per tick record",
    },
    "trigger-event": {
        "when": "condition expression",
        "destination": "topic for the trigger record",
        "fields": "computed fields",
        "continue-processing": "also forward the original record",
    },
    "log-event": {"when": "condition", "message": "template logged per record"},
    "http-request": {
        "url / method / headers / body": "templated request parts",
        "output-field": "field receiving the response",
        "allow-redirects": "follow redirects",
    },
    "camel-source": {
        "component-uri": "Camel component URI — native subset: timer:, file:",
        "component-options": "map merged into the URI query string",
        "key-header": "message header used as the record key",
        "max-buffered-records": "bounded exchange buffer (default 100)",
    },
    "webcrawler": {
        "seed-urls": "crawl entry points",
        "allowed-domains": "domain allowlist",
        "forbidden-paths": "path denylist",
        "max-urls / max-depth": "frontier bounds",
        "min-time-between-requests": "politeness delay (ms)",
        "handle-robots-file": "honor robots.txt",
    },
    "s3-source": {
        "bucketName / endpoint / access-key / secret-key": "bucket coordinates",
    },
    "python-processor": {
        "className": "module.Class of the user agent (python/ dir)",
    },
    "grpc-python-processor": {
        "className": "user class run in a sidecar interpreter",
        "endpoint": "alternatively: connect to an external gRPC agent",
    },
}


# Per-type prose notes rendered after the config table: descope decisions
# and permanent caveats a key/description table can't carry.
TYPE_NOTES: dict[str, str] = {
    "camel-source": (
        "**Scheme support is permanently descoped to `timer:` and "
        "`file:`.** The reference embeds the full Apache Camel JVM runtime "
        "(300+ components); a Python port of that surface would be a "
        "second project, and every pipeline in this repo's examples and "
        "tests only ever exercises the timer and file components. Other "
        "schemes fail at planning time with a clear error naming the "
        "supported subset. This is a deliberate, permanent decision, not "
        "a TODO — new event-source integrations should be first-class "
        "agents (like `webcrawler-source` or `azure-blob-storage-source`), "
        "not Camel URIs."
    ),
}


def agent_docs() -> dict[str, Any]:
    """Structured docs for every registered agent type."""
    out: dict[str, Any] = {}
    for agent_type in sorted(AgentCodeRegistry.known_types()):
        meta = AGENT_TYPE_METADATA.get(agent_type)
        out[agent_type] = {
            "component-type": meta.component_type.value if meta else "PROCESSOR",
            "composable": meta.composable if meta else True,
            "configuration": CONFIG_DOCS.get(agent_type, {}),
        }
        if agent_type in TYPE_NOTES:
            out[agent_type]["notes"] = TYPE_NOTES[agent_type]
    return out


def render_markdown() -> str:
    lines = ["# Agent reference", ""]
    for agent_type, doc in agent_docs().items():
        lines.append(f"## `{agent_type}`")
        lines.append(
            f"*Component*: {doc['component-type']} — "
            f"{'composable' if doc['composable'] else 'not composable'}"
        )
        if doc["configuration"]:
            lines.append("")
            lines.append("| key | description |")
            lines.append("|---|---|")
            for key, desc in doc["configuration"].items():
                lines.append(f"| `{key}` | {desc} |")
        if doc.get("notes"):
            lines.append("")
            lines.append(doc["notes"])
        lines.append("")
    return "\n".join(lines)


def render_json() -> str:
    return json.dumps(agent_docs(), indent=2)

"""HTTP agents.

Parity: ``langstream-agent-http-request`` — ``http-request`` (templated
url/headers/body/query params, ``agents/http/HttpRequestAgent.java``) and
``langserve-invoke`` (LangServe client incl. streaming,
``LangServeInvokeAgent.java``).

The port's copy of ``langstream_tpu/agents/http.py``, on the port's own
client (:func:`langstream_tpu_torch.gateway.wire.open_response`, which follows
aiohttp's query, redirect and ``Content-Type`` rules and reads a streamed
answer line by line) instead of aiohttp.
"""

from __future__ import annotations

import json
from typing import Any

from langstream_tpu_torch.api.agent import SingleRecordProcessor
from langstream_tpu_torch.api.record import MutableRecord, Record
from langstream_tpu_torch.core.expressions import evaluate, render_template
from langstream_tpu_torch.gateway import wire


class HttpRequestAgent(SingleRecordProcessor):
    """``http-request``: call an HTTP endpoint per record, write the
    response into ``output-field``."""

    async def process_record(self, record: Record) -> list[Record]:
        cfg = self.configuration
        mutable = MutableRecord.from_record(record)
        url = render_template(cfg.get("url", ""), mutable)
        method = cfg.get("method", "GET").upper()
        headers = {
            k: render_template(str(v), mutable)
            for k, v in (cfg.get("headers") or {}).items()
        }
        params = {
            k: render_template(str(v), mutable)
            for k, v in (cfg.get("query-string") or {}).items()
        }
        body = cfg.get("body")
        if body is not None:
            body = render_template(str(body), mutable)
        allow_redirects = bool(cfg.get("allow-redirects", True))
        async with await wire.open_response(
            method,
            url,
            headers=headers,
            params=params,
            data=body,
            allow_redirects=allow_redirects,
        ) as resp:
            text = await resp.text()
            if resp.status >= 400:
                raise RuntimeError(f"http-request failed: {resp.status} {text[:200]}")
            content_type = resp.headers.get("content-type", "")
            payload: Any = text
            if "application/json" in content_type:
                try:
                    payload = json.loads(text)
                except json.JSONDecodeError:
                    pass
        mutable.set_field(cfg.get("output-field", "value.response"), payload)
        return [mutable.to_record()]


class LangServeInvokeAgent(SingleRecordProcessor):
    """``langserve-invoke``: POST to a LangServe ``/invoke`` or ``/stream``
    endpoint; streaming chunks go to ``stream-to-topic`` like completions."""

    async def setup(self, context) -> None:
        await super().setup(context)
        self._stream_producer = None
        topic = self.configuration.get("stream-to-topic")
        if topic:
            self._stream_producer = context.get_topic_producer(topic)

    async def process_record(self, record: Record) -> list[Record]:
        cfg = self.configuration
        mutable = MutableRecord.from_record(record)
        url = render_template(cfg.get("url", ""), mutable)
        fields = {}
        for f in cfg.get("fields", []):
            fields[f["name"]] = evaluate(str(f["expression"]), mutable)
        payload = {"input": fields}
        output_field = cfg.get("output-field", "value.answer")
        if url.endswith("/stream") and self._stream_producer is not None:
            from langstream_tpu_torch.agents.ai import _StreamWriter
            from langstream_tpu_torch.agents.services import Chunk

            writer = _StreamWriter(
                self._stream_producer,
                record,
                cfg.get("stream-response-field", "value"),
                int(cfg.get("min-chunks-per-message", 20)),
            )
            full: list[str] = []
            async with await wire.open_response("POST", url, json_body=payload) as resp:
                i = 0
                async for line in resp:
                    decoded = line.decode().strip()
                    if not decoded.startswith("data:"):
                        continue
                    data = decoded[5:].strip()
                    if data in ("", "[DONE]"):
                        continue
                    try:
                        chunk_text = json.loads(data)
                    except json.JSONDecodeError:
                        chunk_text = data
                    if isinstance(chunk_text, dict):
                        chunk_text = chunk_text.get("output", "") or ""
                    full.append(str(chunk_text))
                    await writer.on_chunk(Chunk(str(chunk_text), i))
                    i += 1
                await writer.on_chunk(Chunk("", i, last=True))
            mutable.set_field(output_field, "".join(full))
        else:
            async with await wire.open_response("POST", url, json_body=payload) as resp:
                data = await resp.json()
            mutable.set_field(output_field, data.get("output", data))
        return [mutable.to_record()]

"""Text-processing agents.

Parity: ``langstream-agents-text-processing``
(``agents/text/*.java``): ``text-extractor`` (Tika in the reference; here
html/markdown/plain extraction with stdlib parsers — binary formats gate on
optional libs), ``text-splitter`` (LangChain-compatible
``RecursiveCharacterTextSplitter.java``), ``text-normaliser``,
``language-detector``, ``document-to-json``.

The port's copy of ``langstream_tpu/agents/text.py``; it imports only the
port (``pypdf`` only when a PDF arrives and it is installed).
"""

from __future__ import annotations

import json
import re
import unicodedata
from html.parser import HTMLParser
from typing import Any

from langstream_tpu_torch.api.agent import SingleRecordProcessor
from langstream_tpu_torch.api.record import Record, SimpleRecord


def _text_of(record: Record) -> str:
    v = record.value
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    if isinstance(v, (dict, list)):
        return json.dumps(v)
    return "" if v is None else str(v)


class DocumentToJsonAgent(SingleRecordProcessor):
    """``document-to-json``: wrap a raw text value into a JSON object."""

    async def process_record(self, record: Record) -> list[Record]:
        field = self.configuration.get("text-field", "text")
        value = {field: _text_of(record)}
        return [record.with_value(value)]


class _HTMLTextExtractor(HTMLParser):
    _SKIP = {"script", "style", "noscript", "template", "head"}

    def __init__(self) -> None:
        super().__init__()
        self.parts: list[str] = []
        self._skip_depth = 0

    def handle_starttag(self, tag: str, attrs) -> None:
        if tag in self._SKIP:
            self._skip_depth += 1

    def handle_endtag(self, tag: str) -> None:
        if tag in self._SKIP and self._skip_depth:
            self._skip_depth -= 1

    def handle_data(self, data: str) -> None:
        if not self._skip_depth and data.strip():
            self.parts.append(data.strip())


class TextExtractorAgent(SingleRecordProcessor):
    """``text-extractor``: document bytes → plain text.

    The reference embeds Apache Tika; here HTML/plain/JSON extraction is
    first-party and binary formats (pdf, docx) plug in behind optional
    libraries when present.
    """

    async def process_record(self, record: Record) -> list[Record]:
        raw = record.value
        if isinstance(raw, bytes):
            text = self._extract_bytes(raw)
        else:
            text = _text_of(record)
            if "<html" in text.lower() or "<body" in text.lower():
                text = self._extract_html(text)
        return [record.with_value(text)]

    def _extract_bytes(self, raw: bytes) -> str:
        if raw[:4] == b"%PDF":
            try:
                from pypdf import PdfReader  # optional, better coverage
                import io

                reader = PdfReader(io.BytesIO(raw))
                return "\n".join(page.extract_text() or "" for page in reader.pages)
            except ImportError:
                # in-tree fallback: content-stream scanning (agents/
                # pdftext.py documents its honest coverage — the common
                # digitally-produced case works, scanned/CID-font PDFs
                # need pypdf)
                from langstream_tpu_torch.agents.pdftext import extract_pdf_text

                return extract_pdf_text(raw)
        from langstream_tpu_torch.agents.pdftext import (
            extract_ooxml_text,
            sniff_ooxml_kind,
        )

        kind = sniff_ooxml_kind(raw)
        if kind is not None:
            return extract_ooxml_text(raw, kind)
        text = raw.decode("utf-8", errors="replace")
        if "<html" in text.lower():
            return self._extract_html(text)
        return text

    def _extract_html(self, html: str) -> str:
        parser = _HTMLTextExtractor()
        parser.feed(html)
        return "\n".join(parser.parts)


class TextNormaliserAgent(SingleRecordProcessor):
    """``text-normaliser``: lowercase / trim / unicode-normalise."""

    async def process_record(self, record: Record) -> list[Record]:
        text = _text_of(record)
        if self.configuration.get("make-lowercase", True):
            text = text.lower()
        if self.configuration.get("trim-spaces", True):
            text = re.sub(r"[ \t]+", " ", text)
            text = "\n".join(line.strip() for line in text.splitlines())
            text = text.strip()
        if self.configuration.get("unicode-normalisation"):
            text = unicodedata.normalize(
                self.configuration["unicode-normalisation"], text
            )
        return [record.with_value(text)]


# Tiny trigram-free language detector: wordlist scoring over frequent words.
_LANG_MARKERS = {
    "en": {"the", "and", "of", "to", "in", "is", "that", "it", "for", "was"},
    "fr": {"le", "la", "les", "et", "de", "un", "une", "est", "que", "pour"},
    "de": {"der", "die", "das", "und", "ist", "nicht", "ein", "eine", "zu", "mit"},
    "es": {"el", "la", "los", "las", "y", "de", "que", "es", "un", "una"},
    "it": {"il", "la", "di", "che", "e", "un", "una", "per", "sono", "non"},
}


class LanguageDetectorAgent(SingleRecordProcessor):
    """``language-detector``: annotate records with detected language."""

    async def process_record(self, record: Record) -> list[Record]:
        text = _text_of(record).lower()
        words = set(re.findall(r"[a-zà-ÿ]+", text))
        best, score = "unknown", 0
        for lang, markers in _LANG_MARKERS.items():
            s = len(words & markers)
            if s > score:
                best, score = lang, s
        prop = self.configuration.get("property", "language")
        allowed = self.configuration.get("allowedLanguages")
        if allowed and best not in allowed:
            return []  # reference drops disallowed languages
        return [record.with_headers({prop: best})]


class RecursiveCharacterTextSplitter:
    """LangChain-compatible recursive splitter (parity:
    ``agents/text/RecursiveCharacterTextSplitter.java``)."""

    def __init__(
        self,
        separators: list[str] | None = None,
        chunk_size: int = 200,
        chunk_overlap: int = 20,
        keep_separator: bool = False,
        length_function=len,
    ):
        self.separators = separators or ["\n\n", "\n", " ", ""]
        self.chunk_size = chunk_size
        self.chunk_overlap = min(chunk_overlap, chunk_size // 2)
        self.keep_separator = keep_separator
        self.length = length_function

    def split_text(self, text: str) -> list[str]:
        return self._split(text, self.separators)

    def _split(self, text: str, separators: list[str]) -> list[str]:
        sep = separators[-1]
        next_seps: list[str] = []
        for i, s in enumerate(separators):
            if s == "" or s in text:
                sep = s
                next_seps = separators[i + 1 :]
                break
        splits = [c for c in (text.split(sep) if sep else list(text)) if c]

        chunks: list[str] = []
        good: list[str] = []
        for piece in splits:
            if self.length(piece) < self.chunk_size:
                good.append(piece)
            else:
                if good:
                    chunks.extend(self._merge(good, sep))
                    good = []
                if next_seps:
                    chunks.extend(self._split(piece, next_seps))
                else:
                    chunks.append(piece)
        if good:
            chunks.extend(self._merge(good, sep))
        return chunks

    def _merge(self, splits: list[str], sep: str) -> list[str]:
        docs: list[str] = []
        current: list[str] = []
        total = 0
        for piece in splits:
            plen = self.length(piece) + (len(sep) if current else 0)
            if total + plen > self.chunk_size and current:
                docs.append(sep.join(current))
                # pop from the front until within overlap
                while current and total > self.chunk_overlap:
                    total -= self.length(current[0]) + len(sep)
                    current.pop(0)
            current.append(piece)
            total += plen
        if current:
            docs.append(sep.join(current))
        return [d.strip() for d in docs if d.strip()]


class TextSplitterAgent(SingleRecordProcessor):
    """``text-splitter``: one document record → N chunk records with
    ``chunk_id`` / ``chunk_num_tokens`` properties (as downstream vector
    pipelines expect)."""

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        length_function = len
        if configuration.get("length-function") == "cl100k_base":
            # tiktoken-free approximation: ~4 chars per token
            length_function = lambda s: max(1, len(s) // 4)  # noqa: E731
        self.splitter = RecursiveCharacterTextSplitter(
            separators=configuration.get("separators"),
            chunk_size=int(configuration.get("chunk-size", 200)),
            chunk_overlap=int(configuration.get("chunk-overlap", 20)),
            length_function=length_function,
        )

    async def process_record(self, record: Record) -> list[Record]:
        text = _text_of(record)
        chunks = self.splitter.split_text(text)
        out: list[Record] = []
        for i, chunk in enumerate(chunks):
            out.append(
                SimpleRecord(
                    value=chunk,
                    key=record.key,
                    headers=record.headers
                    + (
                        ("chunk_id", str(i)),
                        ("chunk_count", str(len(chunks))),
                        ("chunk_num_tokens", str(self.splitter.length(chunk))),
                        ("text_num_chunks", str(len(chunks))),
                    ),
                    origin=record.origin,
                    timestamp=record.timestamp,
                )
            )
        return out

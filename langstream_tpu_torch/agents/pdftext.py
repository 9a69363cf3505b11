"""Minimal in-tree binary document text extraction (stdlib only).

The reference's ``text-extractor`` embeds Apache Tika and handles pdf/docx/
pptx unconditionally (``langstream-agents-text-processing``); this image
has no Tika and no pdf libraries, so the common machine-generated formats
are handled first-party:

- **PDF**: content streams (raw or FlateDecode) are scanned for the text
  show operators (``Tj``, ``TJ``, ``'``, ``"``) inside BT/ET blocks;
  literal strings (with escapes/octal) and hex strings are decoded with
  the PDFDoc≈latin-1 approximation. This covers the bulk of digitally
  produced PDFs (reports, invoices, exported docs) — the RAG-ingestion
  case. PDFs that keep their text in cross-reference object streams or
  CID-keyed composite fonts (scanned/complex typography) extract poorly;
  installing ``pypdf`` upgrades the lane transparently (tried first).
- **DOCX / PPTX / XLSX**: OOXML zip containers — the document XML parts
  are parsed with ElementTree and text runs joined.

The port's copy of ``langstream_tpu/agents/pdftext.py``.
"""

from __future__ import annotations

import io
import re
import zipfile
import zlib
from xml.etree import ElementTree

_STREAM = re.compile(rb"stream\r?\n(.*?)endstream", re.DOTALL)
# text-showing operators inside a content stream:
#   (string) Tj     [(s1) kern (s2)] TJ     (s) '     aw ac (s) "
_SHOW = re.compile(
    rb"""
    (?: \[ (?P<array>(?:[^\[\]\\]|\\.)*?) \] \s* TJ )
  | (?: (?P<lit>\((?:[^()\\]|\\.)*\)) \s* (?:Tj|'|") )
  | (?: (?P<hex><[0-9A-Fa-f\s]*>) \s* (?:Tj|'|") )
    """,
    re.VERBOSE | re.DOTALL,
)
_ARRAY_ITEM = re.compile(
    rb"(\((?:[^()\\]|\\.)*\))|(<[0-9A-Fa-f\s]*>)", re.DOTALL
)
_ESCAPE = re.compile(rb"\\(\d{1,3}|.)", re.DOTALL)
_ESCAPES = {
    b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b"\b", b"f": b"\f",
    b"(": b"(", b")": b")", b"\\": b"\\", b"\n": b"", b"\r": b"",
}
# line-break operators: next-line moves and shows
_NEWLINE_OPS = re.compile(rb"(?:T\*|\bTd\b|\bTD\b|\bET\b|')")


def _decode_literal(raw: bytes) -> bytes:
    """PDF literal string body (without the surrounding parens)."""

    def sub(m: re.Match) -> bytes:
        esc = m.group(1)
        if esc[:1].isdigit():
            return bytes([int(esc, 8) & 0xFF])
        return _ESCAPES.get(esc[:1], esc[:1])

    return _ESCAPE.sub(sub, raw)


def _decode_hex(raw: bytes) -> bytes:
    digits = re.sub(rb"[^0-9A-Fa-f]", b"", raw)
    if len(digits) % 2:
        digits += b"0"
    return bytes.fromhex(digits.decode("ascii"))


def _string_bytes(lit: bytes | None, hexs: bytes | None) -> bytes:
    if lit is not None:
        return _decode_literal(lit[1:-1])
    if hexs is not None:
        return _decode_hex(hexs[1:-1])
    return b""


def _extract_content_text(content: bytes) -> list[str]:
    out: list[str] = []
    pos = 0
    # interleave show-operators with newline operators so lines break
    # roughly where the page breaks them
    events: list[tuple[int, str, bytes]] = []
    for m in _SHOW.finditer(content):
        if m.group("array") is not None:
            parts = []
            for lm in _ARRAY_ITEM.finditer(m.group("array")):
                parts.append(_string_bytes(lm.group(1), lm.group(2)))
            events.append((m.start(), "text", b"".join(parts)))
        else:
            events.append(
                (m.start(), "text", _string_bytes(m.group("lit"), m.group("hex")))
            )
    for m in _NEWLINE_OPS.finditer(content):
        events.append((m.start(), "nl", b""))
    events.sort(key=lambda e: e[0])
    line: list[str] = []
    for _, kind, data in events:
        if kind == "text":
            decoded = data.decode("latin-1", errors="replace")
            if decoded:
                line.append(decoded)
        elif line:
            out.append("".join(line))
            line = []
    if line:
        out.append("".join(line))
    del pos
    return out


def extract_pdf_text(raw: bytes) -> str:
    """Best-effort text of a PDF's content streams (see module docstring
    for the honest coverage statement)."""
    lines: list[str] = []
    for m in _STREAM.finditer(raw):
        data = m.group(1)
        for candidate in (data,):
            try:
                content = zlib.decompress(candidate)
            except zlib.error:
                content = candidate
            if b"BT" in content or b"Tj" in content or b"TJ" in content:
                lines.extend(_extract_content_text(content))
    return "\n".join(s for s in (ln.strip() for ln in lines) if s)


_OOXML_PARTS = {
    "docx": (re.compile(r"^word/document\.xml$"),
             "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"),
    "pptx": (re.compile(r"^ppt/slides/slide\d+\.xml$"),
             "{http://schemas.openxmlformats.org/drawingml/2006/main}"),
    "xlsx": (re.compile(r"^xl/sharedStrings\.xml$"),
             "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"),
}


def sniff_ooxml_kind(raw: bytes) -> str | None:
    """docx/pptx/xlsx detection by container contents (all are PK zips)."""
    if raw[:2] != b"PK":
        return None
    try:
        with zipfile.ZipFile(io.BytesIO(raw)) as zf:
            names = set(zf.namelist())
    except zipfile.BadZipFile:
        return None
    if "word/document.xml" in names:
        return "docx"
    if any(n.startswith("ppt/slides/") for n in names):
        return "pptx"
    if "xl/sharedStrings.xml" in names or "xl/workbook.xml" in names:
        return "xlsx"
    return None


def extract_ooxml_text(raw: bytes, kind: str) -> str:
    """Text runs of an OOXML document: ``<w:t>`` (docx), ``<a:t>`` (pptx),
    shared strings ``<t>`` (xlsx); paragraphs become lines."""
    pattern, ns = _OOXML_PARTS[kind]
    para_tag = {"docx": f"{ns}p", "pptx": f"{ns}p", "xlsx": f"{ns}si"}[kind]
    text_tag = f"{ns}t"
    lines: list[str] = []
    with zipfile.ZipFile(io.BytesIO(raw)) as zf:
        for name in sorted(zf.namelist()):
            if not pattern.match(name):
                continue
            root = ElementTree.fromstring(zf.read(name))
            for para in root.iter(para_tag):
                runs = [t.text or "" for t in para.iter(text_tag)]
                joined = "".join(runs).strip()
                if joined:
                    lines.append(joined)
    return "\n".join(lines)

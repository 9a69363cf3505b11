"""The port's YAML loader: the subset of YAML 1.1 that LangStream
applications are written in, read without PyYAML.

:func:`safe_load` returns what ``yaml.safe_load`` returns for:

- block mappings and block sequences (a sequence may sit at its parent
  key's indentation), compact nested collections (``- name: x``);
- flow sequences and mappings (``parameters: [sessionId]``,
  ``{a: 1, b: [x, y]}``), across lines too;
- single-quoted scalars (``''`` for a quote) and double-quoted ones with
  every YAML escape (``\\n``, ``\\x41``, ``\\u00e9``, ``\\U0001F600``, an
  escaped line break, ...), folded across lines;
- literal (``|``) and folded (``>``) block scalars with their chomping
  (``-``, ``+``) and indentation indicators;
- plain scalars over several lines, typed as YAML 1.1 types them: ``yes``,
  ``no``, ``on``, ``off``, ``true`` and ``false`` in their three cases are
  booleans, ``~``, ``null`` and an empty value are null, ints in decimal,
  octal (``0755``), hex, binary and base 60, floats with ``.inf`` and
  ``.nan``, and dates and timestamps;
- comments, one leading ``---`` and one closing ``...``;
- explicit ``? key`` entries whose key is a scalar (how PyYAML writes an
  empty, multi-line or long key).

Anything else -- anchors and aliases, tags, directives, collections as
keys, a second document -- raises :class:`YamlSubsetError`,
whose message starts with ``<source>:<line>:``. The loader is used even
where PyYAML is installed, so what runs anywhere is what the tests hold to
``yaml.safe_load``.
"""

from __future__ import annotations

import bisect
import datetime
import re
from typing import Any

__all__ = ["YamlSubsetError", "safe_load"]


class YamlSubsetError(ValueError):
    """A construct outside the subset, or malformed YAML, at a line."""

    def __init__(self, source: str, line: int, message: str):
        super().__init__(f"{source}:{line}: {message}")
        self.source = source
        self.line = line


# ---------------------------------------------------------------------------
# plain-scalar typing (the YAML 1.1 implicit resolvers)
# ---------------------------------------------------------------------------

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_TIMESTAMP_PARTS = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])
                -(?P<month>[0-9][0-9]?)
                -(?P<day>[0-9][0-9]?)
                (?:(?:[Tt]|[ \t]+)
                (?P<hour>[0-9][0-9]?)
                :(?P<minute>[0-9][0-9])
                :(?P<second>[0-9][0-9])
                (?:\.(?P<fraction>[0-9]*))?
                (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
                (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)


def _sexagesimal(text: str, kind) -> Any:
    value = kind(0)
    for part in text.split(":"):
        value = value * 60 + kind(part)
    return value


def _int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * float("inf")
    if text == ".nan":
        return float("nan")
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def _timestamp(text: str) -> Any:
    parts = _TIMESTAMP_PARTS.match(text).groupdict()
    year, month, day = int(parts["year"]), int(parts["month"]), int(parts["day"])
    if not parts["hour"]:
        return datetime.date(year, month, day)
    fraction = 0
    if parts["fraction"]:
        fraction = int(parts["fraction"][:6].ljust(6, "0"))
    tzinfo = None
    if parts["tz_sign"]:
        delta = datetime.timedelta(hours=int(parts["tz_hour"]),
                                   minutes=int(parts["tz_minute"] or 0))
        tzinfo = datetime.timezone(-delta if parts["tz_sign"] == "-" else delta)
    elif parts["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(parts["hour"]), int(parts["minute"]),
                             int(parts["second"]), fraction, tzinfo=tzinfo)


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

_WS_END = " \t\n\0"
_FLOW_INDICATORS = ",[]{}"
_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
    "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
    "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029",
}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_HEX = set("0123456789abcdefABCDEF")


class _Parser:
    def __init__(self, text: str, source: str):
        # every YAML 1.1 line break that reads as "\n" (NEL too)
        text = text.replace("\r\n", "\n").replace("\r", "\n").replace("\x85", "\n")
        if text.startswith("\ufeff"):
            text = text[1:]
        self.source = source
        if "\0" in text:
            self.i = text.index("\0")
            self._starts = [0] + [m.end() for m in re.finditer("\n", text)]
            self.error("a NUL character is not allowed")
        self.s = text + "\0"
        self.i = 0
        self._starts = [0] + [m.end() for m in re.finditer("\n", text)]

    # ---- position --------------------------------------------------------

    def line(self, i: int | None = None) -> int:
        return bisect.bisect_right(self._starts, self.i if i is None else i)

    def col(self) -> int:
        return self.i - self._starts[self.line() - 1]

    def error(self, message: str, at: int | None = None):
        raise YamlSubsetError(self.source, self.line(at), message)

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else "\0"

    def eof(self) -> bool:
        return self.peek() == "\0"

    # ---- whitespace and comments ----------------------------------------

    def skip_inline(self) -> None:
        while self.peek() in " \t":
            self.i += 1

    def skip_comment(self) -> None:
        if self.peek() == "#":
            while self.peek() not in "\n\0":
                self.i += 1

    def at_line_end(self) -> bool:
        """After inline spaces: a line break, the end, or a comment."""
        self.skip_inline()
        return self.peek() in "\n\0#"

    def skip_to_content(self) -> None:
        """Skip blank lines, comments and indentation up to the next
        content character (or the end)."""
        while True:
            while self.peek() == " ":
                self.i += 1
            ch = self.peek()
            if ch == "\t":
                if self.col() == 0 or self.s[self._starts[self.line() - 1]:self.i].strip(" ") == "":
                    # a tab inside the indentation
                    rest = self.s[self.i:self.s.find("\n", self.i)].strip(" \t")
                    if rest and not rest.startswith("#"):
                        self.error("a tab character is not allowed in indentation")
                self.i += 1
                continue
            if ch == "#":
                self.skip_comment()
                continue
            if ch == "\n":
                self.i += 1
                continue
            return

    def doc_marker(self, marker: str) -> bool:
        return (self.col() == 0 and self.s.startswith(marker, self.i)
                and self.peek(3) in _WS_END)

    # ---- document ---------------------------------------------------------

    def parse(self) -> Any:
        self.skip_to_content()
        if self.peek() == "%" and self.col() == 0:
            self.error("directives are not supported")
        if self.doc_marker("---"):
            self.i += 3
            if self.at_line_end():
                value = self.block_node(-1)
            else:
                value = self.node_here(-1, block=False)
        elif self.doc_marker("..."):
            value = None
        else:
            value = self.block_node(-1)
        self.skip_to_content()
        if self.doc_marker("..."):
            self.i += 3
            self.skip_to_content()
            if not self.eof():
                self.error("several documents in one file are not supported")
        if self.doc_marker("---"):
            self.error("several documents in one file are not supported")
        if not self.eof():
            self.error(f"unexpected content {self.peek()!r}")
        return value

    # ---- block structure -------------------------------------------------

    def is_entry(self) -> bool:
        return self.peek() == "-" and self.peek(1) in _WS_END

    def block_node(self, parent: int, seq_at_parent: bool = False) -> Any:
        """The node on the following lines, indented deeper than ``parent``
        (a sequence may also sit at ``parent`` when ``seq_at_parent``);
        None when the next content is not."""
        self.skip_to_content()
        if self.eof() or self.doc_marker("---") or self.doc_marker("..."):
            return None
        c = self.col()
        if c > parent:
            return self.node_here(parent)
        if seq_at_parent and c == parent and self.is_entry():
            return self.block_sequence(c)
        return None

    def node_here(self, parent: int, block: bool = True) -> Any:
        """The node starting at the current character, inside a block
        collection indented at ``parent``. ``block=False`` (a mapping's
        value on its key's line) refuses a nested block collection."""
        ch = self.peek()
        start = self.i
        if ch == "-" and self.peek(1) in _WS_END:
            if not block:
                self.error("a block sequence is not allowed here")
            return self.block_sequence(self.col())
        if ch in "&*":
            self.error("anchors and aliases are not supported")
        if ch == "!":
            self.error("tags are not supported")
        if ch == "?" and self.peek(1) in _WS_END:
            if not block:
                self.error("a mapping is not allowed here")
            return self.block_mapping(self.col())
        if ch in "%@`":
            self.error(f"a plain scalar cannot start with {ch!r}")
        if ch in "|>":
            return self.block_scalar(parent)
        if ch in "[{":
            value = self.flow_collection()
            self.skip_inline()
            if self.peek() == ":" and self.peek(1) in _WS_END:
                self.error("a flow collection as a mapping key is not supported")
            if not self.at_line_end():
                self.error(f"unexpected content {self.peek()!r} after a flow collection")
            return value
        if self.simple_key_ahead():
            if not block:
                self.error("a mapping is not allowed here")
            return self.block_mapping(self.col())
        self.i = start
        if ch in "'\"":
            value = self.quoted()
            if not self.at_line_end():
                self.error(f"unexpected content {self.peek()!r} after a quoted scalar")
            return value
        return self.plain(parent, flow=False)

    def simple_key_ahead(self) -> bool:
        """True (position restored) when a simple key followed by ``:`` and
        a space or line end starts at the current character."""
        start = self.i
        line = self.line()
        try:
            if self.peek() in "'\"":
                self.quoted()
            else:
                text = self.plain_line(flow=False)
                if not text:
                    return False
            if self.line() != line:
                return False
            self.skip_inline()
            return self.peek() == ":" and self.peek(1) in _WS_END
        except YamlSubsetError:
            return False
        finally:
            self.i = start

    def key(self) -> Any:
        if self.peek() in "'\"":
            return self.quoted()
        return _resolve(self.plain_line(flow=False))

    def block_mapping(self, indent: int) -> dict:
        result: dict = {}
        while True:
            at = self.i
            if self.peek() == "?" and self.peek(1) in _WS_END:
                key, value = self.explicit_entry(indent)
            else:
                if self.peek() in "&*![{":
                    self.node_here(indent)  # raises with the construct's name
                if not self.simple_key_ahead():
                    self.error("expected a mapping key followed by ':'")
                key = self.key()
                self.skip_inline()
                self.i += 1  # the ':'
                value = self.entry_value(indent)
            try:
                result[key] = value
            except TypeError:
                self.error("a mapping key must be a scalar", at)
            self.skip_to_content()
            if self.eof() or self.doc_marker("---") or self.doc_marker("..."):
                return result
            c = self.col()
            if c < indent:
                return result
            if c > indent:
                self.error("bad indentation of a mapping entry")
            if self.is_entry():
                self.error("a sequence entry is not allowed inside this mapping")

    def entry_value(self, indent: int) -> Any:
        """The value after a mapping entry's ``:``."""
        if self.at_line_end():
            return self.block_node(indent, seq_at_parent=True)
        return self.node_here(indent, block=False)

    def explicit_entry(self, indent: int) -> tuple[Any, Any]:
        """``? key`` then, at the same indentation, ``: value``."""
        self.i += 1  # the '?'
        if self.at_line_end():
            key = self.block_node(indent)
        else:
            key = self.node_here(indent)
        if isinstance(key, (list, dict)):
            self.error("a collection as a mapping key is not supported")
        self.skip_to_content()
        if self.col() == indent and self.peek() == ":" and self.peek(1) in _WS_END:
            self.i += 1
            if self.at_line_end():
                return key, self.block_node(indent, seq_at_parent=True)
            return key, self.node_here(indent)
        return key, None

    def block_sequence(self, indent: int) -> list:
        result: list = []
        while True:
            self.i += 1  # the '-'
            if self.at_line_end():
                result.append(self.block_node(indent))
            else:
                result.append(self.node_here(indent))
            self.skip_to_content()
            if self.eof() or self.doc_marker("---") or self.doc_marker("..."):
                return result
            c = self.col()
            if c == indent and self.is_entry():
                continue
            if c <= indent:
                return result
            self.error("bad indentation of a sequence entry")

    # ---- scalars -----------------------------------------------------------

    def plain_line(self, flow: bool) -> str:
        """One line's worth of a plain scalar (a simple key's text)."""
        start = self.i
        text = self._plain_chunks(flow, min_col=None, one_line=True)
        if self.i == start:
            return ""
        return text

    def plain(self, parent: int, flow: bool) -> Any:
        return _resolve(self._plain_chunks(flow, min_col=parent + 1, one_line=False))

    def _plain_chunks(self, flow: bool, min_col: int | None, one_line: bool) -> str:
        chunks: list[str] = []
        spaces: list[str] = []
        while True:
            if self.peek() == "#":
                break
            length = 0
            while True:
                ch = self.peek(length)
                nxt = self.peek(length + 1)
                if ch in _WS_END or (
                        ch == ":" and (nxt in _WS_END or (flow and nxt in _FLOW_INDICATORS))
                ) or (flow and ch in ",?[]{}"):
                    break
                length += 1
            if length == 0:
                break
            chunks.extend(spaces)
            chunks.append(self.s[self.i:self.i + length])
            self.i += length
            end = self.i
            spaces = self._plain_spaces(one_line)
            if not spaces or self.peek() == "#" or (
                    not flow and min_col is not None and self.col() < min_col):
                if one_line:
                    self.i = end
                break
        return "".join(chunks)

    def _plain_spaces(self, one_line: bool) -> list[str]:
        start = self.i
        while self.peek() == " ":
            self.i += 1
        whitespace = self.s[start:self.i]
        if self.peek() == "\n":
            if one_line:
                return []
            self.i += 1
            if self.doc_marker("---") or self.doc_marker("..."):
                return []
            breaks: list[str] = []
            while self.peek() in " \n":
                if self.peek() == " ":
                    self.i += 1
                else:
                    breaks.append("\n")
                    self.i += 1
                    if self.doc_marker("---") or self.doc_marker("..."):
                        return []
            return breaks or [" "]
        return [whitespace] if whitespace else []

    def quoted(self) -> str:
        quote = self.peek()
        double = quote == '"'
        start = self.i
        self.i += 1
        chunks = self._quoted_non_spaces(double, start)
        while self.peek() != quote:
            chunks.extend(self._quoted_spaces(double, start))
            chunks.extend(self._quoted_non_spaces(double, start))
        self.i += 1
        return "".join(chunks)

    def _quoted_non_spaces(self, double: bool, start: int) -> list[str]:
        chunks: list[str] = []
        while True:
            length = 0
            while self.peek(length) not in "'\"\\\0 \t\n":
                length += 1
            if length:
                chunks.append(self.s[self.i:self.i + length])
                self.i += length
            ch = self.peek()
            if not double and ch == "'" and self.peek(1) == "'":
                chunks.append("'")
                self.i += 2
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                self.i += 1
            elif double and ch == "\\":
                self.i += 1
                ch = self.peek()
                if ch in _ESCAPES and ch != "\0":
                    chunks.append(_ESCAPES[ch])
                    self.i += 1
                elif ch in _ESCAPE_CODES:
                    n = _ESCAPE_CODES[ch]
                    self.i += 1
                    digits = self.s[self.i:self.i + n]
                    if len(digits) != n or not set(digits) <= _HEX:
                        self.error(f"expected an escape of {n} hexadecimal digits")
                    chunks.append(chr(int(digits, 16)))
                    self.i += n
                elif ch == "\n":
                    self.i += 1
                    chunks.extend(self._quoted_breaks(start))
                else:
                    self.error(f"unknown escape character {ch!r} in a double-quoted scalar")
            else:
                return chunks

    def _quoted_spaces(self, double: bool, start: int) -> list[str]:
        begin = self.i
        while self.peek() in " \t":
            self.i += 1
        whitespace = self.s[begin:self.i]
        ch = self.peek()
        if ch == "\0":
            self.error("unterminated quoted scalar", start)
        if ch == "\n":
            self.i += 1
            breaks = self._quoted_breaks(start)
            return breaks if breaks else [" "]
        return [whitespace]

    def _quoted_breaks(self, start: int) -> list[str]:
        chunks: list[str] = []
        while True:
            if self.doc_marker("---") or self.doc_marker("..."):
                self.error("a document marker inside a quoted scalar", start)
            while self.peek() in " \t":
                self.i += 1
            if self.peek() == "\n":
                chunks.append("\n")
                self.i += 1
            else:
                return chunks

    def block_scalar(self, parent: int) -> str:
        folded = self.peek() == ">"
        self.i += 1
        chomping = None
        increment = None
        for _ in range(2):
            ch = self.peek()
            if ch in "+-" and chomping is None:
                chomping = ch == "+"
                self.i += 1
            elif ch in "0123456789" and increment is None:
                increment = int(ch)
                if increment == 0:
                    self.error("a block scalar's indentation indicator must be 1-9")
                self.i += 1
        if self.peek() not in " \n\0":
            self.error(f"unexpected {self.peek()!r} in a block scalar header")
        self.skip_inline()
        self.skip_comment()
        if self.peek() not in "\n\0":
            self.error("expected a comment or a line break after a block scalar header")
        if self.peek() == "\n":
            self.i += 1
        min_indent = max(parent + 1, 1)
        if increment is None:
            breaks: list[str] = []
            max_indent = 0
            while self.peek() in " \n":
                if self.peek() == "\n":
                    breaks.append("\n")
                    self.i += 1
                else:
                    self.i += 1
                    max_indent = max(max_indent, self.col())
            indent = max(min_indent, max_indent)
        else:
            indent = min_indent + increment - 1
            breaks = self._block_breaks(indent)
        chunks: list[str] = []
        line_break = ""
        while self.col() == indent and not self.eof():
            chunks.extend(breaks)
            leading_non_space = self.peek() not in " \t"
            end = self.s.find("\n", self.i)
            end = len(self.s) - 1 if end < 0 else end
            chunks.append(self.s[self.i:end])
            self.i = end
            if self.peek() == "\n":
                line_break = "\n"
                self.i += 1
            else:
                line_break = ""
            breaks = self._block_breaks(indent)
            if self.col() == indent and not self.eof():
                if folded and line_break == "\n" and leading_non_space \
                        and self.peek() not in " \t":
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomping is not False:
            chunks.append(line_break)
        if chomping is True:
            chunks.extend(breaks)
        return "".join(chunks)

    def _block_breaks(self, indent: int) -> list[str]:
        chunks: list[str] = []
        while self.col() < indent and self.peek() == " ":
            self.i += 1
        while self.peek() == "\n":
            chunks.append("\n")
            self.i += 1
            while self.col() < indent and self.peek() == " ":
                self.i += 1
        return chunks

    # ---- flow collections ----------------------------------------------------

    def skip_flow_space(self) -> None:
        while True:
            ch = self.peek()
            if ch in " \t\n":
                self.i += 1
            elif ch == "#":
                self.skip_comment()
            else:
                return

    def flow_collection(self) -> Any:
        opening = self.peek()
        start = self.i
        closing = "]" if opening == "[" else "}"
        self.i += 1
        items: list = []
        mapping: dict = {}
        while True:
            self.skip_flow_space()
            if self.peek() == closing:
                self.i += 1
                return items if opening == "[" else mapping
            if self.eof():
                self.error(f"unterminated flow collection (no {closing!r})", start)
            at = self.i
            if self.peek() == "?" and self.peek(1) in _WS_END:
                self.i += 1
                self.skip_flow_space()
                if self.peek() in ":,]}":
                    node = None
                else:
                    node = self.flow_node()
            else:
                node = self.flow_node()
            self.skip_flow_space()
            if self.peek() == ":":
                if opening == "[":
                    self.error("a mapping inside a flow sequence is not supported")
                self.i += 1
                self.skip_flow_space()
                value = None if self.peek() in ",}" else self.flow_node()
                self.skip_flow_space()
            else:
                value = None
            if opening == "[":
                items.append(node)
            else:
                try:
                    mapping[node] = value
                except TypeError:
                    self.error("a mapping key must be a scalar", at)
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != closing:
                self.error(f"expected ',' or {closing!r} in a flow collection")

    def flow_node(self) -> Any:
        ch = self.peek()
        if ch in "[{":
            return self.flow_collection()
        if ch in "'\"":
            return self.quoted()
        if ch in "&*":
            self.error("anchors and aliases are not supported")
        if ch == "!":
            self.error("tags are not supported")
        if ch in "|>%@`" or ch in _FLOW_INDICATORS:
            self.error(f"unexpected {ch!r} in a flow collection")
        return _resolve(self._plain_chunks(True, min_col=None, one_line=False))


def _resolve(text: str) -> Any:
    """A plain scalar's value, typed by the YAML 1.1 implicit resolvers."""
    if _NULL.match(text):
        return None
    first = text[0]
    if first in "yYnNtTfFoO" and _BOOL.match(text):
        return text in _TRUE
    if first in "-+0123456789." and _FLOAT.match(text):
        return _float(text)
    if first in "-+0123456789" and _INT.match(text):
        return _int(text)
    if first in "0123456789" and _TIMESTAMP.match(text):
        return _timestamp(text)
    if text in ("<<", "="):
        raise ValueError(f"the {text!r} key/value tag is not supported")
    return text


def safe_load(text: str, source: str = "<string>") -> Any:
    """Parse one YAML document of the subset above; ``source`` names the
    text (a file name) in errors."""
    parser = _Parser(text, source)
    try:
        return parser.parse()
    except YamlSubsetError:
        raise
    except ValueError as e:
        raise YamlSubsetError(source, parser.line(), str(e)) from None
